"""``run.fleet_depth_cap`` without a host sync, against its earlier form and
the JAX function.

The port computes the fleet's tree-depth cap on the device: the chunk's
step counts sorted with NaN last and the middle two gathered at indices
from the device's count of non-NaN values.  Its earlier form dropped the
NaN rows with a boolean mask and branched on the count, both of which wait
for the device; it stays here as the reference (``_masked_cap``).  Both and
``nutpie_tpu.sampler.run.fleet_depth_cap`` must give the same cap on chunks
with odd and even counts, NaN rows, rows past ``limit``, an all-NaN chunk,
and medians below 1, above ``2**maxdepth`` and infinite (the 2**30 guard).
"""

import zlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.run import fleet_depth_cap as jfleet_depth_cap
from nutpie_tpu_torch.sampler.nuts import N_SCALAR_SLOTS, SCALAR_SLOTS, ChunkBuffers, NutsConfig
from nutpie_tpu_torch.sampler.run import _ceil_log2, _median, fleet_depth_cap

torch.set_num_threads(1)

SLOT = SCALAR_SLOTS["n_steps"]


def _masked_cap(cfg, bufs, limit: int) -> torch.Tensor:
    """The earlier form: NaN rows dropped by a mask, a host branch on the count."""
    ns = bufs.scalars[:, :limit, SLOT].reshape(-1)
    ns = ns[~torch.isnan(ns)]
    if ns.numel():
        med = _median(ns)
        med = torch.where(torch.isfinite(med), med, torch.full_like(med, 2.0 ** 30))
    else:
        med = torch.tensor(2.0 ** 30, dtype=bufs.scalars.dtype)
    return torch.clamp(
        _ceil_log2(cfg.depth_cap_factor * torch.clamp(med, min=1.0)), 4, cfg.maxdepth
    )


def _case(name: str):
    """(n_steps [C, L] with NaN where no draw was written, limit)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    steps = lambda shape: rng.integers(1, 300, size=shape).astype(np.float64)
    if name == "odd_count":
        return steps((3, 4)), 3            # 9 values
    if name == "even_count":
        return steps((4, 4)), 4            # 16 values
    if name == "nan_rows_odd":
        ns = steps((5, 6))
        ns[[0, 2, 4], 3:] = np.nan         # 21 values
        return ns, 6
    if name == "nan_rows_even":
        ns = steps((5, 6))
        ns[[1, 3], 2:] = np.nan            # 22 values
        return ns, 6
    if name == "rows_past_limit":
        ns = steps((4, 8))
        ns[:, 5:] = 10_000.0               # ignored: past limit
        return ns, 5
    if name == "all_nan":
        return np.full((3, 4), np.nan), 4
    if name == "median_below_one":
        return np.full((2, 3), 0.25), 3
    if name == "median_above_maxdepth":
        return np.full((2, 3), 1e9), 3
    if name == "median_infinite":
        ns = np.full((2, 4), np.inf)
        ns[0, 0] = 3.0
        return ns, 4
    raise KeyError(name)


@pytest.mark.parametrize("maxdepth", [6, 10])
@pytest.mark.parametrize("name", ["odd_count", "even_count", "nan_rows_odd", "nan_rows_even",
                                  "rows_past_limit", "all_nan", "median_below_one",
                                  "median_above_maxdepth", "median_infinite"])
def test_fleet_depth_cap_matches_masked_form_and_jax(name, maxdepth):
    ns, limit = _case(name)
    C, L = ns.shape
    scalars = np.full((C, L, N_SCALAR_SLOTS), np.nan)
    scalars[..., SLOT] = ns
    pos = torch.zeros((C, L, 1), dtype=torch.float64)
    bufs = ChunkBuffers(position=pos, scalars=torch.as_tensor(scalars))
    cfg = NutsConfig(maxdepth=maxdepth)
    got = fleet_depth_cap(cfg, bufs, limit)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(_masked_cap(cfg, bufs, limit))
    jbufs = SimpleNamespace(scalars=jnp.asarray(scalars))  # all the JAX function reads
    assert int(got) == int(jfleet_depth_cap(JNutsConfig(maxdepth=maxdepth), jbufs, limit))
