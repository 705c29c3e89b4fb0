"""Host-side layout of the CUDA chunk kernel, on the CPU: the lane partition
of the county-sorted radon observations and the launch sizing.

The kernel's residual pass gives each lane of a warp a contiguous run of
the sorted observations, sums each segment (a county's observations within
one lane) and then adds each county's segments in order.  The emulation
below reads only the int32 tables in the order ``csrc/layout.cuh``
(PartTables) reads them, so it checks the tables as the kernel sees them:
per-county sums through the partition equal the direct sums to 1e-12
(float64; only the order of the additions differs).
"""

import numpy as np
import pytest
import torch

from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.models.radon import (
    LANES,
    SEG_START,
    lane_major,
    lane_partition,
    simulate_radon_data,
)
from nutpie_tpu_torch.sampler.megakernel import MAX_KERNEL_DIM, kernel_config, launch_grid
from nutpie_tpu_torch.sampler.nuts import NutsConfig


def _radon_counts():
    _, cidx, _, _ = simulate_radon_data(42)
    return np.bincount(cidx, minlength=85)


# county sizes: the simulated radon set (longest county 61 observations),
# empty counties between full ones, one county across many lanes, and fewer
# observations than lanes
COUNTS = {
    "radon": _radon_counts(),
    "empty_counties": np.array([0, 3, 0, 0, 40, 1, 0, 7, 0]),
    "one_long_county": np.array([2, 300, 1, 5]),
    "few_observations": np.array([1, 0, 2, 1, 0]),
}


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)])


def _split_table(part, n_counties):
    """The flat int32 table cut at PartTables' offsets."""
    tab = part.table()
    lane_obs = tab[:LANES + 1]
    lane_seg = tab[LANES + 1:2 * LANES + 1]
    county_seg = tab[2 * LANES + 1:2 * LANES + 2 + n_counties]
    info = tab[2 * LANES + 2 + n_counties:].reshape(part.rows, LANES)
    return lane_obs, lane_seg, county_seg, info


def _partition_sums(part, n_counties, values):
    """Per-county sums of ``values`` [n_obs, k], added as the kernel adds them."""
    lane_obs, lane_seg, county_seg, info = _split_table(part, n_counties)
    vals = lane_major(values, part)
    segp = np.zeros((part.n_seg,) + values.shape[1:])
    seg_county = np.full(part.n_seg, -1)
    for lane in range(LANES):
        s = lane_seg[lane] - 1
        acc = np.zeros(values.shape[1:])
        for t in range(lane_obs[lane + 1] - lane_obs[lane]):
            f = info[t, lane]
            if f >= SEG_START:
                s += 1
                acc = np.zeros(values.shape[1:])
            acc = acc + vals[t, lane]
            segp[s] = acc
            seg_county[s] = f & (SEG_START - 1)
    out = np.zeros((n_counties,) + values.shape[1:])
    for c in range(n_counties):
        for s in range(county_seg[c], county_seg[c + 1]):
            assert seg_county[s] == c
            out[c] = out[c] + segp[s]
    return out


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_lane_partition_tables(case):
    counts = COUNTS[case]
    offsets = _offsets(counts)
    n_obs, n_c = int(offsets[-1]), len(counts)
    part = lane_partition(offsets)
    lane_obs, lane_seg, county_seg, info = _split_table(part, n_c)
    runs = np.diff(lane_obs)
    assert lane_obs[0] == 0 and lane_obs[-1] == n_obs
    assert runs.max() - runs.min() <= 1 and part.rows == runs.max()
    # every lane's first observation opens a segment, and so does every
    # county's; no other observation does
    opens = np.zeros(n_obs, bool)
    opens[lane_obs[:-1][runs > 0]] = True
    opens[offsets[:-1][counts > 0]] = True
    flags = np.zeros(n_obs, bool)
    county = np.zeros(n_obs, np.int64)
    for lane in range(LANES):
        for t in range(runs[lane]):
            flags[lane_obs[lane] + t] = info[t, lane] >= SEG_START
            county[lane_obs[lane] + t] = info[t, lane] & (SEG_START - 1)
    np.testing.assert_array_equal(flags, opens)
    np.testing.assert_array_equal(county, np.repeat(np.arange(n_c), counts))
    assert part.n_seg == int(opens.sum()) == county_seg[-1]
    np.testing.assert_array_equal(np.diff(county_seg) > 0, counts > 0)
    # a lane's first segment is the one its first observation opens
    np.testing.assert_array_equal(lane_seg, np.cumsum(np.append(0, opens))[lane_obs[:-1]])


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_partition_sums_equal_direct_sums(case):
    counts = COUNTS[case]
    offsets = _offsets(counts)
    n_c = len(counts)
    rng = np.random.default_rng(3)
    values = rng.standard_normal((int(offsets[-1]), 3))
    direct = np.zeros((n_c, 3))
    np.add.at(direct, np.repeat(np.arange(n_c), counts), values)
    got = _partition_sums(lane_partition(offsets), n_c, values)
    np.testing.assert_allclose(got, direct, rtol=1e-12, atol=1e-12)


def test_radon_kernel_data_is_lane_major():
    km = radon().kernel_model
    part = km.partition
    assert km.obs_rows == part.rows == 29 and part.n_seg >= 85
    tensors = km.tensors("cpu", torch.float64)
    obs = tensors["obs"].numpy()
    assert obs.shape == (part.rows, LANES, 2)
    pairs = np.stack([km.y, km.floor], axis=-1)
    np.testing.assert_array_equal(obs, lane_major(pairs, part))
    np.testing.assert_array_equal(tensors["part"].numpy(), part.table())
    # the kernel's configuration carries the tables' sizes
    cfg = kernel_config(NutsConfig(), km, 8, 173, 10, 16, False)
    assert (cfg.n_seg, cfg.obs_rows, cfg.n_obs) == (part.n_seg, part.rows, 919)
    assert 173 <= MAX_KERNEL_DIM


@pytest.mark.parametrize("n_chains, per_block, blocks, sms, grid", [
    (2048, 16, 1, 132, 132),   # the main path: every block slot of the card
    (61, 16, 1, 132, 61),      # fewer chains than slots: one chain per block
    (4, 6, 2, 132, 4),
    (1000, 6, 2, 132, 264),
])
def test_launch_grid(n_chains, per_block, blocks, sms, grid):
    assert launch_grid(n_chains, per_block, blocks, sms) == grid


def test_launch_grid_refuses_a_kernel_that_does_not_fit():
    with pytest.raises(RuntimeError, match="does not fit"):
        launch_grid(64, 16, 0, 132)
