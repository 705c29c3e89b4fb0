"""The port's main paths in a one-rank NCCL group on the card.

These tests need a CUDA device and ``nvcc``; without them they skip.  Run
them on the card with ``python -m pytest --noconftest
tests/test_torch_distributed_cuda.py`` (``chip_smoke.py --phases
distributed`` runs the same comparisons at full width).  Each model is
sampled pooled, float32, first without a group and then inside a
one-rank NCCL group (``initialize_distributed``), where every
chunk-boundary collective goes through NCCL: radon through K1 and a small
logistic GLM through K2, each trace bitwise the run without the group.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.parallel import collectives, initialize_distributed
from nutpie_tpu_torch.sampler.megakernel import chunk_kernel
from nutpie_tpu_torch.sampler.step_kernel import step_kernel

pytestmark = pytest.mark.cuda

COMMON = dict(seed=7, pool_mass_matrix=True, pool_step_size=True, precision="float32",
              device="cuda", progress_bar=False, return_raw_trace=True)
RUNS = {
    "radon_k1": (lambda: compile_model_def(nt.models.radon()),
                 dict(chains=256, tune=64, draws=32, chunk_size=32)),
    "glm_k2": (lambda: compile_model_def(nt.models.logistic_glm(n_data=256, dim=16)),
               dict(chains=512, tune=32, draws=16, chunk_size=16)),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sample(name: str):
    make, kwargs = RUNS[name]
    step_kernel.launches = chunk_kernel.launches = 0
    raw = nt.sample(make(), **kwargs, **COMMON)
    return raw, chunk_kernel.launches, step_kernel.launches


@pytest.fixture(scope="module")
def runs():
    """Each run without a group, then in a one-rank NCCL group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not dist.is_initialized()
    alone = {name: _sample(name) for name in RUNS}
    mesh = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout=300.0)
    try:
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        collectives.reset()
        grouped = {name: _sample(name) for name in RUNS}
        calls = collectives.calls
    finally:
        dist.destroy_process_group()
    return alone, grouped, calls


def _bits(a):
    return a.view(f"u{a.itemsize}") if a.dtype.kind == "f" else a


@pytest.mark.parametrize("name", list(RUNS))
def test_one_rank_nccl_group_is_bitwise(runs, name):
    alone, grouped, calls = runs
    (want, k1_a, k2_a), (got, k1_g, k2_g) = alone[name], grouped[name]
    assert calls > 0
    if name == "radon_k1":
        assert k1_g == k1_a > 0 and k2_g == 0
    else:
        assert k2_g == k2_a > 0 and k1_g == 0
    np.testing.assert_array_equal(_bits(got["position"]), _bits(want["position"]))
    for group in ("stats", "expanded"):
        assert got[group].keys() == want[group].keys()
        for key, ref in want[group].items():
            np.testing.assert_array_equal(_bits(got[group][key]), _bits(ref), err_msg=key)
