"""K3's refresh normals, launch plans and C mirrors, on the CPU.

K3 (``csrc/mclmc.cu``) draws each step's refresh normals in the kernel:
step j of the draw with absolute index d draws ``normal(fold_in(fold_in(
fold_in(key, 4), d), j), (dim,))``, keyed from the words of ``fold_in(key,
4)`` that the wrapper folds once a chunk (``mclmc.refresh_keys``).
``mclmc.step_normals`` mirrors that derivation in torch; here it is held
bitwise to the plain version's ``draw_normals`` (the ``split`` layout) and
both to ``jax.random.normal(split(fold_in(fold_in(key, 4), d), S)[j],
(dim,))`` from the JAX package, to the ULP bounds of
``test_torch_threefry.py`` (XLA's ``erfinv`` evaluated on another
``log1p``).

``mclmc_plan`` picks K3's form before anything runs (K2's plans: held or
strided under the diagonal metric, staged or streamed, by TMA or loads,
under the low-rank one; K3's block lays out K2's shared memory); here at
an H100's numbers, and the ctypes mirrors against the C structs.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu_torch.ops import threefry as tf
from nutpie_tpu_torch.sampler.abi import MkConfig
from nutpie_tpu_torch.sampler.mclmc import draw_normals, refresh_keys, step_normals
from nutpie_tpu_torch.sampler.mclmc_kernel import (
    GEOMETRY_FIELDS,
    McConfig,
    McPtrs,
    mc_config,
    mclmc_plan,
)
from nutpie_tpu_torch.sampler.mclmc import MclmcConfig
from nutpie_tpu_torch.sampler.step_kernel import (
    DiagPlan,
    LowRankPlan,
    lr_smem_bytes,
    plan_fields,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "nutpie_tpu_torch" / "csrc"
H100 = {"smem_per_block": 232448, "sm_count": 132, "smem_per_sm": 233472,
        "reserved_per_block": 1024}
DTYPES = [(jnp.float32, torch.float32, 4.0), (jnp.float64, torch.float64, 64.0)]
SEEDS = (3, 2**33 + 7)  # a key with a nonzero high word


def _chain_keys(seed: int, n: int):
    master = jax.random.key(seed)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(master, i))(jnp.arange(n))
    return jkeys, torch.as_tensor(np.asarray(jax.random.key_data(jkeys)).astype(np.int64))


def _ulp(ref: np.ndarray, got: np.ndarray) -> float:
    return float(np.max(np.abs(ref - got) / np.spacing(np.abs(ref).astype(ref.dtype))))


def test_refresh_keys_are_the_words_of_fold_in_4():
    _, keys = _chain_keys(SEEDS[1], 6)
    words = refresh_keys(keys)
    assert words.dtype == torch.int32 and words.shape == (6, 2)
    want = tf.fold_in_data(keys, 4)
    np.testing.assert_array_equal(words.numpy().view(np.uint32).astype(np.int64), want.numpy())


@pytest.mark.parametrize("jdt,tdt,max_ulp", DTYPES)
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_step_normals_match_draw_normals_and_jax(jdt, tdt, max_ulp, steps, seed):
    C, dim, chunk_start, chunk_len = 5, 37, 64, 3
    jkeys, keys = _chain_keys(seed, C)
    words = refresh_keys(keys)
    chunk = draw_normals(keys, chunk_start, chunk_len, steps, dim, tdt)
    assert chunk.shape == (C, chunk_len, steps, dim) and chunk.dtype == tdt
    # draws at the chunk's start and past it; absolute draw indices
    for row in range(chunk_len):
        d = chunk_start + row
        for j in range(steps):
            got = step_normals(words, d, j, dim, tdt)
            assert torch.equal(got, chunk[:, row, j]), (d, j)
            ref = np.asarray(jax.vmap(lambda k: jax.random.normal(
                jax.random.split(jax.random.fold_in(jax.random.fold_in(k, 4), d), steps)[j],
                (dim,), jdt))(jkeys))
            assert got.numpy().dtype == ref.dtype
            assert _ulp(ref, got.numpy()) <= max_ulp, (d, j)


def test_step_normals_take_each_chains_own_draw():
    # chains at different draws and steps (the kernel reads both per chain)
    C, dim = 4, 9
    _, keys = _chain_keys(SEEDS[0], C)
    words = refresh_keys(keys)
    draws = torch.tensor([0, 5, 5, 300])
    steps = torch.tensor([0, 0, 2, 1])
    got = step_normals(words, draws, steps, dim, torch.float64)
    for c in range(C):
        want = step_normals(words[c:c + 1], int(draws[c]), int(steps[c]), dim, torch.float64)
        assert torch.equal(got[c], want[0])


@pytest.mark.parametrize("n_chains, dim, rank, itemsize, aligned, kind, form, copy", [
    # the MCLMC GLM: 10,240 chains, dim 64, float32: K2's held form
    (10240, 64, 0, 4, True, "diag", "held", None),
    (64, 64, 0, 8, True, "diag", "held", None),
    # the 1000-d Gaussian without its low-rank metric: strided
    (1024, 1000, 0, 4, True, "diag", "strided", None),
    (16, 33, 0, 8, True, "diag", "strided", None),
    # the low-rank path: staged by TMA in float32, streamed in float64
    (1024, 1000, 32, 4, True, "lr", "staged", "tma"),
    (16, 1000, 32, 8, True, "lr", "streamed", "tma"),
    (16, 500, 32, 8, True, "lr", "staged", "tma"),
    # 33 * 5 * 4 = 660 bytes a chain: not 16-byte aligned, loads
    (16, 33, 5, 4, True, "lr", "staged", "loads"),
    (16, 40, 8, 8, False, "lr", "staged", "loads"),
    (16, 3000, 16, 8, True, "lr", "streamed", "tma"),
])
def test_mclmc_plan(n_chains, dim, rank, itemsize, aligned, kind, form, copy):
    plan = mclmc_plan(n_chains, dim, rank, itemsize, aligned=aligned, **H100)
    assert plan.form == form
    if kind == "diag":
        assert isinstance(plan, DiagPlan)
        assert plan.grid * plan.chains_per_block >= n_chains
    else:
        assert isinstance(plan, LowRankPlan) and plan.copy == copy
        # K3's block lays out K2's shared memory (LrLayout)
        assert plan.smem_bytes == lr_smem_bytes(dim, rank, itemsize, form == "streamed")
        assert plan.smem_bytes <= H100["smem_per_block"]
        assert plan.grid == min(n_chains, plan.blocks_per_sm * H100["sm_count"])
    # the plan travels in McConfig.mk with the rank
    mk = mc_config(MclmcConfig(), n_chains, dim, 8, rank, plan).mk
    assert mk.lr_rank == rank
    for name, value in plan_fields(plan).items():
        assert getattr(mk, name) == value


def test_mclmc_plan_refuses_what_fits_nowhere():
    with pytest.raises(ValueError):
        mclmc_plan(16, 1000, 33, 4, **H100)  # rank past one a lane
    with pytest.raises(ValueError):
        mclmc_plan(16, 1, 0, 4, **H100)  # the isokinetic update needs dim >= 2
    with pytest.raises(ValueError):
        mclmc_plan(0, 64, 0, 4, **H100)
    with pytest.raises(RuntimeError, match="does not fit"):
        mclmc_plan(16, 1000, 32, 8, **{**H100, "smem_per_block": 48 * 1024})


def _c_fields(text: str, struct: str) -> list:
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", text, re.S).group(1)
    names = []
    for line in body.splitlines():
        code = line.split("//")[0].strip()
        if code.endswith(";") and "(" not in code:
            names.append(re.findall(r"(\w+)\s*;$", code)[0])
    return names


def test_mclmc_ctypes_mirrors_match_the_c_structs():
    src = (CSRC / "mclmc.cu").read_text()
    assert _c_fields(src, "McConfig") == [name for name, _ in McConfig._fields_]
    assert _c_fields(src, "McPtrs") == [name for name, _ in McPtrs._fields_]
    assert McConfig._fields_[0] == ("mk", MkConfig)
    # every slot the C geometry query fills has its name
    geometry = src[src.index("int geometry(const MkConfig* cfg"):]
    geometry = geometry[:geometry.index("\n}\n")]
    slots = {int(k) for k in re.findall(r"out\[(\d+)\]", geometry)}
    assert slots == set(range(len(GEOMETRY_FIELDS)))
