"""Two ranks of the port over gloo on the CPU, against one process and the
JAX package.

Two worker processes (``tests/torch_distributed_worker.py``) join a gloo
group and each runs its half of the fleet through every scenario; this
process runs the same scenario functions with no group, and the JAX
package's pooled runner on the 8-device CPU mesh (``conftest.py``), as
``tests/test_parallel.py`` shards it.  Float64 throughout.

- Runner level (16 chains of ``std_normal(4)``, pooled mass matrix and
  step size): the two ranks' state fields and chunk buffers, concatenated,
  equal one process's bitwise in every chunk, through a rescue whose
  trapped chain is on rank 1 and whose donor is on rank 0, with the fleet
  depth cap gathered from both.  One exception, ``POW_SLOTS``: on the CPU
  ``torch.pow`` (``count ** -kappa`` in ``adapt.dual_avg_update``) rounds
  the scalar tail of a tensor (under 16 float64 elements past the last
  whole pair of vectors) differently from its vectorized body, so 8
  chains a rank and 16 in one process part in the last bit of the
  averaged log step size and of ``step_size_bar``; those two are held to
  rtol 1e-12 (``test_pow_rounds_by_batch_size`` shows the op).
- ``sample()`` level (64 chains x (64 + 32), chunk 16, the fleet depth cap
  active): rank 0's trace equals one process's bitwise and rank 1 gets
  None; paused at its first report and aborted on rank 0, both ranks end
  at the same chunk with a checkpoint there; resumed over two ranks, the
  trace equals the uninterrupted run's bitwise.
- A chain count the ranks do not divide (7): every rank runs the whole
  fleet, with a warning, and rank 0's trace equals one process's.
- Against the JAX package: eight schools, 16 chains, two pooled warmup
  chunks of 8 draws from the JAX init converted by ``convert.py``: ints
  exact, floats at ``test_torch_step_runner.py``'s warmup bars.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import nutpie_tpu.models as jm
import nutpie_tpu_torch as nt
import torch_distributed_worker as worker
from nutpie_tpu.parallel import chain_mesh as jchain_mesh
from nutpie_tpu.sampler import AdaptConfig as JAdaptConfig
from nutpie_tpu.sampler import NutsConfig as JNutsConfig
from nutpie_tpu.sampler.adapt import make_schedule as jmake_schedule
from nutpie_tpu.sampler.run import init_chains as jinit_chains
from nutpie_tpu.sampler.run import make_chunk_runner as jmake_chunk_runner
from nutpie_tpu_torch.convert import state_to_arrays
from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS
from nutpie_tpu_torch.sampler.state import ADAPT_FLT_SLOTS, VEC_SLOTS, NutsMachineState
from torch_parity import jax_state_arrays

torch.set_num_threads(1)

WORKER = Path(__file__).parent / "torch_distributed_worker.py"
RANKS = 2
SCENARIOS = ("runner", "jax_runner", "sample", "whole", "control")
JAX_CHAINS, JAX_SEED = 16, 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_pooled_run(init_path: Path) -> list:
    """The JAX package's init (written to ``init_path`` for the ranks), then
    its pooled runner on the 8-device mesh over two chunks: each chunk's
    (state arrays, position, scalars)."""
    jmodel = jm.eight_schools()
    jcfg = JNutsConfig(maxdepth=worker.JAX_MAXDEPTH,
                       adapt=JAdaptConfig(num_tune=worker.JAX_TUNE))
    states, _ = jinit_chains(jmodel, jcfg, JAX_SEED, JAX_CHAINS, np.zeros(jmodel.ndim),
                             jnp.float64)
    tmp = init_path.with_suffix(".tmp.npz")
    np.savez(tmp, **jax_state_arrays(states))
    os.replace(tmp, init_path)
    sharding = NamedSharding(jchain_mesh(), P("chains"))
    states = jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), states)
    run = jmake_chunk_runner(jmodel, jcfg, worker.JAX_CHUNK, jnp.float64,
                             pool_mass_matrix=True)
    sched = jmake_schedule(jcfg.adapt, worker.JAX_TUNE)
    out = []
    for k in range(2):
        states, bufs = run(states, k * worker.JAX_CHUNK, worker.JAX_CHUNK, sched)
        out.append((jax_state_arrays(states), np.asarray(bufs.position),
                    np.asarray(bufs.scalars)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results by scenario, the JAX run and this process's
    runs of the scenarios with no group (made while the ranks run)."""
    outdir = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(RANKS), str(port),
                               str(outdir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(RANKS)]
    try:
        jax_rows = _jax_pooled_run(outdir / "jax_init.npz")
        alone = {
            "runner": worker.runner_scenario(None),
            "jax_runner": worker.jax_runner_scenario(outdir / "jax_init.npz", None),
            "sample": worker._raw_arrays("full", nt.sample(worker._model(), **worker.SAMPLE)),
            "whole": worker._raw_arrays("whole", nt.sample(worker._model(), **worker.WHOLE)),
        }
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    results = {name: [dict(np.load(outdir / f"{name}_rank{r}.npz", allow_pickle=True))
                      for r in range(RANKS)] for name in SCENARIOS}
    return dict(results=results, jax=jax_rows, alone=alone)


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _concat(parts: list, key: str) -> np.ndarray:
    return np.concatenate([p[key] for p in parts], axis=0)


def _assert_bitwise(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


# the slots downstream of torch.pow's batch-dependent rounding, by array
POW_SLOTS = {"/state/adapt_flts": ADAPT_FLT_SLOTS["log_step_bar"],
             "/bufs/scalars": SCALAR_SLOTS["step_size_bar"]}


def _assert_split_equal(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    """Bitwise, but for ``POW_SLOTS``, which are held to rtol 1e-12."""
    slot = next((v for k, v in POW_SLOTS.items() if what.endswith(k)), None)
    if slot is None:
        return _assert_bitwise(got, ref, what)
    rest = np.ones(got.shape[-1], dtype=bool)
    rest[slot] = False
    _assert_bitwise(got[..., rest], ref[..., rest], what)
    np.testing.assert_allclose(got[..., slot], ref[..., slot], rtol=1e-12, atol=0,
                               err_msg=what)


def test_pow_rounds_by_batch_size():
    """The exception's cause: ``count ** -kappa`` over 8 chains (the CPU's
    scalar tail) against the same rows inside 16 (its vectorized body)."""
    count = torch.arange(1, 17, dtype=torch.float64)
    whole = count ** -0.75
    halves = torch.cat([count[:8] ** -0.75, count[8:] ** -0.75])
    torch.testing.assert_close(halves, whole, rtol=1e-15, atol=0)
    assert not torch.equal(halves, whole)


def test_runner_two_ranks_equal_one_process(ranks):
    parts, ref = ranks["results"]["runner"], ranks["alone"]["runner"]
    split = [k for k in ref if "/state/" in k or "/bufs/" in k or "before_rescue" in k]
    assert len(split) > 5 * 8
    for key in split:
        _assert_split_equal(_concat(parts, key), ref[key], key)
    for key in (k for k in ref if k.endswith("/cap")):
        assert int(parts[0][key]) == int(parts[1][key]) == int(ref[key]), key


def test_rescue_donor_on_the_other_rank(ranks):
    """The trapped chain (rank 1's) takes the donor's rows from rank 0."""
    parts = ranks["results"]["runner"]
    k = 48 // worker.RUNNER_CHUNK - 1
    before = _concat(parts, f"c{k}/before_rescue_position")
    after = _concat(parts, f"c{k}/state/vecs")[:, VEC_SLOTS["position"]]
    half = worker.RUNNER_CHAINS // RANKS
    assert worker.TRAPPED >= half
    assert np.all(before[worker.TRAPPED] == worker.TRAP_AT)
    donors = [c for c in range(worker.RUNNER_CHAINS) if c != worker.TRAPPED
              and np.array_equal(_bits(after[c]), _bits(after[worker.TRAPPED]))]
    assert donors and all(d < half for d in donors), donors
    drawn = _concat(parts, f"c{k}/bufs/position")[worker.TRAPPED]
    assert np.all(np.abs(drawn - worker.TRAP_AT) < 1.0), "the chain left its trap"
    assert np.all(np.abs(after[worker.TRAPPED]) < 10.0)


def test_runner_matches_jax_sharded(ranks):
    """Two ranks' pooled chunks against the JAX package's 8-device run, and
    bitwise against one process of the port."""
    parts, ref = ranks["results"]["jax_runner"], ranks["alone"]["jax_runner"]
    for key in ref:
        _assert_split_equal(_concat(parts, key), ref[key], key)
    ns = SCALAR_SLOTS["n_steps"]
    for k, (jstate, jpos, jscal) in enumerate(ranks["jax"]):
        fields = {name.split("/")[-1]: torch.as_tensor(_concat(parts, name))
                  for name in ref if name.startswith(f"c{k}/state/")}
        got = state_to_arrays(NutsMachineState(**fields))
        np.testing.assert_array_equal(got["ints"], jstate["ints"])
        np.testing.assert_array_equal(got["rng_key"], jstate["rng_key"])
        for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
            np.testing.assert_array_equal(got[f"adapt.{acc}.count"], jstate[f"adapt.{acc}.count"])
        scal = _concat(parts, f"c{k}/bufs/scalars")
        np.testing.assert_array_equal(scal[..., ns], jscal[..., ns])
        np.testing.assert_allclose(_concat(parts, f"c{k}/bufs/position"), jpos,
                                   rtol=1e-3, atol=1e-3)
        for name in ("adapt.inv_mass", "adapt.da.log_step_bar"):
            np.testing.assert_allclose(got[name], jstate[name], rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def _assert_trace(got: dict, ref: dict, prefix: str, ref_prefix: str, draws: slice):
    names = sorted(k[len(ref_prefix):] for k in ref if k.startswith(ref_prefix))
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)
                  and k != f"{prefix}draws_done") == names
    for name in names:
        _assert_bitwise(got[prefix + name], ref[ref_prefix + name][:, draws], name)


def test_sample_trace_on_rank_zero(ranks):
    rank0, rank1 = ranks["results"]["sample"]
    assert "full/none" in rank1 and len(rank1) == 1
    _assert_trace(rank0, ranks["alone"]["sample"], "full/", "full/", slice(None))
    assert rank0["full/position"].shape == (64, 96, 10)


def test_indivisible_fleet_runs_whole_on_every_rank(ranks):
    rank0, rank1 = ranks["results"]["whole"]
    assert "whole/none" in rank1 and len(rank1) == 1
    with pytest.warns(UserWarning, match="whole fleet"):
        from nutpie_tpu_torch.parallel import ChainMesh

        assert ChainMesh(size=RANKS, group=object()).for_chains(7).whole
    _assert_trace(rank0, ranks["alone"]["whole"], "whole/", "whole/", slice(None))
    assert rank0["whole/position"].shape == (7, 16, 10)


def test_abort_ends_both_ranks_at_one_chunk(ranks):
    rank0, rank1 = ranks["results"]["control"]
    draws = worker.CONTROL_DRAWS
    assert int(rank0["partial/draws_done"]) == int(rank1["partial/draws_done"]) == draws
    assert "partial/none" in rank1
    _assert_trace(rank0, ranks["alone"]["sample"], "partial/", "full/", slice(0, draws))


def test_resume_over_two_ranks(ranks):
    rank0, rank1 = ranks["results"]["control"]
    assert "resumed/none" in rank1
    _assert_trace(rank0, ranks["alone"]["sample"], "resumed/", "full/",
                  slice(worker.CONTROL_DRAWS, None))
