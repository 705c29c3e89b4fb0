"""One rank of the port's multi-process runs (``tests/test_torch_distributed.py``).

Usage: python torch_distributed_worker.py <rank> <world_size> <port> <outdir>

Each rank joins a gloo group on the CPU (``initialize_distributed(...,
device="cpu")``) and runs every scenario below over its slice of the
fleet, writing ``<scenario>_rank<r>.npz`` into ``outdir``.  The scenario
functions take the mesh as an argument, so the test process runs the same
functions with no group (``mesh=None``) for the one-process reference.
No JAX here: the JAX package's run is the test process's.
"""

import os
import sys
import threading
import time

import numpy as np
import torch

import nutpie_tpu_torch as nt
from nutpie_tpu_torch.convert import state_from_arrays
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.parallel import initialize_distributed, local_rows, shard_chains
from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
from nutpie_tpu_torch.sampler.nuts import NutsConfig
from nutpie_tpu_torch.sampler.run import fleet_depth_cap, init_chains, make_chunk_runner
from nutpie_tpu_torch.sampler.state import ADAPT_VEC_SLOTS, state_with

torch.set_num_threads(1)

# runner level: 16 chains of std_normal(4), pooled mass matrix and step
# size, chunks of 16 over 64 tuning draws and one posterior chunk; chain
# TRAPPED (rank 1's under two ranks) is moved to TRAP_AT with an inverse
# mass of TRAP_INV_MASS before the chunk that ends at draw 48, the last in
# the rescue's window (end >= 32 and 4 * end <= 3 * num_tune; no mass
# matrix switch falls in it): its moves are then too small to leave, so it
# is trapped at the chunk's end and the rescue teleports it onto the
# median chain, which seed RUNNER_SEED puts on rank 0
RUNNER_CHAINS, RUNNER_TUNE, RUNNER_CHUNK, RUNNER_SEED = 16, 64, 16, 8
TRAPPED, TRAP_AT, TRAP_INV_MASS = 12, 1e3, 1e-12
# against the JAX package: eight schools, 16 chains, two pooled warmup
# chunks of 8 draws from the JAX package's init (``jax_init.npz``)
JAX_CHUNK, JAX_TUNE, JAX_MAXDEPTH = 8, 64, 6
# sample() level: 64 chains (the fleet depth cap acts from 64), 64 + 32
# draws in chunks of 16; the controlled run pauses at the first progress
# report, which parks it at draw CONTROL_DRAWS (the loop is double
# buffered), then aborts with a checkpoint there, and is resumed
SAMPLE = dict(chains=64, tune=64, draws=32, chunk_size=16, seed=5, maxdepth=6,
              device="cpu", progress_bar=False, return_raw_trace=True)
CONTROL_DRAWS = 32
# a chain count two ranks do not divide: every rank runs the whole fleet
WHOLE = dict(SAMPLE, chains=7, tune=8, draws=8, chunk_size=8)


def _state_arrays(prefix: str, states) -> dict:
    return {f"{prefix}/state/{k}": v.numpy().copy() for k, v in states.tensors().items()}


def _bufs_arrays(prefix: str, bufs) -> dict:
    return {f"{prefix}/bufs/{k}": v.numpy().copy() for k, v in bufs._asdict().items()
            if v is not None}


def runner_scenario(mesh=None) -> dict:
    """Pooling, the rescue and the fleet depth cap through the step runner:
    every chunk's state and buffers (this rank's chains) and each chunk's cap."""
    model = nt.models.std_normal(4)
    cfg = NutsConfig(maxdepth=6, adapt=AdaptConfig(num_tune=RUNNER_TUNE))
    sched = make_schedule(cfg.adapt, RUNNER_TUNE)
    states, _ = init_chains(model, cfg, RUNNER_SEED, RUNNER_CHAINS, np.zeros(4),
                            torch.float64, mesh=mesh)
    pool = dict(pool_mass_matrix=True, pool_step_size=True, mesh=mesh)
    warm = make_chunk_runner(model, cfg, RUNNER_CHUNK, torch.float64, **pool)
    post = make_chunk_runner(model, cfg, RUNNER_CHUNK, torch.float64, adapt_frozen=True,
                             **pool)
    rows = local_rows(mesh, RUNNER_CHAINS)
    out = {}
    for k, start in enumerate(range(0, RUNNER_TUNE + RUNNER_CHUNK, RUNNER_CHUNK)):
        if start + RUNNER_CHUNK == 48:
            local = TRAPPED - (rows.start or 0)
            if 0 <= local < states.vecs.shape[0]:
                pos = states.position.clone()
                pos[local] = TRAP_AT
                logp, grad = model.logp_and_grad(pos)
                adapt_vecs = states.adapt_vecs.clone()
                adapt_vecs[local, ADAPT_VEC_SLOTS["inv_mass"]] = TRAP_INV_MASS
                states = state_with(states.replace(adapt_vecs=adapt_vecs), position=pos,
                                    gradient=grad, logp=logp)
            out[f"c{k}/before_rescue_position"] = states.position.numpy().copy()
        run = warm if start < RUNNER_TUNE else post
        states, bufs = run(states, start, RUNNER_CHUNK, sched)
        cap = fleet_depth_cap(cfg, bufs, RUNNER_CHUNK, mesh)
        sched = sched._replace(depth_cap=cap)
        out.update(_state_arrays(f"c{k}", states))
        out.update(_bufs_arrays(f"c{k}", bufs))
        out[f"c{k}/cap"] = np.asarray(int(cap))
    return out


def jax_runner_scenario(init_path, mesh=None) -> dict:
    """The pooled step runner over two warmup chunks from the JAX package's
    init (the whole fleet's arrays for ``convert.py``, which the test
    process writes while the ranks run the runner scenario)."""
    for _ in range(1200):
        if os.path.exists(init_path):
            break
        time.sleep(0.1)
    model = nt.models.eight_schools()
    cfg = NutsConfig(maxdepth=JAX_MAXDEPTH, adapt=AdaptConfig(num_tune=JAX_TUNE))
    sched = make_schedule(cfg.adapt, JAX_TUNE)
    with np.load(init_path) as data:
        states = state_from_arrays({k: data[k] for k in data.files})
    if mesh is not None:
        states = shard_chains(states, mesh)
    run = make_chunk_runner(model, cfg, JAX_CHUNK, torch.float64, pool_mass_matrix=True,
                            mesh=mesh)
    out = {}
    for k in range(2):
        states, bufs = run(states, k * JAX_CHUNK, JAX_CHUNK, sched)
        out.update(_state_arrays(f"c{k}", states))
        out.update(_bufs_arrays(f"c{k}", bufs))
    return out


def _raw_arrays(prefix: str, raw) -> dict:
    if raw is None:
        return {f"{prefix}/none": np.asarray(True)}
    out = {f"{prefix}/position": raw["position"]}
    for group in ("stats", "expanded"):
        out.update({f"{prefix}/{group}/{k}": v for k, v in raw[group].items()})
    return out


def _model():
    return compile_model_def(nt.models.eight_schools())


def sample_scenario() -> dict:
    """``sample()`` uninterrupted: the trace (rank 0) or None."""
    return _raw_arrays("full", nt.sample(_model(), **SAMPLE))


def whole_scenario() -> dict:
    """``sample()`` of a fleet the ranks do not split: the trace (rank 0)
    or None."""
    return _raw_arrays("whole", nt.sample(_model(), **WHOLE))


def control_scenario(checkpoint) -> dict:
    """Paused at the first progress report, aborted on rank 0 with a
    checkpoint, then resumed from it: the partial and resumed traces (or
    None) and the draws each rank finished before the abort."""
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    first, ready, handle = threading.Event(), threading.Event(), {}

    def on_progress(progress):
        if not first.is_set():
            first.set()
            ready.wait(60)
            handle["h"].pause()

    h = nt.sample(_model(), blocking=False, checkpoint=str(checkpoint),
                  progress_callback=on_progress if rank == 0 else None, **SAMPLE)
    handle["h"] = h
    ready.set()
    if rank == 0:
        assert h.wait_paused(timeout=120), "the run did not park"
        partial = h.abort()
    else:
        partial = h.wait(timeout=300)
    out = _raw_arrays("partial", partial)
    out["partial/draws_done"] = np.asarray(h.draws_done)
    out.update(_raw_arrays("resumed", nt.sample(_model(), resume_from=str(checkpoint),
                                                **SAMPLE)))
    return out


def main() -> None:
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4])
    mesh = initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                                  timeout=120.0)
    assert mesh.size == world and mesh.rank == rank, mesh
    results = {
        "runner": lambda: runner_scenario(mesh),
        "jax_runner": lambda: jax_runner_scenario(os.path.join(outdir, "jax_init.npz"), mesh),
        "sample": sample_scenario,
        "whole": whole_scenario,
        "control": lambda: control_scenario(os.path.join(outdir, "state.npz")),
    }
    for name, scenario in results.items():
        t0 = time.perf_counter()
        np.savez(os.path.join(outdir, f"{name}_rank{rank}.npz"), **scenario())
        print(f"rank {rank}: {name} {time.perf_counter() - t0:.1f} s", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
