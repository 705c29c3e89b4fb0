#!/usr/bin/env python3
"""Same-card A/B of K3 (the MCLMC step kernel) between two source trees.

Each tree's MCLMC kernel library is built first (the trees side by side).
Then, for each tree given, in a process of its own (every tree imports as
``nutpie_tpu_torch`` and ``chip_smoke``), the tree's own ``chip_smoke``
times K3's kick and settle per step (``_k3_timed``: CUDA events around each
launch made one by one, and device time under ``torch.profiler``) at the
GLM's main shapes (10,240 chains, dim 64, float32, one frozen 32-draw
chunk) and at the low-rank path's (1024 chains, dim 1000, R 32, float32,
one random orthonormal basis, a frozen 16-draw chunk), as chip_smoke's
``step_timing`` does, beside:

- the library yardstick of the low-rank metric part: two ``torch.bmm`` an
  application, three applications a step (``_library_ms``, the same code
  for every tree), by CUDA events and by device time;
- ``mclmc.draw_normals`` at the GLM chunk's shape ([10240, 32, 1, 64]
  float32): host ms around the call between two synchronizes, and device
  ms between CUDA events (the tree's runner may not call it: it is timed
  as a function);
- with ``--glm-run``, the MCLMC GLM run of chip_smoke's ``mclmc`` phase
  (``sample(sampler="mclmc")``, 10,240 chains x (1200 + 300), chunk 32,
  float32, seed 42): wall seconds and the calls of ``draw_normals`` in it.

One JSON line per run.  Usage, from a checkout with the parent commit
unpacked beside it (``git archive``), on a machine with one CUDA card::

    python3 scripts/mclmc_step_ab.py --glm-run _chip/parent . . _chip/parent

The card's name and power limit come first.  It checks nothing; the
comparison is read from the lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED_GLM, SEED_LR, NORMALS_REPS = 43, 44, 5


def _import_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke

    return chip_smoke


def build_tree(tree: str) -> None:
    """The tree's MCLMC kernel library."""
    _import_tree(tree)
    from nutpie_tpu_torch.ops import build

    build.build_all(["mclmc"])


def _normals_ms(cs, states) -> dict:
    """``draw_normals`` at the GLM chunk's shape: host ms (synchronized) and
    device ms (CUDA events), the mean of ``NORMALS_REPS`` calls after one."""
    import torch

    import nutpie_tpu_torch.sampler.mclmc as mclmc

    args = (states.key, cs.MCLMC_PARITY_TUNE, cs.GLM_CHUNK, 1, cs.GLM_DIM, torch.float32)
    mclmc.draw_normals(*args)
    torch.cuda.synchronize()
    host, dev = 0.0, 0.0
    for _ in range(NORMALS_REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = mclmc.draw_normals(*args)
        end.record()
        torch.cuda.synchronize()
        host += 1e3 * (time.perf_counter() - t0) / NORMALS_REPS
        dev += start.elapsed_time(end) / NORMALS_REPS
    return {"shape": list(out.shape), "host_ms": host, "device_ms": dev,
            "bytes": out.numel() * out.element_size()}


def _library_ms(basis, reps: int = 50) -> dict:
    """Three applications of the low-rank metric part for every chain, each
    w^T U and then U c as two ``torch.bmm`` calls: ms a step by CUDA events
    and by device time under ``torch.profiler`` (every device kernel of the
    calls), the mean of ``reps`` applications."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_chains, dim, _ = basis.shape
    w = torch.randn((n_chains, 1, dim), dtype=basis.dtype, device=basis.device)
    ut = basis.transpose(1, 2)

    def apply():
        torch.bmm(torch.bmm(w, basis), ut)

    apply()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        apply()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            apply()
        torch.cuda.synchronize()
    device_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type != torch.autograd.DeviceType.CPU)
    return {"library_ms_per_step": 3 * start.elapsed_time(end) / reps,
            "library_device_ms_per_step": 3 * device_us / 1e3 / reps}


def _glm_run(cs) -> dict:
    """chip_smoke's MCLMC GLM run: wall seconds, and the calls of
    ``draw_normals`` in it."""
    import torch

    import nutpie_tpu_torch as nt
    import nutpie_tpu_torch.sampler.mclmc as mclmc
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def

    calls = []
    draw_normals = mclmc.draw_normals

    def counted(*args, **kwargs):
        calls.append(1)
        return draw_normals(*args, **kwargs)

    compiled = compile_model_def(cs._glm_model())
    mclmc.draw_normals = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nt.sample(compiled, sampler="mclmc", progress_bar=False, chains=cs.GLM_CHAINS,
                  tune=cs.MCLMC_GLM_TUNE, draws=cs.GLM_DRAWS, seed=42,
                  chunk_size=cs.GLM_CHUNK, precision="float32", device=cs.DEVICE,
                  return_raw_trace=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        mclmc.draw_normals = draw_normals
    return {"wall_s": wall, "draw_normals_calls": len(calls),
            "draws": cs.MCLMC_GLM_TUNE + cs.GLM_DRAWS}


def run_tree(tree: str, glm_run: bool) -> dict:
    import torch

    cs = _import_tree(tree)
    from nutpie_tpu_torch.models import ill_conditioned_gaussian
    from nutpie_tpu_torch.sampler.nuts import LowRankConfig

    out = {"tree": tree}
    tune = cs.MCLMC_PARITY_TUNE
    model = cs._glm_model()
    cfg, sched = cs._mclmc_cfg(tune)
    states = cs._mclmc_init(model, cfg, cs.GLM_CHAINS, torch.float32, SEED_GLM)
    states = states.replace(ints=states.ints.clone().index_fill_(
        1, torch.tensor([0], device=cs.DEVICE), tune))
    out["glm"] = cs._k3_timed(model, cfg, sched, states, tune, cs.GLM_CHUNK, 2)
    out["draw_normals_glm_chunk"] = _normals_ms(cs, states)
    del model, states
    lmodel = ill_conditioned_gaussian(dim=cs.LR_DIM)
    lcfg, lsched = cs._mclmc_cfg(tune, low_rank=LowRankConfig(max_rank=cs.LR_RANK))
    lstates = cs._mclmc_init(lmodel, lcfg, cs.LR_CHAINS, torch.float32, SEED_LR)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(SEED_LR)
    q, _ = torch.linalg.qr(torch.randn((cs.LR_DIM, cs.LR_RANK), generator=gen,
                                       device=cs.DEVICE))
    lstates = lstates.replace(
        ints=lstates.ints.clone().index_fill_(1, torch.tensor([0], device=cs.DEVICE), tune),
        lr_basis=q.expand(cs.LR_CHAINS, cs.LR_DIM, cs.LR_RANK).contiguous(),
        lr_log_eigs=torch.linspace(-2.0, 2.0, cs.LR_RANK, device=cs.DEVICE).expand(
            cs.LR_CHAINS, cs.LR_RANK).contiguous())
    out["lowrank"] = cs._k3_timed(lmodel, lcfg, lsched, lstates, tune, 16, 2)
    out["lowrank"].update(_library_ms(lstates.lr_basis))
    del lmodel, lstates
    if glm_run:
        out["glm_run"] = _glm_run(cs)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--glm-run", action="store_true",
                        help="also run the MCLMC GLM path end to end")
    parser.add_argument("--build", help=argparse.SUPPRESS)
    parser.add_argument("--run", help=argparse.SUPPRESS)
    parser.add_argument("trees", nargs="*")
    args = parser.parse_args()
    if args.build:
        build_tree(args.build)
        return 0
    if args.run:
        print(json.dumps(run_tree(args.run, args.glm_run)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", t])
              for t in dict.fromkeys(args.trees)]
    if any([p.wait() for p in builds]):
        print("mclmc_step_ab: a build failed", file=sys.stderr)
        return 1
    for tree in args.trees:
        cmd = [sys.executable, me, "--run", tree] + (["--glm-run"] if args.glm_run else [])
        done = subprocess.run(cmd)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
