#!/usr/bin/env python3
"""Same-card A/B of the port's step route between two source trees.

Runs, for each tree given, in a process of its own (both trees import as
``nutpie_tpu_torch``), chip_smoke.py's two step-route paths through
``sample()`` and prints one JSON line per run:

- the GLM path: 10,240 chains x (300 tune + 300 draws) of
  ``logistic_glm(n_data=2048, dim=64)``, chunk 32, float32, seed 42;
- the low-rank path: 1024 chains x (300 tune + 40 draws) of the 1000-d
  ill-conditioned Gaussian under ``adaptation="low_rank"``, eigenvalue
  cutoff 3.0, float32, seed 42;
- K2's device time a machine step on the GLM path: a short run (10,240
  chains x (32 + 32)) under ``torch.profiler``, the device time of the
  step kernel's launches (``step_begin``, ``step_finish``,
  ``step_advance``) over the run's machine steps.

Each path reports its wall, gradients/s and host wall per machine step
(machine steps from the draws' step counts, rounded up per chunk to the
tree's ``CUDA_UNROLL``).  Usage, from a checkout with the parent commit
unpacked beside it (``git archive``), on a machine with one CUDA card::

    python3 scripts/torch_step_ab.py _chip/parent . . _chip/parent

The card's name and power limit come first.  It checks nothing; the
comparison is read from the lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

GLM = dict(chains=10240, tune=300, draws=300, chunk=32, n_data=2048, dim=64)
GLM_SHORT = dict(tune=32, draws=32)
LR = dict(chains=1024, tune=300, draws=40, dim=1000, cutoff=3.0, chunk=80)


def machine_steps(n_steps, chunk_len: int, unroll: int) -> int:
    """Machine steps of a run from its draws' step counts [C, draws]."""
    total = 0
    for start in range(0, n_steps.shape[1], chunk_len):
        per_chain = n_steps[:, start:start + chunk_len].astype("int64").sum(axis=1)
        total += -(-int(per_chain.max()) // unroll) * unroll
    return total


def run_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.run import CUDA_UNROLL

    out = {"tree": tree, "unroll": CUDA_UNROLL}

    def timed(compiled, chunk, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = nt.sample(compiled, seed=42, precision="float32", device="cuda",
                        return_raw_trace=True, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_steps = raw["stats"]["n_steps"]
        steps = machine_steps(n_steps, chunk, CUDA_UNROLL)
        grads = int(n_steps.astype("int64").sum())
        return {"wall_s": wall, "machine_steps": steps, "gradients": grads,
                "grads_per_s": grads / wall, "host_wall_ms_per_machine_step": 1e3 * wall / steps}

    glm = compile_model_def(nt.models.logistic_glm(n_data=GLM["n_data"], dim=GLM["dim"]))
    # the first run builds the kernels; its time is not reported
    nt.sample(glm, chains=256, tune=8, draws=8, chunk_size=GLM["chunk"], seed=1,
              precision="float32", device="cuda")
    out["glm"] = timed(glm, GLM["chunk"], chains=GLM["chains"], tune=GLM["tune"],
                       draws=GLM["draws"], chunk_size=GLM["chunk"])
    gauss = compile_model_def(nt.models.ill_conditioned_gaussian(dim=LR["dim"]))
    out["lowrank"] = timed(gauss, LR["chunk"], adaptation="low_rank", chains=LR["chains"],
                           tune=LR["tune"], draws=LR["draws"],
                           mass_matrix_eigval_cutoff=LR["cutoff"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        raw = nt.sample(glm, chains=GLM["chains"], chunk_size=GLM["chunk"], seed=44,
                        precision="float32", device="cuda", return_raw_trace=True,
                        **GLM_SHORT)
        torch.cuda.synchronize()
    k2 = [(ev.self_device_time_total, ev.count) for ev in prof.key_averages()
          if ev.device_type != torch.autograd.DeviceType.CPU
          and any(f"step_{k}" in ev.key for k in ("begin", "finish", "advance"))]
    steps = machine_steps(raw["stats"]["n_steps"], GLM["chunk"], CUDA_UNROLL)
    out["glm_short_k2"] = {"machine_steps": steps, "launches_traced": sum(c for _, c in k2),
                           "device_ms_per_machine_step": sum(t for t, _ in k2) / 1e3 / steps}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(run_tree(sys.argv[2])), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
