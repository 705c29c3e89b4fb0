#!/usr/bin/env python3
"""Same-card A/B of K2's low-rank step between two source trees.

Each tree's step kernel is built first (the trees side by side).  Then,
for each tree given, in a process of its own (every tree imports as
``nutpie_tpu_torch`` and ``chip_smoke``), the tree's own ``chip_smoke``
makes the low-rank path's float32 timing fleet (1024 chains of the 1000-d
Gaussian at stationarity, R = 32, cutoff ``LR_CUTOFF``, seed 33) and times
K2's ``advance`` over one frozen chunk of each of ``--draws`` draws: by
CUDA events around each launch made one by one (``_timed_steps``) and by
device time over the chunk's first 128 machine steps under
``torch.profiler`` (``_device_step_ms``).  One JSON line per run.  Usage,
from a checkout with the parent commit unpacked beside it (``git
archive``), on a machine with one CUDA card::

    python3 scripts/lowrank_step_ab.py --draws 8,16 _chip/parent . . _chip/parent

The card's name and power limit come first.  It checks nothing; the
comparison is read from the lines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FLEET_SEED, DEVICE_STEPS = 33, 128


def _import_tree(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke

    return chip_smoke


def build_tree(tree: str) -> None:
    """The tree's float32 step kernel library."""
    _import_tree(tree)
    from nutpie_tpu_torch.ops import build

    variants = getattr(build, "VARIANTS", {})
    build.build_all([n for n in ("step_kernel_f32", "step_device") if n in variants]
                    or ["step_kernel"])


def run_tree(tree: str, draws: list[int]) -> dict:
    import torch

    cs = _import_tree(tree)
    model, cfg, sched, states, _ = cs._lr_fleet(cs.LR_CHAINS, torch.float32, FLEET_SEED,
                                                cs.LR_CUTOFF)
    out = {"tree": tree, "chains": cs.LR_CHAINS, "dim": cs.LR_DIM, "rank": cs.LR_RANK}
    for n in draws:
        ms, steps, _ = cs._timed_steps(model, cfg, sched, states, n)
        dev = cs._device_step_ms(model, cfg, sched, states, n, DEVICE_STEPS)
        out[f"draws_{n}"] = {"machine_steps": steps, "advance_ms": ms["advance"],
                             "logp_grad_ms": ms["logp_grad"],
                             "advance_device_ms": dev["advance"],
                             "device_steps": DEVICE_STEPS}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--draws", default="8,16", help="comma-separated chunk lengths")
    parser.add_argument("--build", help=argparse.SUPPRESS)
    parser.add_argument("--run", help=argparse.SUPPRESS)
    parser.add_argument("trees", nargs="*")
    args = parser.parse_args()
    draws = [int(d) for d in args.draws.split(",")]
    if args.build:
        build_tree(args.build)
        return 0
    if args.run:
        print(json.dumps(run_tree(args.run, draws)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", t])
              for t in dict.fromkeys(args.trees)]
    if any([p.wait() for p in builds]):
        print("lowrank_step_ab: a build failed", file=sys.stderr)
        return 1
    for tree in args.trees:
        done = subprocess.run([sys.executable, me, "--draws", args.draws, "--run", tree])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
