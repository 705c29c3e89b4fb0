#!/usr/bin/env python3
"""How far the chunk kernel and its plain version drift apart in warmup.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_warmup_drift.py

In warmup every draw adapts the step size and mass matrix from the draws
before it, so a rounding difference is fed forward.  This script measures
that drift in float64 on radon at the main path's shapes (2048 chains,
chunks of 128), and prints one JSON line per reading:

1. ``chunk0``: the first warmup chunk through the kernel and through the
   plain version from the same state: the chains whose tree decisions
   (step count, depth, divergence, index in the trajectory) differ
   somewhere, the draw of each chain's first difference, and the per-draw
   position difference of the chains whose decisions never differ.
2. ``cpu_plain``: the plain version on the CPU for four of those chains
   (chains are independent within a chunk), beside both runs on the card:
   the draw at which it first differs from each.
3. ``no_fma``: the kernel built with ``-fmad=false`` (no contraction of
   ``a*b+c``) against the FMA build and against the plain version.
4. ``windows``: ``chip_smoke.py``'s float64 warmup walk, with 16-draw
   windows at draws 0, 80, 152, 232, 264 and 288: per window the chains
   whose decisions differ and the per-draw position difference.

The script checks nothing; ``chip_smoke.py`` holds the kernel to its bars.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
DECISIONS = ("n_steps", "depth", "diverging", "index_in_trajectory")
WINDOWS_16 = ((0, 16), (80, 16), (152, 16), (232, 16), (264, 16), (288, 12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def decisions_differ(b_k, b_p, limit):
    """[C, limit] mask of draws whose tree decisions differ."""
    import torch

    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    diff = torch.zeros(b_k.scalars.shape[:2], dtype=torch.bool,
                       device=b_k.scalars.device)[:, :limit]
    for name in DECISIONS:
        j = SCALAR_SLOTS[name]
        diff |= b_k.scalars[:, :limit, j] != b_p.scalars[:, :limit, j]
    return diff


def first_differences(a, b):
    """Per chain, the first draw whose step counts differ (-1 for none)."""
    from nutpie_tpu_torch.sampler.nuts import SCALAR_SLOTS

    ns = SCALAR_SLOTS["n_steps"]
    d = a.scalars[..., ns].cpu() != b.scalars[..., ns].cpu()
    return [int(r.double().argmax()) if bool(r.any()) else -1 for r in d]


def g3(x) -> float:
    return float(f"{float(x):.3g}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_warmup_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nutpie_tpu_torch.ops import build
    from nutpie_tpu_torch.sampler.adapt import pool_adapt_state
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel, plain_chunk
    from nutpie_tpu_torch.sampler.run import draw_randoms
    from nutpie_tpu_torch.sampler.state import NutsMachineState

    emit({"card": cs.card_line(), "torch": torch.__version__})
    dtype, L = torch.float64, cs.CHUNK
    model, cfg, sched, states = cs._setup(cs.CHAINS, dtype, 5)
    av, af = pool_adapt_state(states.adapt_vecs, states.adapt_flts,
                              pool_mass=True, pool_step=True)
    states = states.replace(adapt_vecs=av, adapt_flts=af)
    mom, jit = draw_randoms(states.key, 0, L, model.ndim, dtype)
    s_k, b_k = chunk_kernel(cfg, model, sched, 0, L, states, mom, jit, False)
    s_p, b_p = plain_chunk(cfg, model, sched, 0, L, states.clone(), mom, jit, False)
    torch.cuda.synchronize()

    diff = decisions_differ(b_k, b_p, L)
    bad = diff.any(1)
    first = diff.double().argmax(1)[bad]
    pos = (b_k.position - b_p.position).abs().amax(-1)
    same = pos[~bad]
    emit({"reading": "chunk0", "chains": cs.CHAINS, "draws": L,
          "chains_decisions_differ": int(bad.sum()),
          "first_difference_draw_min": int(first.min()) if len(first) else None,
          "first_difference_draw_max": int(first.max()) if len(first) else None,
          "same_decisions_pos_diff_median_every_8th_draw":
              [g3(x) for x in same.median(0).values[::8]],
          "same_decisions_pos_diff_max_every_8th_draw":
              [g3(x) for x in same.amax(0)[::8]]})

    idx = torch.nonzero(bad).flatten()[:4]
    sub = NutsMachineState(**{k: v[idx].cpu() for k, v in states.tensors().items()})
    _, b_c = plain_chunk(cfg, model, sched, 0, L, sub, mom[idx].cpu(), jit[idx].cpu(), False)
    k_sub = type(b_k)(*(t[idx] for t in b_k))
    p_sub = type(b_p)(*(t[idx] for t in b_p))
    emit({"reading": "cpu_plain", "chains": idx.tolist(),
          "first_difference_kernel_vs_card_plain": first_differences(k_sub, p_sub),
          "first_difference_cpu_plain_vs_kernel": first_differences(b_c, k_sub),
          "first_difference_cpu_plain_vs_card_plain": first_differences(b_c, p_sub)})

    # a second build of the same sources, without FMA contraction
    build.FLAGS = build.FLAGS + ("-fmad=false",)
    build._LOADED.clear()
    _, b_n = chunk_kernel(cfg, model, sched, 0, L, states, mom, jit, False)
    torch.cuda.synchronize()
    emit({"reading": "no_fma",
          "chains_differ_no_fma_vs_plain": int(decisions_differ(b_n, b_p, L).any(1).sum()),
          "chains_differ_no_fma_vs_fma": int(decisions_differ(b_n, b_k, L).any(1).sum())})
    build.FLAGS = build.FLAGS[:-1]
    build._LOADED.clear()

    def window(tag, limit, s_k, b_k, s_p, b_p):
        diff = decisions_differ(b_k, b_p, limit)
        bad = diff.any(1)
        pos = (b_k.position[:, :limit] - b_p.position[:, :limit]).abs().amax(-1)
        emit({"reading": "window", "tag": tag, "chains_decisions_differ": int(bad.sum()),
              "ints_equal": bool(torch.equal(s_k.ints, s_p.ints)),
              "pos_diff_max_by_draw": [g3(x) for x in pos.amax(0)],
              "pos_diff_median_by_draw": [g3(x) for x in pos.median(0).values]})
        return {}

    cs.WINDOWS = {"float64": WINDOWS_16}
    cs._warm_fleet(dtype, 5, window)
    return 0


if __name__ == "__main__":
    sys.exit(main())
