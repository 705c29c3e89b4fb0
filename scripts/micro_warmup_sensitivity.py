#!/usr/bin/env python3
"""How far two runs of microcanonical NUTS's warmup part on the GLM when
their starts differ by one ulp.

chip_smoke.py holds K2's microcanonical instantiations to their plain
version over warmup windows at rtol 1e-3.  This script measures what any
two implementations that round differently can be held to there: it
carries a fleet of the GLM (``logistic_glm(n_data=2048, dim=64)``,
float64, seed 21, 300 tuning draws, as chip_smoke's micro phase) through
the plain version to each draw of ``--from-draws``, then runs it on from
there twice, draw by draw, once with every row of ``vecs`` nudged by one
ulp.  For each draw it prints one JSON line: whether the integers agree,
the largest position difference of the draw, the largest difference in
the adaptation rows (``adapt_vecs``) and its ratio to the warmup bar
(1e-3 + 1e-3 |x|), and the slot where that ratio peaks.  Runs on the CPU
in about a minute::

    python3 scripts/micro_warmup_sensitivity.py --from-draws 24,120
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GLM_N_DATA, GLM_DIM, TUNE, SEED = 2048, 64, 300, 21


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chains", type=int, default=64)
    parser.add_argument("--from-draws", default="24,120")
    parser.add_argument("--draws", type=int, default=12)
    args = parser.parse_args()

    import numpy as np
    import torch

    from nutpie_tpu_torch.models import logistic_glm
    from nutpie_tpu_torch.sampler.adapt import AdaptConfig, make_schedule
    from nutpie_tpu_torch.sampler.nuts import NutsConfig
    from nutpie_tpu_torch.sampler.run import init_chains, make_chunk_runner
    from nutpie_tpu_torch.sampler.state import ADAPT_VEC_SLOTS

    slot_names = {v: k for k, v in ADAPT_VEC_SLOTS.items()}
    model = logistic_glm(n_data=GLM_N_DATA, dim=GLM_DIM)
    cfg = NutsConfig(kinetic="microcanonical", adapt=AdaptConfig(num_tune=TUNE))
    sched = make_schedule(cfg.adapt, TUNE, cfg.initial_depth_cap)
    states, ok = init_chains(model, cfg, SEED, args.chains, np.zeros(model.ndim),
                             torch.float64, device="cpu")
    assert bool(ok.all()), "chain initialization failed"
    one = make_chunk_runner(model, cfg, 1, torch.float64, adapt_frozen=False, plain=True)
    for start in sorted(int(d) for d in args.from_draws.split(",")):
        carry = make_chunk_runner(model, cfg, start, torch.float64, adapt_frozen=False,
                                  plain=True)
        a, _ = carry(states, 0, start, sched)
        b = a.replace(vecs=torch.nextafter(a.vecs, torch.full_like(a.vecs, np.inf)))
        for d in range(start, start + args.draws):
            a, bufs_a = one(a, d, 1, sched)
            b, bufs_b = one(b, d, 1, sched)
            diff = (a.adapt_vecs - b.adapt_vecs).abs()
            ratio = diff / (1e-3 + 1e-3 * b.adapt_vecs.abs())
            print(json.dumps({
                "from_draw": start, "draw": d, "ints_equal": bool(torch.equal(a.ints, b.ints)),
                "max_abs_diff_position": (bufs_a.position - bufs_b.position).abs().max().item(),
                "max_abs_diff_adapt_vecs": diff.max().item(),
                "worst_ratio_to_bar": ratio.max().item(),
                "worst_slot": slot_names[int(ratio.amax(dim=(0, 2)).argmax())],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
