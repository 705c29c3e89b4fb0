"""Wall of radon's main path through ``sample()``, for an A/B of two trees.

Runs radon at chip_smoke's main configuration (2048 chains x (300 tune +
300 draws), pooled, seed 42, float32 through K1) three times in one
process on the card and prints the host wall of each (the first pays the
process's first-run costs).  In a tree whose ``sample()`` runs the
background loop, the first run goes through ``blocking=False`` and
prints its pinned buffers' bytes and allocation seconds.  Compare two
trees in one chip call, in turns: unpack the other tree with ``git
archive`` into ``_chip/parent`` (gitignored) and run

    for t in _chip/parent . . _chip/parent; do python3 scripts/torch_main_ab.py $t; done
"""

import json
import os
import sys
import time


def main(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import nutpie_tpu_torch as nt
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
    from nutpie_tpu_torch.sampler.megakernel import chunk_kernel

    chunk_kernel.library()  # build or load outside the timed runs
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    compiled = compile_model_def(nt.models.radon())
    kw = dict(progress_bar=False, chains=2048, tune=300, draws=300, seed=42,
              pool_mass_matrix=True, pool_step_size=True, return_raw_trace=True)
    change = hasattr(nt, "ChainProgress")
    walls, extra = [], {}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if change and i == 0:
            handle = nt.sample(compiled, blocking=False, **kw)
            handle.wait()
            extra = {"alloc_s": handle.transfer.alloc_s, "wait_s": handle.transfer.wait_s,
                     "pinned_bytes": handle.transfer.pinned_bytes}
        else:
            nt.sample(compiled, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"tree": "change" if change else "parent", "walls_s": walls, **extra}),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
