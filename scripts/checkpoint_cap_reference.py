"""Resume at 64 chains, in the JAX package and in the port.

Runs ``sample()`` of both packages on the CPU (float64) on the 10-d
funnel, 64 chains, 24 tuning draws in chunks of 4, seed 3: once
uninterrupted to 24 + 8 draws, once to 24 + 4 with ``checkpoint=``, and
once resumed from that checkpoint to 24 + 8.  The fleet's tree-depth cap
is measured on the warmup chunks and frozen at draw 22; the JAX
package's checkpoint leaves it out, so its resumed run starts again from
the initial cap.  Prints, for each package, the cap in force at the resume
point (the port's checkpoint holds it), the largest tree depth and the
leapfrogs of the 8 draws after it in the uninterrupted and the resumed
run, and whether the two runs' draws are bitwise equal.

    JAX_PLATFORMS=cpu python scripts/checkpoint_cap_reference.py
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

RUN = dict(chains=64, tune=24, seed=3, chunk_size=4, progress_bar=False,
           return_raw_trace=True)
CUT, DRAWS = 28, 8


def _runs(sample, model, tmp: str, **kwargs):
    path = os.path.join(tmp, "state.npz")
    full = sample(model, draws=DRAWS, **RUN, **kwargs)
    sample(model, draws=CUT - RUN["tune"], checkpoint=path, **RUN, **kwargs)
    resumed = sample(model, draws=DRAWS, resume_from=path, **RUN, **kwargs)
    with np.load(path) as data:
        cap = json.loads(str(data["__manifest__"])).get("depth_cap") \
            if "__manifest__" in data else None
    return full, resumed, cap


def _report(package: str, full: dict, resumed: dict, cap) -> None:
    depth, steps = full["stats"]["depth"][:, CUT:], full["stats"]["n_steps"][:, CUT:]
    print(f"{package:>6}: cap in the checkpoint {cap}; uninterrupted: max depth "
          f"{depth.max()}, leapfrogs {int(steps.sum())}; resumed: max depth "
          f"{resumed['stats']['depth'].max()}, leapfrogs "
          f"{int(resumed['stats']['n_steps'].sum())}; bitwise equal: "
          f"{np.array_equal(resumed['position'], full['position'][:, CUT:])}")


def main() -> None:
    import torch

    import nutpie_tpu
    import nutpie_tpu.models as jm
    import nutpie_tpu_torch
    import nutpie_tpu_torch.models as tm
    from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
    from nutpie_tpu_torch.frontends.pyfunc import compile_model_def

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        _report("jax", *_runs(nutpie_tpu.sample, jax_compile(jm.funnel()), tmp))
    with tempfile.TemporaryDirectory() as tmp:
        _report("port", *_runs(nutpie_tpu_torch.sample, compile_model_def(tm.funnel()), tmp,
                               device="cpu"))


if __name__ == "__main__":
    main()
