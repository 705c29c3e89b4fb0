"""The step size Adam adapts on radon, in the JAX package and in the port.

Runs ``sample()`` of both packages on the CPU (float64) on radon with
``step_size_adapt_method="adam"`` and, for comparison, dual averaging:
8 chains x (300 tune + 20 draws), maxdepth 6 (to bound the CPU time of
small steps), seed 42, with and without pooling of the step size and mass
matrix.  Prints, for each run, the median step size over the chains at
tuning draws 0, 5, 10, 20, 50, 100, 150, 200, 250 and 299, and the
median posterior step size.  Both packages take the same course: under
Adam the matched step-size shift that follows each growth of the mass
matrix outpaces Adam's capped per-draw rise, and the step collapses by
three to four orders of magnitude during warmup.

    JAX_PLATFORMS=cpu python scripts/adam_radon_reference.py [--port]

``--port`` adds the port's runs (its plain version on the CPU; several
minutes).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

DRAWS_SHOWN = (0, 5, 10, 20, 50, 100, 150, 200, 250, 299)
RUN = dict(chains=8, tune=300, draws=20, seed=42, maxdepth=6, return_raw_trace=True)


def _report(package: str, method: str, pool: bool, raw: dict, seconds: float) -> None:
    eps = raw["stats"]["step_size"]
    tune = RUN["tune"]
    print(f"{package:>6} {method:>12} pooled={pool!s:5} {seconds:7.1f} s  tuning:",
          " ".join(f"{np.median(eps[:, i]):.3g}" for i in DRAWS_SHOWN),
          f" posterior: {np.median(eps[:, tune:]):.4g}", flush=True)


def main() -> None:
    import nutpie_tpu
    from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
    from nutpie_tpu.models import radon as jax_radon

    packages = [("jax", lambda kw: nutpie_tpu.sample(jax_compile(jax_radon()),
                                                     progress_bar=False, **kw))]
    if "--port" in sys.argv:
        import torch

        import nutpie_tpu_torch
        from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
        from nutpie_tpu_torch.models import radon

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        packages.append(("port", lambda kw: nutpie_tpu_torch.sample(
            compile_model_def(radon()), device="cpu", **kw)))
    for package, sample in packages:
        for method in ("adam", "dual_average"):
            for pool in (True, False):
                t0 = time.perf_counter()
                raw = sample(dict(RUN, step_size_adapt_method=method,
                                  pool_step_size=pool, pool_mass_matrix=pool))
                _report(package, method, pool, raw, time.perf_counter() - t0)


if __name__ == "__main__":
    main()
