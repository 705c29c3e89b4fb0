"""MCLMC on the logistic GLM of ``bench_glm.py``, in the JAX package and in
the port, on the CPU (float64).

Runs ``sample(sampler="mclmc")`` of both packages on the GLM (2048
observations, 64 coefficients, ``bench_glm.py``'s data) with 64 chains,
seed 42, chunk 32, at the tuning lengths given (default 300 and 1200) and
300 posterior draws, and prints for each run the max split R-hat over
``bench_glm.py``'s monitored columns, the largest deviation of a posterior
mean from the Laplace mode and from the importance-sampled mean in
posterior sd (chip_smoke's ``laplace`` and ``importance_mean``), the
median final step size and the posterior divergences.  The two packages
draw the same numbers from one seed, so their readings agree to rounding;
what they show is how many tuning draws one step a draw needs on this
posterior.

    JAX_PLATFORMS=cpu python scripts/mclmc_glm_reference.py [TUNE ...] [--port]
        [--chains N]

``--port`` adds the port's runs (its plain version on the CPU);
``--chains`` sets the chain count (default 64).
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

CHAINS, DRAWS, CHUNK, SEED = 64, 300, 32, 42


def _readings(raw: dict, tune: int) -> str:
    import chip_smoke as cs
    from nutpie_tpu_torch.models.analytic import glm_data

    cs.DEVICE = "cpu"  # its diagnostics run where the draws are

    post = np.asarray(raw["position"])[:, tune:]
    _, rhat = cs.column_diagnostics(post, cs.GLM_MONITORED)
    X, y = glm_data(cs.GLM_N_DATA, cs.GLM_DIM)
    mode, cov = cs.laplace(X, y)
    sd = np.sqrt(np.diag(cov))
    mean = post.reshape(-1, cs.GLM_DIM).mean(axis=0)
    is_mean, _ = cs.importance_mean(X, y, mode, cov)
    return (f"max R-hat {max(rhat):.4f}  mean vs mode {np.max(np.abs(mean - mode) / sd):.3f} sd"
            f"  vs importance mean {np.max(np.abs(mean - is_mean) / sd):.3f} sd"
            f"  final step {np.median(np.asarray(raw['stats']['step_size'])[:, -1]):.4g}"
            f"  posterior divergences {int(np.asarray(raw['stats']['diverging'])[:, tune:].sum())}")


def main() -> None:
    import nutpie_tpu
    from nutpie_tpu.frontends.pyfunc import compile_model_def as jax_compile
    from nutpie_tpu.models import logistic_glm as jax_glm

    args = sys.argv[1:]
    chains = CHAINS
    if "--chains" in args:
        at = args.index("--chains")
        chains = int(args[at + 1])
        del args[at:at + 2]
    tunes = [int(a) for a in args if a.isdigit()] or [300, 1200]
    packages = [("jax", lambda kw: nutpie_tpu.sample(
        jax_compile(jax_glm(n_data=2048, dim=64)), progress_bar=False, **kw))]
    if "--port" in sys.argv:
        import torch

        import nutpie_tpu_torch
        from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
        from nutpie_tpu_torch.models import logistic_glm

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        packages.append(("port", lambda kw: nutpie_tpu_torch.sample(
            compile_model_def(logistic_glm(n_data=2048, dim=64)), device="cpu",
            progress_bar=False, **kw)))
    for tune in tunes:
        for name, run in packages:
            t0 = time.perf_counter()
            raw = run(dict(sampler="mclmc", chains=chains, tune=tune, draws=DRAWS, seed=SEED,
                           chunk_size=CHUNK, return_raw_trace=True))
            print(f"{name:>4} {chains} chains, tune {tune:5d} ({time.perf_counter() - t0:6.1f} s): "
                  f"{_readings(raw, tune)}", flush=True)


if __name__ == "__main__":
    main()
