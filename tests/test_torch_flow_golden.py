"""The golden case ``flow_funnel`` of ``tests/test_golden.py`` on the port.

``funnel(dim=4)`` under flow adaptation, 2 chains x (400 + 150), seed
2026, the JAX package's default flow, on the CPU in float64: the port's
chains differ from the JAX package's (its normals agree to a few ULP and
every warmup amplifies rounding), so the posterior of ``v`` is held to the
committed JAX draws ``tests/reference/flow_funnel.npy`` in distribution:
its mean and standard deviation within 5 Monte Carlo standard errors (the
MCSE from each trace's own effective sample size, combined).  The file is
only read.
"""

from pathlib import Path

import numpy as np
import torch

import nutpie_tpu_torch
from nutpie_tpu_torch.diagnostics import ess
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def
from nutpie_tpu_torch.models import funnel

torch.set_num_threads(1)

REFERENCE = Path(__file__).parent / "reference" / "flow_funnel.npy"


def _mcse(draws: np.ndarray):
    """MCSEs of the mean and of the standard deviation of ``[chains, draws]``."""
    n_eff = max(float(ess(draws)), 2.0)
    sd = float(draws.std())
    return sd / np.sqrt(n_eff), sd / np.sqrt(2.0 * (n_eff - 1.0))


def test_flow_funnel_golden_moments():
    trace = nutpie_tpu_torch.sample(
        compile_model_def(funnel(dim=4)), chains=2, draws=150, tune=400, seed=2026,
        adaptation="flow", device="cpu", progress_bar=False)
    got = np.asarray(trace.posterior["v"].values)
    ref = np.load(REFERENCE)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    (m1, s1), (m2, s2) = _mcse(got), _mcse(ref)
    assert abs(got.mean() - ref.mean()) < 5.0 * np.hypot(m1, m2), (got.mean(), ref.mean())
    assert abs(got.std() - ref.std()) < 5.0 * np.hypot(s1, s2), (got.std(), ref.std())
