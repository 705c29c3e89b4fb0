"""The port's on-device diagnostics against ``nutpie_tpu/diagnostics_device.py``.

``ess_bulk``, ``rhat`` and ``min_ess_over_columns`` on seeded float64
series, to rtol 1e-10: Gaussian draws, autocorrelated ones, integer-valued
ones (ties, which take average ranks), and series with a NaN and with
infinities (the JAX module ranks a non-finite value as the largest and so
returns a number for it).  The port runs on
the CPU here; on the card it runs where the draws are.
"""

import numpy as np
import pytest
import torch

from nutpie_tpu import diagnostics_device as jdd
from nutpie_tpu_torch import diagnostics_device as tdd

torch.set_num_threads(1)


def _series(kind: str, rng) -> np.ndarray:
    x = rng.normal(size=(4, 101))
    if kind == "ar1":
        for t in range(1, x.shape[1]):
            x[:, t] += 0.8 * x[:, t - 1]
    elif kind == "ties":
        x = np.round(2 * x)
    elif kind == "nan":
        x[1, 5] = np.nan
    elif kind == "inf":
        x[0, 3], x[2, 40], x[3, 7] = np.inf, np.inf, -np.inf
    return x


@pytest.mark.parametrize("kind", ["normal", "ar1", "ties", "nan", "inf"])
def test_ess_bulk_and_rhat_match_jax(kind):
    x = _series(kind, np.random.default_rng(3))
    for name in ("ess_bulk", "rhat"):
        ref = float(getattr(jdd, name)(x))
        got = float(getattr(tdd, name)(torch.as_tensor(x)))
        np.testing.assert_allclose(got, ref, rtol=1e-10, err_msg=name)


def test_min_ess_over_columns_matches_jax():
    rng = np.random.default_rng(5)
    draws = rng.normal(size=(6, 80, 40))
    draws[:, :, 3] = np.round(draws[:, :, 3])
    draws[:, 1:, 7] = 0.95 * draws[:, :-1, 7] + 0.1 * draws[:, 1:, 7]
    cols = np.arange(0, 40, 2)
    for max_cols in (32, 4):
        ref = float(jdd.min_ess_over_columns(draws, cols, max_cols=max_cols))
        got = float(tdd.min_ess_over_columns(torch.as_tensor(draws), cols, max_cols=max_cols))
        np.testing.assert_allclose(got, ref, rtol=1e-10)
