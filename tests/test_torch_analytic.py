"""The port's analytic models against the JAX package's, on the CPU.

Every model's batched log density and autograd gradient at seeded numpy
points in float64 against the JAX model's ``logp_and_grad``, vmapped over
the same points: rtol 1e-12 (both are float64 and differ only in the
order of a few sums), except ``logistic_glm`` at rtol 1e-5, whose product
is float32 in both packages, summed in another order.  Also the expand
outputs and metadata of the models that have them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu_torch.models as tm

torch.set_num_threads(1)

N_POINTS = 6

# (constructor name, kwargs, rtol)
MODELS = [
    ("std_normal", dict(dim=5, mu=0.3, sigma=1.7), 1e-12),
    ("funnel", dict(dim=6), 1e-12),
    ("student_t_funnel", dict(dim=7), 1e-12),
    ("hierarchical_funnel", dict(groups=3, dim=4), 1e-12),
    ("ill_conditioned_gaussian", dict(dim=40), 1e-12),
    ("ill_conditioned_gaussian", dict(dim=12, correlate=False), 1e-12),
    ("eight_schools", dict(), 1e-12),
    ("eight_schools", dict(centered=True), 1e-12),
    ("logistic_glm", dict(n_data=256, dim=16), 1e-5),
]


def _points(ndim, seed=0):
    return np.random.default_rng(seed).standard_normal((N_POINTS, ndim))


@pytest.mark.parametrize("name,kwargs,rtol", MODELS,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MODELS)])
def test_logp_and_grad_match_jax(name, kwargs, rtol):
    jmodel = getattr(jm, name)(**kwargs)
    tmodel = getattr(tm, name)(**kwargs)
    assert tmodel.ndim == jmodel.ndim
    x = _points(jmodel.ndim)
    jl, jg = jax.vmap(jmodel.logp_and_grad)(jnp.asarray(x))
    tl, tg = tmodel.logp_and_grad(torch.tensor(x))
    assert tl.dtype == torch.float64 and tg.shape == x.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol)
    # a gradient coordinate near zero carries the rounding of its larger
    # terms, so its tolerance is relative to the gradient's scale
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("name,kwargs", [
    ("eight_schools", dict()),
    ("eight_schools", dict(centered=True)),
    ("hierarchical_funnel", dict(groups=3, dim=4)),
    ("funnel", dict(dim=5)),
])
def test_expand_and_metadata_match_jax(name, kwargs):
    jmodel = getattr(jm, name)(**kwargs)
    tmodel = getattr(tm, name)(**kwargs)
    x = _points(jmodel.ndim, seed=1)
    jout = jax.vmap(jmodel.expand_fn)(jnp.asarray(x))
    tout = tmodel.expand_fn(torch.tensor(x))
    assert set(tout) == set(jout)
    for key, ref in jout.items():
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(ref), rtol=1e-14, err_msg=key)
    for attr in ("expanded_variables", "param_variables"):
        got = [(v.name, v.shape, tuple(v.dims or ()), v.start_idx, v.end_idx)
               for v in getattr(tmodel, attr)]
        ref = [(v.name, v.shape, tuple(v.dims or ()), v.start_idx, v.end_idx)
               for v in getattr(jmodel, attr)]
        assert got == ref, attr
    assert tmodel.coords == jmodel.coords
    assert tuple(tmodel.reparameterized_names) == tuple(jmodel.reparameterized_names)
    assert tmodel.unconstrained_labels == jmodel.unconstrained_labels


def test_glm_data_and_dtype():
    """The GLM's data are the JAX model's seed-0 draws, its product float32
    in a float64 run, and its data tensors are built once per device."""
    jmodel = jm.logistic_glm(n_data=128, dim=8)
    tmodel = tm.logistic_glm(n_data=128, dim=8)
    x = _points(8, seed=2)
    for dtype in (torch.float64, torch.float32):
        lp, g = tmodel.logp_and_grad(torch.tensor(x, dtype=dtype))
        assert lp.dtype == dtype and g.dtype == dtype
    jl = jax.vmap(jmodel.logp_fn)(jnp.asarray(x, jnp.float32))
    tl = tmodel.logp_fn(torch.tensor(x, dtype=torch.float32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    # a float64 point differs from its float32 rounding only in the prior term
    lp64 = tmodel.logp_fn(torch.tensor(x))
    lp32 = tmodel.logp_fn(torch.tensor(x).float().double())
    prior = lambda b: -0.5 * (b * b).sum(1)
    np.testing.assert_allclose((lp64 - lp32).numpy(),
                               (prior(torch.tensor(x)) - prior(torch.tensor(x).float().double())).numpy(),
                               atol=1e-12)
