"""The torch port's model layer against the JAX package: radon data, logp,
gradient, expansion, init jitter, and the pyfunc frontend.

Tolerances: logp and gradient agree to rtol 1e-12 with an absolute floor
of 1e-12 times the gradient's largest entry (summation order differs; the
radon gradient sums ~900 residuals, so entries near zero carry absolute,
not relative, rounding).  Against the one-hot JAX form, whose county
lookups are matmuls, to rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu.models import radon as jax_radon
from nutpie_tpu.models.radon import _zero_sum_basis as jax_basis
from nutpie_tpu.models.radon import simulate_radon_data as jax_simulate
from nutpie_tpu_torch.frontends.pyfunc import compile_model_def, from_pyfunc
from nutpie_tpu_torch.models import radon
from nutpie_tpu_torch.models.radon import _zero_sum_basis, simulate_radon_data

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return radon(), jax_radon(), jax_radon(gather="onehot")


def _points(ndim, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [0.3 * rng.standard_normal(ndim) for _ in range(n)]


def test_radon_data_identical():
    for seed in (42, 7):
        for a, b in zip(simulate_radon_data(seed), jax_simulate(seed)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(_zero_sum_basis(85), jax_basis(85))


def test_kernel_data_pack():
    y, cidx, floor, _ = simulate_radon_data(42)
    km = radon().kernel_model
    order = np.argsort(cidx, kind="stable")
    np.testing.assert_array_equal(km.y, y[order])
    np.testing.assert_array_equal(km.floor, floor[order])
    np.testing.assert_array_equal(np.diff(km.offsets), np.bincount(cidx, minlength=85))
    assert km.offsets[0] == 0 and km.offsets[-1] == km.n_obs == 919
    assert km.basis.shape == (85, 84) and km.n_counties == 85


@pytest.mark.parametrize("form", ["autograd", "analytic"])
def test_radon_logp_and_grad_match_jax(models, form):
    mt, mj, moh = models
    assert mt.ndim == mj.ndim == 173
    for q in _points(mt.ndim):
        x = torch.as_tensor(q[None], dtype=torch.float64)
        if form == "analytic":
            lp, g = mt.logp_and_grad(x)
        else:
            with torch.enable_grad():
                xg = x.clone().requires_grad_(True)
                lp = mt.logp_fn(xg)
                (g,) = torch.autograd.grad(lp.sum(), xg)
        lj, gj = mj.logp_and_grad(jnp.asarray(q))
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        np.testing.assert_allclose(lp.item(), float(lj), rtol=1e-12)
        np.testing.assert_allclose(g[0].detach().numpy(), gj, rtol=1e-12, atol=1e-12 * scale)
        lo, go = moh.logp_and_grad(jnp.asarray(q))
        np.testing.assert_allclose(lp.item(), float(lo), rtol=1e-9)
        np.testing.assert_allclose(g[0].detach().numpy(), np.asarray(go), rtol=1e-9,
                                   atol=1e-9 * scale)


def test_radon_batched_expand_and_metadata(models):
    mt, mj, _ = models
    qs = np.stack(_points(mt.ndim, 3, seed=1))
    out = mt.expand_fn(torch.as_tensor(qs))
    for i, q in enumerate(qs):
        ref = mj.expand_fn(jnp.asarray(q))
        assert out.keys() == ref.keys()
        for name, v in ref.items():
            np.testing.assert_allclose(out[name][i].numpy(), np.asarray(v), rtol=1e-12,
                                       atol=1e-14)
    assert [v.name for v in mt.expanded_variables] == [v.name for v in mj.expanded_variables]
    assert [v.shape for v in mt.expanded_variables] == [v.shape for v in mj.expanded_variables]
    assert mt.unconstrained_labels == mj.unconstrained_labels
    assert mt.coords == mj.coords


def test_initial_position_matches_jax(models):
    mt, mj, _ = models
    from nutpie_tpu_torch.sampler.run import chain_keys

    keys = chain_keys(3, 4, "cpu")
    mean = np.linspace(-1, 1, mt.ndim)
    got = mt.initial_position(keys, torch.as_tensor(mean))
    for c in range(4):
        k = jax.random.fold_in(jax.random.key(3), c)
        ref = mj.initial_position(k, jnp.asarray(mean))
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(ref))


def test_pyfunc_frontend_with_torch_callables():
    def make_logp(scale):
        s = torch.as_tensor(scale)

        def logp(x):
            return -0.5 * torch.sum((x / s.to(x.dtype)) ** 2, dim=1)

        return logp

    def make_expand(scale):
        def expand(x):
            return {"x2": 2.0 * x}

        return expand

    compiled = from_pyfunc(
        3, make_logp, make_expand, [np.float64], [(3,)], ["x2"],
        shared_data={"scale": np.array([1.0, 2.0, 3.0])},
    )
    model = compiled._make_model(0)
    x = torch.tensor([[1.0, 2.0, 3.0], [0.0, -2.0, 6.0]], dtype=torch.float64)
    lp, g = model.logp_and_grad(x)
    np.testing.assert_allclose(lp.numpy(), [-1.5, -2.5])
    np.testing.assert_allclose(g.numpy(), -x.numpy() / np.array([1.0, 4.0, 9.0]))
    assert compiled.shapes == {"x2": (3,)}
    swapped = compiled.with_data(scale=np.array([1.0, 1.0, 1.0]))
    lp2, _ = swapped._make_model(0).logp_and_grad(x)
    np.testing.assert_allclose(lp2.numpy(), [-7.0, -20.0])
    wrapped = compile_model_def(model)
    assert wrapped.n_dim == 3 and wrapped._make_model(1) is model
