"""The port's normalizing flows against ``nutpie_tpu/transforms/flow.py``.

Every function of the flow module, for each architecture (the default;
Householder reflections with the tail layer; coupling tails; DCT sandwiches
with the factored conditioner; the extension layers), on the same seeded
inputs in both packages, float64 on the CPU: the initial parameters
(the normal draws to a few ULP), the transforms, the score pullback and the Fisher distance at
rtol 1e-12, the diagonal refit and ten steps of training at rtol 1e-8, the
extension masks exactly, and one chunk-boundary update of three chains at
rtol 1e-8.  The JAX functions act on one chain and are vmapped over the
chains; the port's are batched over them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nutpie_tpu.models as jm
import nutpie_tpu.transforms.flow as jf
import nutpie_tpu_torch.models as tm
import nutpie_tpu_torch.transforms.flow as tf
from nutpie_tpu_torch.ops import threefry

torch.set_num_threads(1)

DIM, C = 6, 3
ARCHS = {
    "default": dict(num_layers=2, hidden=8),
    "householder_tails": dict(num_layers=2, hidden=8, householder=1, tails=True),
    "coupling_tails": dict(num_layers=2, hidden=8, coupling_tails=True),
    "dct_factored": dict(num_layers=3, hidden=8, dct=True, factor_rank=2),
    "extension": dict(num_layers=4, hidden=8, extension_share=0.5),
}


def _configs(arch, **extra):
    kw = dict(ARCHS[arch], **extra)
    return jf.FlowConfig(**kw), tf.FlowConfig(**kw)


def _keys(seed=7):
    base = threefry.key(seed)
    return threefry.fold_in_data(base, torch.arange(C, dtype=torch.int64))


def _to_jax(params: tf.FlowParams) -> jf.FlowParams:
    return jf.FlowParams(*(jnp.asarray(t.numpy()) for t in params))


def _perturbed(cfg, seed=3):
    """Seeded non-identity parameters: couplings that act, a moved diagonal
    and tail layer."""
    params = tf.init_flow_params(cfg, DIM, _keys(), torch.float64)
    rng = np.random.default_rng(seed)
    t = lambda like, scale: torch.as_tensor(scale * rng.standard_normal(like.shape))
    return params._replace(
        mu=t(params.mu, 0.3), log_sigma=t(params.log_sigma, 0.2), w2=t(params.w2, 0.2),
        b2=t(params.b2, 0.1), b1=t(params.b1, 0.1),
        tail_s=t(params.tail_s, 0.1) if cfg.tails else params.tail_s,
        tail_log_t=t(params.tail_log_t, 0.1) if cfg.tails else params.tail_log_t,
    )


def _rows(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _close(got, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_flow_params(arch):
    """Every leaf bitwise but the normal draws, which agree to a few ULP:
    their bits and uniforms are exact, and ``threefry.normal``'s erfinv
    follows XLA's expansion, which the host's ``log1p`` may round
    differently."""
    jcfg, cfg = _configs(arch)
    port = tf.init_flow_params(cfg, DIM, _keys(), torch.float64)
    ref = jax.vmap(lambda k: jf.init_flow_params(jcfg, DIM, jax.random.wrap_key_data(k),
                                                 jnp.float64))(
        jnp.asarray(_keys().numpy().astype(np.uint32)))
    for name, got, want in zip(tf.FlowParams._fields, port, ref):
        if name in ("w1", "w1u", "w1v", "hh_v"):
            _close(got, want, 1e-14)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_transforms_and_score(arch):
    """forward, inverse, the pulled-back log density with its gradient,
    pullback_score and fisher_distance, one row and a window of rows a
    chain, at rtol 1e-12."""
    jcfg, cfg = _configs(arch)
    params = _perturbed(cfg)
    jp = _to_jax(params)
    z = _rows(1, C, DIM)
    zs = _rows(2, C, 5, DIM)
    x, ld = tf.flow_forward(cfg, params, torch.as_tensor(z))
    jx, jld = jax.vmap(lambda p, zz: jf.flow_forward(jcfg, p, zz))(jp, jnp.asarray(z))
    _close(x, jx, 1e-12)
    _close(ld, jld, 1e-12)
    xw, ldw = tf.flow_forward(cfg, params, torch.as_tensor(zs))
    jxw, jldw = jax.vmap(jax.vmap(lambda p, zz: jf.flow_forward(jcfg, p, zz),
                                  in_axes=(None, 0)))(jp, jnp.asarray(zs))
    _close(xw, jxw, 1e-12)
    _close(ldw, jldw, 1e-12)
    back = tf.flow_inverse(cfg, params, xw)
    jback = jax.vmap(jax.vmap(lambda p, xx: jf.flow_inverse(jcfg, p, xx),
                              in_axes=(None, 0)))(jp, jxw)
    _close(back, jback, 1e-12)
    _close(back, zs, 1e-9)

    jmodel, model = jm.funnel(dim=DIM - 1, scale=1.0), tm.funnel(dim=DIM - 1, scale=1.0)
    lp, g = tf.flow_logp_and_grad(cfg, model.logp_and_grad, params, torch.as_tensor(z))
    jflow_logp = jf.make_flow_logp(jcfg, jmodel.logp_fn)
    jlp, jg = jax.vmap(lambda p, zz: jax.value_and_grad(jflow_logp)(zz, p))(jp, jnp.asarray(z))
    _close(lp, jlp, 1e-12)
    _close(g, jg, 1e-12)

    gx = _rows(4, C, DIM)
    zp, score = tf.pullback_score(cfg, params, x, torch.as_tensor(gx))
    jz, jscore = jax.vmap(lambda p, xx, gg: jf.pullback_score(jcfg, p, xx, gg))(
        jp, jx, jnp.asarray(gx))
    _close(zp, jz, 1e-12)
    _close(score, jscore, 1e-12)
    _close(tf.fisher_distance(zp, score), jax.vmap(jf.fisher_distance)(jz, jscore), 1e-12)


def _window(seed, W, n_valid):
    xs = _rows(seed, C, W, DIM)
    gs = -xs * np.exp(0.3 * _rows(seed + 1, C, 1, DIM)) + 0.1 * _rows(seed + 2, C, W, DIM)
    valid = np.arange(W)[None, :] < np.array(n_valid)[:, None]
    return xs, gs, valid


@pytest.mark.parametrize("arch", ["default", "coupling_tails", "dct_factored"])
def test_refit_diag_and_train_flow(arch):
    """The diagonal refit and ten Adam steps (window 64, some rows invalid)
    at rtol 1e-8; the loss, the best parameters and the improvement flag."""
    jcfg, cfg = _configs(arch, train_steps=10, window=64)
    params = _perturbed(cfg)
    jp = _to_jax(params)
    xs, gs, valid = _window(10, 64, [64, 40, 9])
    t = lambda a: torch.as_tensor(a)
    diag = tf.refit_diag(params, t(xs), t(gs), t(valid))
    jdiag = jax.vmap(jf.refit_diag)(jp, jnp.asarray(xs), jnp.asarray(gs), jnp.asarray(valid))
    _close(diag.mu, jdiag.mu, 1e-8)
    _close(diag.log_sigma, jdiag.log_sigma, 1e-8)

    best, loss, improved = tf.train_flow(cfg, params, t(xs), t(gs), t(valid))
    jbest, jloss, jimproved = jax.vmap(
        lambda p, a, b, c: jf.train_flow(jcfg, p, a, b, c))(
        jp, jnp.asarray(xs), jnp.asarray(gs), jnp.asarray(valid))
    np.testing.assert_array_equal(improved.numpy(), np.asarray(jimproved))
    _close(loss, jloss, 1e-8)
    for name, got, want in zip(tf.FlowParams._fields, best, jbest):
        _close(got, want, 1e-8, 1e-12)


def test_train_flow_lr_decay():
    jcfg, cfg = _configs("default", train_steps=10, window=64, lr_decay=True)
    params = _perturbed(cfg)
    xs, gs, valid = _window(20, 64, [64, 64, 33])
    t = lambda a: torch.as_tensor(a)
    best, loss, _ = tf.train_flow(cfg, params, t(xs), t(gs), t(valid))
    jbest, jloss, _ = jax.vmap(lambda p, a, b, c: jf.train_flow(jcfg, p, a, b, c))(
        _to_jax(params), jnp.asarray(xs), jnp.asarray(gs), jnp.asarray(valid))
    _close(loss, jloss, 1e-8)
    _close(best.w2, jbest.w2, 1e-8, 1e-12)


def test_retarget_extension_masks_exact():
    jcfg, cfg = _configs("extension")
    params = tf.init_flow_params(cfg, DIM, _keys(), torch.float64)
    # chain 2's extension layers already act: its masks stay
    w2 = params.w2.clone()
    w2[2, -1, 0, 0] = 0.5
    params = params._replace(w2=w2)
    xs, gs, valid = _window(30, 16, [16, 7, 16])
    allowed = torch.tensor([True, True, True])
    got = tf.retarget_extension_masks(cfg, params, allowed=allowed, win_draws=torch.as_tensor(xs),
                                      win_grads=torch.as_tensor(gs),
                                      valid=torch.as_tensor(valid))
    ref = jax.vmap(lambda p, a, d, g, v: jf.retarget_extension_masks(
        jcfg, p, allowed=a, win_draws=d, win_grads=g, valid=v))(
        _to_jax(params), jnp.asarray(allowed.numpy()), jnp.asarray(xs), jnp.asarray(gs),
        jnp.asarray(valid))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(ref.masks))
    assert not np.array_equal(got.masks[0].numpy(), params.masks[0].numpy())
    np.testing.assert_array_equal(got.masks[2].numpy(), params.masks[2].numpy())


@pytest.mark.parametrize("arch,updates", [("default", 0), ("default", 3), ("extension", 3)])
def test_chunk_flow_update(arch, updates):
    """One chunk boundary of three chains (a diagonal refit, or training
    with the extension retarget), the window roll, the re-base and the
    model-space conversion at rtol 1e-8; flow_updates and the window's
    validity exact."""
    jcfg, cfg = _configs(arch, train_steps=10, window=48, num_diag_updates=3)
    jmodel, model = jm.funnel(dim=DIM - 1, scale=1.0), tm.funnel(dim=DIM - 1, scale=1.0)
    params = _perturbed(cfg) if updates else tf.init_flow_params(cfg, DIM, _keys(),
                                                                  torch.float64)
    if arch == "extension":  # the extension layers are identities until retargeted
        params = params._replace(w2=params.w2.clone())
        params.w2[:, 2:] = 0.0
    jp = _to_jax(params)
    old = _window(40, 48, [20, 0, 48])
    rows, rows_ok = _rows(50, C, 16, DIM), np.ones((C, 16), bool)
    rows_ok[1, 3] = False
    grads = -rows + 0.05 * _rows(51, C, 16, DIM)
    position, gradient = _rows(52, C, DIM), _rows(53, C, DIM)
    logp = _rows(54, C)
    t = torch.as_tensor
    win = tf.FlowWindow(params, torch.full((C,), updates, dtype=torch.int32), t(old[0]),
                        t(old[1]), t(old[2]))
    new, pos, grad, lp = tf.chunk_flow_update(cfg, model.logp_and_grad, win, t(position),
                                              t(gradient), t(logp), t(rows), t(grads),
                                              t(rows_ok), True)
    jwin = jf.FlowWindow(jp, jnp.full((C,), updates, jnp.int32), jnp.asarray(old[0]),
                         jnp.asarray(old[1]), jnp.asarray(old[2]))
    jnew, jpos, jgrad, jlp = jax.vmap(
        lambda w, p, g, l, bp, bg, ok: jf.chunk_flow_update(
            jcfg, jmodel.logp_fn, w, p, g, l, bp, bg, ok, in_warmup=jnp.asarray(True)))(
        jwin, jnp.asarray(position), jnp.asarray(gradient), jnp.asarray(logp),
        jnp.asarray(rows), jnp.asarray(grads), jnp.asarray(rows_ok))
    np.testing.assert_array_equal(new.flow_updates.numpy(), np.asarray(jnew.flow_updates))
    np.testing.assert_array_equal(new.win_valid.numpy(), np.asarray(jnew.win_valid))
    _close(new.win_draws, jnew.win_draws, 0)
    for name, got, want in zip(tf.FlowParams._fields, new.flow, jnew.flow):
        _close(got, want, 1e-8, 1e-12)
    for got, want in ((pos, jpos), (grad, jgrad), (lp, jlp)):
        _close(got, want, 1e-8, 1e-12)

    L = 16
    xs, lds, gxs = tf.chunk_to_model_space(cfg, new.flow, t(rows), t(grads))
    jxs, jlds, jgxs = jax.vmap(lambda f, p, g: jf.chunk_to_model_space(jcfg, f, p, g))(
        jnew.flow, jnp.asarray(rows), jnp.asarray(grads))
    assert xs.shape == (C, L, DIM)
    for got, want in ((xs, jxs), (lds, jlds), (gxs, jgxs)):
        _close(got, want, 1e-8, 1e-12)


def test_chunk_flow_update_outside_warmup_only_rolls():
    _, cfg = _configs("default", window=32)
    params = _perturbed(cfg)
    xs, gs, valid = _window(60, 32, [32, 32, 32])
    win = tf.FlowWindow(params, torch.zeros((C,), dtype=torch.int32), torch.as_tensor(xs),
                        torch.as_tensor(gs), torch.as_tensor(valid))
    rows = torch.as_tensor(_rows(61, C, 4, DIM))
    pos = torch.as_tensor(_rows(62, C, DIM))
    new, p, _, _ = tf.chunk_flow_update(cfg, tm.funnel(DIM - 1).logp_and_grad, win, pos, pos,
                                        pos[:, 0], rows, rows, torch.ones((C, 4), dtype=bool),
                                        False)
    assert new.flow is params and p is pos
    np.testing.assert_array_equal(new.win_draws[:, -4:].numpy(), rows.numpy())
