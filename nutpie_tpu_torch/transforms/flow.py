"""Normalizing flows for Fisher-HMC reparameterization adaptation, in torch.

The port of ``nutpie_tpu/transforms/flow.py``: the sampler runs in the
flow's base space z, where the pulled-back posterior is approximately
standard normal; each chain's flow trains during warmup, at chunk
boundaries, by minimizing the Fisher divergence
``log E[ || z + grad_z log p_z(z) ||^2 ]`` over a window of (draw,
gradient) pairs.  The architecture is the JAX package's: an optional
sinh-asinh tail layer and a gradient-informed diagonal affine on top of
alternating-mask affine coupling layers (optionally with sinh-asinh tails
inside, DCT sandwiches, Householder reflections and a factored first
conditioner layer).

Every field of ``FlowParams`` carries a leading chains axis ``C``, and
every function here is batched over it where the JAX package vmaps:
positions are ``[C, dim]`` or ``[C, B, dim]`` (B rows per chain, a window
or a chunk), the per-chain products are ``torch.matmul`` of ``[C, B, dim]``
by ``[C, dim, hidden]``.  Chains share no parameter, so the gradient of the
loss summed over chains is each chain's own gradient; the Adam step, its
gradient clip, the finiteness checks and the best-params tracking of
``train_flow`` act per chain through ``torch.where``, a fixed count of
steps with no host sync, in place on one carry, so that on the card one
step is captured in a CUDA graph and replayed.  Score pullbacks are one vector-Jacobian product
through the forward transform (``torch.autograd.grad``; with
``create_graph`` where training differentiates through it).

Flow direction: ``x = forward(params, z)`` maps base space to the model's
unconstrained space; the sampler's positions are z.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import graphs, threefry


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Static flow-adaptation configuration (``nutpie_tpu/transforms/flow.py:
    FlowConfig``, the same fields and defaults)."""

    num_layers: int = 5
    hidden: int = 32
    learning_rate: float = 1e-3
    train_steps: int = 400
    window: int = 600          # ring buffer of (draw, grad) training pairs
    num_diag_updates: int = 3  # first updates refit only the diagonal
    scale_cap: float = 3.0     # bound on coupling log-scales
    grad_clip: float = 10.0
    update_freq: int = 64      # flow update cadence (chunk-aligned)
    # train on one uniformly reservoir-sampled leaf per trajectory as well
    # (its position and gradient, the orbit_position/orbit_gradient chunk
    # buffers), beside the draws
    use_orbit: bool = False
    # trainable Householder reflections after each coupling
    householder: int = 0
    # elementwise sinh-asinh tail layer before the diagonal affine
    tails: bool = False
    # sinh-asinh tail transformer inside each coupling
    coupling_tails: bool = False
    # bound on |log t| and |s| in the coupling tail transformer
    tail_cap: float = 0.75
    # this share of the trailing couplings is retargeted at the worst
    # Fisher-cost coordinates when the diagonal phase ends; 0 = off
    extension_share: float = 0.0
    # every other non-extension coupling acts in orthonormal-DCT space
    dct: bool = False
    # cosine learning-rate decay (lr -> lr/10 across train_steps)
    lr_decay: bool = False
    # low-rank factored first conditioner layer ([dim, r] @ [r, hidden]); 0 = dense
    factor_rank: int = 0


def _n_extension(cfg: FlowConfig) -> int:
    return int(round(cfg.extension_share * cfg.num_layers))


def _layer_uses_dct(cfg: FlowConfig, i: int) -> bool:
    """DCT sandwiches go on odd-indexed non-extension couplings."""
    return cfg.dct and i % 2 == 1 and i < cfg.num_layers - _n_extension(cfg)


# the orthonormal DCT-II matrix by (dim, dtype, device): built once, so a
# captured log density copies no host data after its first call
_DCT: dict = {}


def _dct_matrix(dim: int, dtype, device) -> torch.Tensor:
    key = (dim, dtype, torch.device(device))
    if key not in _DCT:
        n = np.arange(dim)
        mat = np.sqrt(2.0 / dim) * np.cos(np.pi * np.outer(n, n + 0.5) / dim)
        mat[0] *= np.sqrt(0.5)
        _DCT[key] = torch.as_tensor(mat, dtype=dtype, device=device)
    return _DCT[key]


class FlowParams(NamedTuple):
    """A flow per chain; every field has a leading chains axis ``C``."""

    mu: torch.Tensor          # [C, dim]
    log_sigma: torch.Tensor   # [C, dim]
    w1: torch.Tensor          # [C, layers, dim, hidden] (empty when factored)
    w1u: torch.Tensor         # [C, layers, dim, rank]   (empty when dense)
    w1v: torch.Tensor         # [C, layers, rank, hidden]
    b1: torch.Tensor          # [C, layers, hidden]
    w2: torch.Tensor          # [C, layers, hidden, k*dim], k = _coupling_width(cfg)
    b2: torch.Tensor          # [C, layers, k*dim]
    hh_v: torch.Tensor        # [C, n_householder, dim]
    tail_s: torch.Tensor      # [C, dim]
    tail_log_t: torch.Tensor  # [C, dim]
    # coupling masks (1 = conditioned-on half); data, not trained
    masks: torch.Tensor       # [C, layers, dim]


# the fields train_flow trains (every one but the masks)
TRAINED = tuple(f for f in FlowParams._fields if f != "masks")


def _coupling_width(cfg: FlowConfig) -> int:
    return 4 if cfg.coupling_tails else 2


def init_flow_params(cfg: FlowConfig, dim: int, keys: torch.Tensor, dtype) -> FlowParams:
    """Each chain's initial flow from its key (``keys [C, 2]``): the
    couplings exact identities (zero output layer), the first conditioner
    layers from ``normal(fold_in(key, 0))`` (and ``fold_in(key, 2)`` when
    factored), the Householder vectors from ``normal(fold_in(key, 1))``:
    the JAX package's draws (their bits exact, the values to a few ULP, as
    ``threefry.normal`` gives them)."""
    C = keys.shape[0]
    device = keys.device
    zeros = lambda *shape: torch.zeros((C,) + shape, dtype=dtype, device=device)
    L, H = cfg.num_layers, cfg.hidden
    k1 = threefry.fold_in_data(keys, 0)
    r = max(cfg.factor_rank, 0)
    if r > 0:
        w1 = zeros(L, 0, H)
        w1u = 0.01 * threefry.normal(k1, (L, dim, r), dtype)
        w1v = threefry.normal(threefry.fold_in_data(keys, 2), (L, r, H), dtype) / torch.sqrt(
            torch.tensor(float(r), dtype=dtype, device=device))
    else:
        w1 = 0.01 * threefry.normal(k1, (L, dim, H), dtype)
        w1u = zeros(L, dim, 0)
        w1v = zeros(L, 0, H)
    n_hh = max(cfg.householder, 0) * L if cfg.householder else 0
    hh_v = zeros(n_hh, dim)
    if n_hh:
        hh_v = threefry.normal(threefry.fold_in_data(keys, 1), (n_hh, dim), dtype)
    base = (torch.arange(dim, device=device) % 2).to(dtype)
    masks = torch.stack([base if i % 2 == 0 else 1.0 - base for i in range(L)])
    return FlowParams(
        mu=zeros(dim), log_sigma=zeros(dim), w1=w1, w1u=w1u, w1v=w1v, b1=zeros(L, H),
        w2=zeros(L, H, _coupling_width(cfg) * dim), b2=zeros(L, _coupling_width(cfg) * dim),
        hh_v=hh_v, tail_s=zeros(dim), tail_log_t=zeros(dim),
        masks=masks.expand(C, L, dim).contiguous(),
    )


def tree_where(pred: torch.Tensor, a: FlowParams, b: FlowParams) -> FlowParams:
    """Per-chain select between two flows (``pred [C]``)."""
    sel = lambda x, y: torch.where(pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return FlowParams(*(sel(x, y) for x, y in zip(a, b)))


def _rows(z: torch.Tensor):
    """``[C, dim]`` or ``[C, B, dim]`` as ``[C, B, dim]``, and whether it was 2-D."""
    return (z[:, None, :], True) if z.dim() == 2 else (z, False)


def _householder(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reflection across the hyperplane orthogonal to v (``v [C, dim]``)."""
    vn = v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-12))
    vn = vn[:, None, :]
    return y - 2.0 * vn * torch.sum(vn * y, dim=-1, keepdim=True)


def _tail_forward(params: FlowParams, y: torch.Tensor):
    """Sinh-asinh: x = sinh(t * asinh(y) + s); identity at (s=0, t=1)."""
    log_t, s = params.tail_log_t[:, None, :], params.tail_s[:, None, :]
    t = torch.exp(log_t)
    a = torch.asinh(y)
    x = torch.sinh(t * a + s)
    logdet = torch.sum(log_t + torch.log(torch.cosh(t * a + s)) - 0.5 * torch.log1p(y * y),
                       dim=-1)
    return x, logdet


def _tail_inverse(params: FlowParams, x: torch.Tensor) -> torch.Tensor:
    t = torch.exp(params.tail_log_t[:, None, :])
    return torch.sinh((torch.asinh(x) - params.tail_s[:, None, :]) / t)


def _coupling_nets(cfg: FlowConfig, params: FlowParams, layer: int, masked: torch.Tensor):
    if cfg.factor_rank > 0:
        pre = torch.matmul(torch.matmul(masked, params.w1u[:, layer]), params.w1v[:, layer])
    else:
        pre = torch.matmul(masked, params.w1[:, layer])
    h = torch.tanh(pre + params.b1[:, layer, None, :])
    out = torch.matmul(h, params.w2[:, layer]) + params.b2[:, layer, None, :]
    dim = params.mu.shape[-1]
    shift = out[..., :dim]
    log_scale = cfg.scale_cap * torch.tanh(out[..., dim:2 * dim] / cfg.scale_cap)
    if not cfg.coupling_tails:
        return shift, log_scale, None, None
    cap = cfg.tail_cap
    t_s = cap * torch.tanh(out[..., 2 * dim:3 * dim] / cap)
    t_log_t = cap * torch.tanh(out[..., 3 * dim:] / cap)
    return shift, log_scale, t_s, t_log_t


def flow_forward(cfg: FlowConfig, params: FlowParams, z: torch.Tensor):
    """z (base) -> (x, logdet): ``[C, (B,) dim]`` -> that and ``[C, (B)]``."""
    y, single = _rows(z)
    masks = params.masks.detach()
    dct = _dct_matrix(y.shape[-1], y.dtype, y.device) if cfg.dct else None
    logdet = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    for i in range(cfg.num_layers):
        m = masks[:, i, None, :]
        sandwich = _layer_uses_dct(cfg, i)
        if sandwich:  # couple in frequency space (orthogonal: logdet 0)
            y = torch.matmul(y, dct.T)
        shift, log_scale, t_s, t_log_t = _coupling_nets(cfg, params, i, y * m)
        free = 1.0 - m
        u = y * torch.exp(log_scale) + shift
        ld = log_scale
        if cfg.coupling_tails:
            a = torch.exp(t_log_t) * torch.asinh(u) + t_s
            ld = ld + t_log_t + torch.log(torch.cosh(a)) - 0.5 * torch.log1p(u * u)
            u = torch.sinh(a)
        y = m * y + free * u
        logdet = logdet + torch.sum(free * ld, dim=-1)
        if sandwich:
            y = torch.matmul(y, dct)
        for h in range(cfg.householder):
            y = _householder(params.hh_v[:, i * cfg.householder + h], y)
    if cfg.tails:
        y, tail_ld = _tail_forward(params, y)
        logdet = logdet + tail_ld
    x = params.mu[:, None, :] + torch.exp(params.log_sigma)[:, None, :] * y
    logdet = logdet + torch.sum(params.log_sigma, dim=-1)[:, None]
    return (x[:, 0], logdet[:, 0]) if single else (x, logdet)


def flow_inverse(cfg: FlowConfig, params: FlowParams, x: torch.Tensor) -> torch.Tensor:
    """x (model space) -> z (base)."""
    y, single = _rows(x)
    masks = params.masks.detach()
    dct = _dct_matrix(y.shape[-1], y.dtype, y.device) if cfg.dct else None
    y = (y - params.mu[:, None, :]) * torch.exp(-params.log_sigma)[:, None, :]
    if cfg.tails:
        y = _tail_inverse(params, y)
    for i in reversed(range(cfg.num_layers)):
        for h in reversed(range(cfg.householder)):
            y = _householder(params.hh_v[:, i * cfg.householder + h], y)
        sandwich = _layer_uses_dct(cfg, i)
        if sandwich:
            y = torch.matmul(y, dct.T)
        m = masks[:, i, None, :]
        shift, log_scale, t_s, t_log_t = _coupling_nets(cfg, params, i, y * m)
        free = 1.0 - m
        u = y
        if cfg.coupling_tails:
            u = torch.sinh((torch.asinh(y) - t_s) * torch.exp(-t_log_t))
        y = m * y + free * ((u - shift) * torch.exp(-log_scale))
        if sandwich:
            y = torch.matmul(y, dct)
    return y[:, 0] if single else y


def flow_logp_and_grad(cfg: FlowConfig, logp_and_grad, params: FlowParams, z: torch.Tensor):
    """The pulled-back log density and its gradient in z (``make_flow_logp``
    of the JAX package under ``value_and_grad``): ``logp_z(z) = logp(F(z)) +
    logdet`` and ``J_F^T grad_x logp + grad_z logdet``, from the model's
    batched ``logp_and_grad`` at ``x = F(z)`` and one vector-Jacobian product
    through the forward transform.  No gradient reaches the flow's
    parameters."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_(True)
        x, logdet = flow_forward(cfg, params, zg)
        logp_x, grad_x = logp_and_grad(x.detach())
        (grad,) = torch.autograd.grad((x, logdet), zg,
                                      (grad_x.to(x.dtype), torch.ones_like(logdet)))
    return logp_x.to(logdet.dtype) + logdet.detach(), grad


def pulled_back(fcfg, logp_and_grad, params: FlowParams):
    """The batched log density a runner hands its kernel: the model's
    ``logp_and_grad``, or under flow adaptation (``fcfg`` not None) the
    pulled-back one under the flows ``params``."""
    if fcfg is None:
        return logp_and_grad
    return lambda z: flow_logp_and_grad(fcfg, logp_and_grad, params, z)


def _score(cfg: FlowConfig, params: FlowParams, z: torch.Tensor, g: torch.Tensor,
           create_graph: bool) -> torch.Tensor:
    """grad_z [logp(F(z)) + logdet] from the model-space gradient ``g`` at
    ``F(z)``: one vjp through the forward transform (``z`` requires grad)."""
    x, logdet = flow_forward(cfg, params, z)
    (score,) = torch.autograd.grad((x, logdet), z, (g, torch.ones_like(logdet)),
                                   create_graph=create_graph)
    return score


def pullback_score(cfg: FlowConfig, params: FlowParams, x: torch.Tensor, g: torch.Tensor):
    """(x, grad_x logp) -> (z, grad_z logp_z) without re-evaluating logp."""
    z = flow_inverse(cfg, params, x).detach()
    with torch.enable_grad():
        score = _score(cfg, params, z.requires_grad_(True), g, False)
    return z.detach(), score


def fisher_distance(z: torch.Tensor, score_z: torch.Tensor) -> torch.Tensor:
    """Per-draw Fisher distance: ``mean((z + grad_z logp_z)^2)`` over the last axis."""
    return torch.mean(torch.square(z + score_z), dim=-1)


def _fisher_loss(cfg: FlowConfig, params: FlowParams, xs, gs, valid,
                 create_graph: bool = False) -> torch.Tensor:
    """Per chain: log E[ sum_coords (z + score)^2 ] over the valid window
    rows (``xs``, ``gs [C, W, dim]``, ``valid [C, W]``)."""
    with torch.enable_grad():
        z = flow_inverse(cfg, params, xs)
        if not z.requires_grad:
            z = z.requires_grad_(True)
        score = _score(cfg, params, z, gs, create_graph)
        per_draw = torch.sum(torch.square(z + score), dim=-1)
    per_draw = torch.where(valid, per_draw, torch.zeros_like(per_draw))
    n = torch.clamp(valid.sum(dim=-1), min=1).to(per_draw.dtype)
    mean = torch.sum(per_draw, dim=-1) / n
    return torch.log(torch.clamp(mean, min=1e-30))


def refit_diag(params: FlowParams, xs, gs, valid) -> FlowParams:
    """Gradient-informed diagonal refit per chain: sigma =
    sqrt(std(draws)/std(grads)), mu = mean(draws) + mean(grads) sigma^2,
    kept where finite."""
    v = valid[..., None].to(xs.dtype)
    n = torch.clamp(valid.sum(dim=-1).to(xs.dtype), min=2.0)[:, None]
    mean_x = torch.sum(xs * v, dim=1) / n
    mean_g = torch.sum(gs * v, dim=1) / n
    var_x = torch.sum(torch.square(xs - mean_x[:, None]) * v, dim=1) / (n - 1)
    var_g = torch.sum(torch.square(gs - mean_g[:, None]) * v, dim=1) / (n - 1)
    sigma = torch.sqrt(torch.sqrt(torch.clamp(var_x, min=1e-12) /
                                  torch.clamp(var_g, min=1e-12)))
    mu = mean_x + mean_g * torch.square(sigma)
    ok = (torch.all(torch.isfinite(sigma), dim=-1) & torch.all(torch.isfinite(mu), dim=-1))[:, None]
    return params._replace(mu=torch.where(ok, mu, params.mu),
                           log_sigma=torch.where(ok, torch.log(sigma), params.log_sigma))


def _loss_and_grads(cfg: FlowConfig, params: FlowParams, xs, gs, valid):
    """Each chain's loss and its gradients in the trained fields (the
    gradient of the summed loss: chains share no parameter)."""
    with torch.enable_grad():
        leaves = {f: getattr(params, f).detach().requires_grad_(f in TRAINED)
                  for f in FlowParams._fields}
        loss = _fisher_loss(cfg, FlowParams(**leaves), xs, gs, valid, create_graph=True)
        grads = torch.autograd.grad(loss.sum(), [leaves[f] for f in TRAINED],
                                    allow_unused=True)
    grads = [torch.zeros_like(leaves[f]) if g is None else g for f, g in zip(TRAINED, grads)]
    return loss.detach(), grads


def _per_chain(pred: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return pred.reshape((-1,) + (1,) * (t.dim() - 1))


class _AdamState:
    """train_flow's carry, updated in place by each step (so a CUDA graph
    of one step replays on the same storage): the parameters, Adam's
    moments, the best parameters with their losses, and the step count."""

    def __init__(self, params: FlowParams, loss0: torch.Tensor):
        self.p = [getattr(params, f).detach().clone() for f in TRAINED]
        self.m = [torch.zeros_like(t) for t in self.p]
        self.v = [torch.zeros_like(t) for t in self.p]
        self.best_p = [t.clone() for t in self.p]
        self.best_l = loss0.clone()
        self.count = torch.zeros((), dtype=loss0.dtype, device=loss0.device)


def _adam_step(cfg: FlowConfig, params: FlowParams, st: _AdamState, xs, gs, valid) -> None:
    """One Adam step of every chain on its own Fisher loss, in place: the
    gradient clipped per chain over that chain's own gradients, a
    nonfinite loss keeping the chain's parameters, the best parameters
    tracked by the loss at which they were evaluated."""
    b1, b2, lr = 0.9, 0.999, cfg.learning_rate
    cur = params._replace(**dict(zip(TRAINED, st.p)))
    loss, grads = _loss_and_grads(cfg, cur, xs, gs, valid)
    sq = [torch.sum(torch.square(g).reshape(g.shape[0], -1), dim=1) for g in grads]
    gnorm = torch.sqrt(sum(sq))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = [g * _per_chain(clip, g) for g in grads]
    count = st.count + 1
    m = [b1 * a + (1 - b1) * g for a, g in zip(st.m, grads)]
    v = [b2 * a + (1 - b2) * g * g for a, g in zip(st.v, grads)]
    mh = [a / (1 - b1 ** count) for a in m]
    vh = [a / (1 - b2 ** count) for a in v]
    if cfg.lr_decay:
        frac = (count - 1) / cfg.train_steps
        lr_t = lr * (0.1 + 0.45 * (1 + torch.cos(math.pi * frac)))
    else:
        lr_t = lr
    p_new = [pp - lr_t * a / (torch.sqrt(bb) + 1e-8) for pp, a, bb in zip(st.p, mh, vh)]
    finite = torch.isfinite(loss)
    p_new = [torch.where(_per_chain(finite, a), a, b) for a, b in zip(p_new, st.p)]
    better = finite & (loss < st.best_l)
    best_p = [torch.where(_per_chain(better, a), a, b) for a, b in zip(st.p, st.best_p)]
    st.best_l.copy_(torch.where(better, loss, st.best_l))
    st.count.copy_(count)
    for dst, src in ((st.m, m), (st.v, v), (st.best_p, best_p), (st.p, p_new)):
        for d, s_ in zip(dst, src):
            d.copy_(s_)


def train_flow(cfg: FlowConfig, params: FlowParams, xs, gs, valid):
    """Full-batch Adam on each chain's Fisher loss with best-params tracking.

    Returns ``(best_params, best_loss [C], improved [C])``.  A chain whose
    updates fail to improve on its starting loss, or produce nonfinite
    losses, keeps its flow.  ``cfg.train_steps`` steps (``_adam_step``),
    each with its gradient clipped per chain over that chain's own
    gradients.  On the card the first step runs eagerly and the second is
    captured in a CUDA graph and replayed for the rest: a step is about
    two thousand small launches (the Fisher loss's double backward through
    the flow, the Adam updates), which the host would otherwise issue one
    by one.  The graph computes what the eager step computes.
    """
    loss0 = _fisher_loss(cfg, params, xs, gs, valid).detach()
    st = _AdamState(params, loss0)
    if cfg.train_steps >= 1:
        _adam_step(cfg, params, st, xs, gs, valid)
    rest = cfg.train_steps - 1
    if rest > 0 and xs.is_cuda:
        graph, _ = graphs.capture(lambda: _adam_step(cfg, params, st, xs, gs, valid),
                                  xs.device)
        for _ in range(rest):
            graph.replay()
    else:
        for _ in range(rest):
            _adam_step(cfg, params, st, xs, gs, valid)
    # the final candidate may be the best
    p = st.p
    l_fin = _fisher_loss(cfg, params._replace(**dict(zip(TRAINED, p))), xs, gs, valid).detach()
    better = torch.isfinite(l_fin) & (l_fin < st.best_l)
    best_p = [torch.where(_per_chain(better, a), a, b) for a, b in zip(p, st.best_p)]
    best_l = torch.where(better, l_fin, st.best_l)
    return params._replace(**dict(zip(TRAINED, best_p))), best_l, best_l < loss0


def median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, averaging the two middle values (as
    ``jnp.median``; ``torch.median`` takes the lower one)."""
    s, _ = torch.sort(x, dim=-1)
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def retarget_extension_masks(fcfg: FlowConfig, flow: FlowParams, *, allowed, win_draws,
                             win_grads, valid) -> FlowParams:
    """Point each chain's trailing extension layers at its worst-cost
    coordinates: per-coordinate cost ``mean((z_j + score_j)^2)`` over the
    window, coordinates at or above the median in the transformed (mask 0)
    slot, consecutive extension layers alternating with the complement;
    only where ``allowed`` and those layers are still identities (zero
    output weights)."""
    n_ext = _n_extension(fcfg)
    if n_ext <= 0:
        return flow
    L = fcfg.num_layers
    dtype = win_draws.dtype
    can = allowed & torch.all((flow.w2[:, L - n_ext:] == 0.0).reshape(flow.w2.shape[0], -1),
                              dim=1)
    nz = torch.clamp(valid.sum(dim=-1), min=1).to(dtype)
    sq = torch.square(win_draws + win_grads)
    cost = torch.sum(torch.where(valid[..., None], sq, torch.zeros_like(sq)), dim=1) / nz[:, None]
    row = torch.where(cost >= median(cost)[:, None], 0.0, 1.0).to(dtype)
    ext_rows = torch.stack([row if j % 2 == 0 else 1.0 - row for j in range(n_ext)], dim=1)
    new_masks = flow.masks.clone()
    new_masks[:, L - n_ext:] = ext_rows
    return flow._replace(masks=torch.where(_per_chain(can, new_masks), new_masks, flow.masks))


class FlowWindow(NamedTuple):
    """Per-chain flow-training window and parameters (leading chains axis)."""

    flow: FlowParams
    flow_updates: torch.Tensor  # [C] int32
    win_draws: torch.Tensor     # [C, window, dim] base-space positions
    win_grads: torch.Tensor     # [C, window, dim] base-space gradients
    win_valid: torch.Tensor     # [C, window] bool


def init_flow_window(cfg: FlowConfig, dim: int, keys: torch.Tensor, dtype) -> FlowWindow:
    C, W, device = keys.shape[0], cfg.window, keys.device
    return FlowWindow(
        flow=init_flow_params(cfg, dim, keys, dtype),
        flow_updates=torch.zeros((C,), dtype=torch.int32, device=device),
        win_draws=torch.zeros((C, W, dim), dtype=dtype, device=device),
        win_grads=torch.zeros((C, W, dim), dtype=dtype, device=device),
        win_valid=torch.zeros((C, W), dtype=torch.bool, device=device),
    )


def _push_to_model_space(fcfg: FlowConfig, flow: FlowParams, x: torch.Tensor,
                         gz: torch.Tensor) -> torch.Tensor:
    """grad_x of the model from its base-space gradient ``gz`` at ``x``: the
    vjp of ``xx -> (F^-1(xx), -logdet(F^-1(xx)))`` with cotangent (gz, 1)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        zz = flow_inverse(fcfg, flow, xg)
        _, fld = flow_forward(fcfg, flow, zz)
        (gx,) = torch.autograd.grad((zz, -fld), xg, (gz, torch.ones_like(fld)))
    return gx


def chunk_flow_update(fcfg: FlowConfig, logp_and_grad, win: FlowWindow, position, gradient,
                      logp, buf_pos, buf_grad, rows_ok, in_warmup: bool):
    """Every chain's flow-training step at a chunk boundary.

    Rolls the chunk's (z, grad_z) rows (``buf_pos``, ``buf_grad [C, R,
    dim]``, valid where ``rows_ok [C, R]``) into the training window,
    expresses the window in model space through the current flow, trains
    (diagonal refit for the first ``num_diag_updates``, Fisher-loss Adam
    after) and re-bases each accepted chain into its new flow's base space
    (``logp_and_grad``: the model's batched log density and gradient).
    Returns ``(new_window, position, gradient, logp)``; every failure leaves
    a chain's flow unchanged.  Where no chain is due the window rolls and
    nothing else runs, and ``train_flow`` runs only where a chain past its
    diagonal phase is due: the JAX package computes both and discards them,
    so skipping them changes no result.
    """
    W = fcfg.window
    win_draws = torch.cat([win.win_draws, torch.nan_to_num(buf_pos)], dim=1)[:, -W:]
    win_grads = torch.cat([win.win_grads, torch.nan_to_num(buf_grad)], dim=1)[:, -W:]
    valid = torch.cat([win.win_valid, rows_ok], dim=1)[:, -W:]
    n_valid = valid.sum(dim=1)
    due = (n_valid >= min(32, W)) & bool(in_warmup)
    if not bool(due.any()):
        return (win._replace(win_draws=win_draws, win_grads=win_grads, win_valid=valid),
                position, gradient, logp)

    cur_flow = win.flow
    if _n_extension(fcfg) > 0:
        cur_flow = retarget_extension_masks(
            fcfg, cur_flow, allowed=win.flow_updates >= fcfg.num_diag_updates,
            win_draws=win_draws, win_grads=win_grads, valid=valid)

    # the window (z, grad_z) -> model space (x, grad_x) through the current flow
    xs, _ = flow_forward(fcfg, cur_flow, win_draws)
    gxs = _push_to_model_space(fcfg, cur_flow, xs, win_grads)
    keep = valid[..., None]
    xs = torch.where(keep, xs, torch.zeros_like(xs))
    gxs = torch.where(keep, gxs, torch.zeros_like(gxs))

    diag_phase = win.flow_updates < fcfg.num_diag_updates
    new_diag = refit_diag(cur_flow, xs, gxs, valid)
    if bool((due & ~diag_phase).any()):
        trained, _, improved = train_flow(fcfg, cur_flow, xs, gxs, valid)
    else:
        trained, improved = cur_flow, torch.zeros_like(due)
    candidate = tree_where(diag_phase, new_diag, trained)
    accept = due & (diag_phase | improved)
    new_flow = tree_where(accept, candidate, win.flow)

    # re-base the chain into the new flow's coordinates
    x_cur, _ = flow_forward(fcfg, win.flow, position)
    z_new = flow_inverse(fcfg, new_flow, x_cur)
    logp_new, grad_new = flow_logp_and_grad(fcfg, logp_and_grad, new_flow, z_new)
    rebase_ok = (accept & torch.isfinite(logp_new) & torch.all(torch.isfinite(grad_new), dim=1)
                 & torch.all(torch.isfinite(z_new), dim=1))
    new_flow = tree_where(rebase_ok, new_flow, win.flow)
    position = torch.where(rebase_ok[:, None], z_new, position)
    gradient = torch.where(rebase_ok[:, None], grad_new.to(gradient.dtype), gradient)
    logp = torch.where(rebase_ok, logp_new.to(logp.dtype), logp)
    new_win = FlowWindow(
        flow=new_flow, flow_updates=win.flow_updates + due.to(torch.int32),
        win_draws=win_draws, win_grads=win_grads,
        # training pairs in old coordinates are stale after a flow change
        win_valid=valid & ~rebase_ok[:, None],
    )
    return new_win, position, gradient, logp


def chunk_to_model_space(fcfg: FlowConfig, flow: FlowParams, positions: torch.Tensor,
                         gradients=None):
    """A chunk's base-space draws in model space, each chain through its
    flow (``positions [C, L, dim]``): ``(xs, logdets [C, L], gxs)``,
    ``gxs`` None without gradients.  The model-space logp is
    ``logp_z - logdet``."""
    xs, logdets = flow_forward(fcfg, flow, positions)
    gxs = None if gradients is None else _push_to_model_space(fcfg, flow, xs, gradients)
    return xs.detach(), logdets.detach(), gxs
