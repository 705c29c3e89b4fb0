"""Stan's higher-order functionals on the card.

The port of ``nutpie_tpu/frontends/stan/functionals.py``, every name of its
``IMPLS`` table, on the same algorithms (value AND gradient):

- ``reduce_sum``/``reduce_sum_static`` exploit an exact identity: the
  partial-sum function must satisfy ``sum_i f(slice_i, start_i, end_i,
  ...) == f(x, 1, N, ...)`` for any partition (that is what makes Stan's
  parallelization valid), so the whole call evaluates as ONE call on the
  full slice.  The batched evaluation already vectorizes the body; the
  grainsize hint has no role.
- ``map_rect`` unrolls over the (static) job axis and concatenates the
  results.
- ``integrate_1d`` is 64-point Gauss-Legendre quadrature with Stan's
  variable transforms for infinite endpoints, summed node by node in the
  reference's order; it has no loop, so a program whose only functional
  it is keeps the CUDA-graph route.
- the ODE solvers run Dormand-Prince 5(4) with an adaptive step, written
  from ``jax.experimental.ode`` (its ``odeint``), with that module's
  continuous adjoint for the gradient.  Every ODE name runs it, the stiff
  ones too, with the tolerances floored at 100 eps of the dtype.  Only the
  floating arguments enter the adjoint: integer arguments (``x_i``) are
  constants of the solve (where the JAX package raises on them).
- the algebraic solvers run damped Newton, with the gradient from the
  implicit function theorem (``lax.custom_root`` in the JAX package).
- the DAE solvers run a fixed TR-BDF2 grid whose stages are solved by that
  Newton; their gradient comes through the stages by the implicit function
  theorem and by autograd over the substeps.

The interpreter evaluates a program per chain under ``torch.func.vmap``.
A solver that loops until the data say stop (an adaptive ODE step, a
Newton iteration) is a ``torch.autograd.Function`` with a ``vmap`` rule
(``_Solve``): its body sees ``[C, ...]`` tensors, applies the Stan
function by ``torch.func.vmap``, and loops while any chain is active,
keeping a finished chain's carry by ``torch.where`` (the batched
``lax.while_loop`` of the JAX package under ``jax.vmap``), so a chain's
result in a fleet equals its result alone.  The loop reads its stop on the
host, which a CUDA graph cannot hold: a program whose log density calls
such a solver is marked when its model is built (``solver_calls``), and
the step runner calls its log density eagerly around K2.  The gradient
comes from the Function's own backward; autograd never unrolls the loop.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ...ops import graphs
from . import ast_nodes as A
from . import xp
from .errors import StanCompileError

# the functionals whose solver loops until the data say stop
LOOPING = frozenset({
    "integrate_ode", "integrate_ode_rk45", "integrate_ode_bdf",
    "integrate_ode_adams",
    "ode_rk45", "ode_rk45_tol", "ode_bdf", "ode_bdf_tol", "ode_adams",
    "ode_adams_tol", "ode_ckrk", "ode_ckrk_tol", "ode_adjoint_tol_ctl",
    "dae", "dae_tol",
    "algebra_solver", "algebra_solver_newton",
    "solve_newton", "solve_newton_tol", "solve_powell", "solve_powell_tol",
})

# the Dormand-Prince attempts of the last ODE solve, per chain and output
# interval ([C, T] tensors on the solve's device): "forward" the solve,
# "backward" the adjoint's (read by chip_smoke; nothing else reads them)
ATTEMPTS: dict = {"forward": None, "backward": None}
# running counts since the last reset: ODE solves ("forward") and their
# adjoints ("backward"), Dormand-Prince attempt loops over the fleet
# ("attempts": each steps every active chain once) and output intervals
# whose loop ran to the solve's max_num_steps ("capped_intervals": one
# chain there holds the whole fleet); counted on the host, free
SOLVES: dict = {"forward": 0, "backward": 0, "attempts": 0, "capped_intervals": 0}


def _tol_floor(tol, dtype):
    eps = float(torch.finfo(dtype).eps)
    return max(float(tol), 100.0 * eps)


def _first_dim(x, node, what):
    if isinstance(x, (list, tuple)):
        return len(x)
    shape = xp.shape(x)
    if not shape:
        raise StanCompileError(
            f"{what} must be an array (got a scalar)", node.line, node.col
        )
    return int(shape[0])


def _rows(x, n):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x[j] for j in range(n)]


# --------------------------------------------------------- reduce_sum

def _reduce_sum(f, args, node, interp):
    if len(args) < 2:
        raise StanCompileError(
            "reduce_sum(f, x, grainsize, ...) needs at least a sliced "
            "argument and a grainsize", node.line, node.col,
        )
    x, _grainsize, *shared = args
    n = _first_dim(x, node, "the sliced argument of reduce_sum")
    # exact semantic identity: one partition = the whole slice
    return f(x, 1, n, *shared)


# ----------------------------------------------------------- map_rect

def _map_rect(f, args, node, interp):
    if len(args) != 4:
        raise StanCompileError(
            "map_rect(f, phi, thetas, x_rs, x_is) takes exactly 5 "
            "arguments", node.line, node.col,
        )
    phi, thetas, x_rs, x_is = args
    n_jobs = _first_dim(thetas, node, "the job-parameters argument of "
                        "map_rect")
    th = _rows(thetas, n_jobs)
    xr = _rows(x_rs, n_jobs)
    xi = _rows(x_is, n_jobs)
    outs = []
    for j in range(n_jobs):
        out = f(phi, th[j], xr[j], xi[j])
        outs.append(xp.ravel(out if not isinstance(out, np.ndarray) or out.ndim
                             else out.item()))
    return xp.concatenate(outs) if outs else xp.zeros((0,))


# -------------------------------------------------------- integrate_1d

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(64)


def _finite(bound):
    """(is_concrete, float value or None) for an integration endpoint."""
    if isinstance(bound, (int, float, np.generic)) or (
        isinstance(bound, np.ndarray) and bound.size == 1
    ):
        return True, float(np.asarray(bound).reshape(()))
    return False, None


def _integrate_1d(f, args, node, interp):
    if len(args) not in (5, 6):
        raise StanCompileError(
            "integrate_1d(f, a, b, theta, x_r, x_i[, rel_tol]) takes 6 "
            "or 7 arguments", node.line, node.col,
        )
    a, b, theta, x_r, x_i = args[:5]
    a_conc, a_val = _finite(a)
    b_conc, b_val = _finite(b)
    a_inf = a_conc and a_val is not None and np.isinf(a_val)
    b_inf = b_conc and b_val is not None and np.isinf(b_val)
    t, w = _GL_NODES, _GL_WEIGHTS
    nan = xp.asarray(math.nan)

    def term(weight, value):
        return float(weight) * xp.asarray(value, xp.fdtype())

    total = xp.zeros(())
    if a_inf and b_inf:
        # x = t/(1-t^2), dx = (1+t^2)/(1-t^2)^2 dt, t in (-1, 1)
        for tj, wj in zip(t, w):
            x = tj / (1.0 - tj * tj)
            jac = (1.0 + tj * tj) / (1.0 - tj * tj) ** 2
            total = total + term(wj * jac, f(x, nan, theta, x_r, x_i))
    elif b_inf:
        # x = a + u/(1-u), u in (0,1); xc = x - a (distance to the
        # finite endpoint, positive side)
        for tj, wj in zip(t, w):
            u = 0.5 * (tj + 1.0)
            x = a + u / (1.0 - u)
            jac = 0.5 / (1.0 - u) ** 2
            total = total + term(wj * jac, f(x, x - a, theta, x_r, x_i))
    elif a_inf:
        # x = b - u/(1-u); xc = x - b (negative side, Stan's right-half
        # convention)
        for tj, wj in zip(t, w):
            u = 0.5 * (tj + 1.0)
            x = b - u / (1.0 - u)
            jac = 0.5 / (1.0 - u) ** 2
            total = total + term(wj * jac, f(x, x - b, theta, x_r, x_i))
    else:
        # finite [a, b]: xc = x - a on the left half, x - b on the right
        # (Stan's convention so singular endpoint distances stay exact)
        fa, fb = xp.asarray(a, xp.fdtype()), xp.asarray(b, xp.fdtype())
        half = 0.5 * (fb - fa)
        mid = 0.5 * (fb + fa)
        for tj, wj in zip(t, w):
            x = mid + half * float(tj)
            xc = x - a if tj < 0 else x - b
            total = total + term(wj, f(x, xc, theta, x_r, x_i))
        total = half * total
    return total


# ------------------------------------------------ solvers over the chains

def _leaves(values):
    """``(floats, rebuild)``: the floating leaves of nested argument values
    as tensors of the evaluation, in order, and ``rebuild(tensors)`` that
    puts tensors in their places.  Every other leaf (integers, booleans,
    host integer arrays) is a constant of the solve."""
    from .interpreter import StanTuple

    floats: list = []

    def split(v):
        if isinstance(v, StanTuple):
            parts = [split(u) for u in v.slots]
            return lambda it: StanTuple(p(it) for p in parts)
        if isinstance(v, (list, tuple)):
            parts = [split(u) for u in v]
            kind = type(v)
            return lambda it: kind(p(it) for p in parts)
        is_float = (
            (isinstance(v, torch.Tensor) and v.is_floating_point())
            or (isinstance(v, np.ndarray) and v.dtype.kind == "f")
            or isinstance(v, (float, np.floating))
        )
        if is_float:
            floats.append(xp.asarray(v, xp.fdtype()))
            return next
        return lambda it: v

    parts = [split(v) for v in values]

    def rebuild(tensors):
        it = iter(tensors)
        return [p(it) for p in parts]

    return floats, rebuild


def _fold(x, lead: int):
    """``x`` with its ``lead`` chain axes as one leading axis (one of size 1
    where there is none)."""
    if lead == 0:
        return x.unsqueeze(0)
    return x.reshape((math.prod(x.shape[:lead]),) + tuple(x.shape[lead:]))


class _Solve(torch.autograd.Function):
    """``solver`` over a leading chain axis.  ``lead`` counts the chain axes
    the inputs carry: 0 where no vmap is active, one more for each vmap
    level this Function has passed (its ``vmap`` rule moves the level's
    axis to the front and applies it again).  ``solver.forward(xs)`` and
    ``solver.backward(xs, out, grad)`` see one chain axis."""

    generate_vmap_rule = False

    @staticmethod
    def forward(solver, lead, *xs):
        flat = [_fold(x, lead) for x in xs]
        with xp.evaluation(*solver.ev):
            out = solver.forward(flat)
        if lead == 0:
            return out[0]
        return out.reshape(tuple(xs[0].shape[:lead]) + tuple(out.shape[1:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        solver, lead, *xs = inputs
        ctx.solver, ctx.lead = solver, lead
        ctx.save_for_backward(*xs, output)

    @staticmethod
    def backward(ctx, grad):
        *xs, out = ctx.saved_tensors
        lead = ctx.lead
        with torch.no_grad(), xp.evaluation(*ctx.solver.ev):
            grads = ctx.solver.backward([_fold(x, lead) for x in xs],
                                        _fold(out, lead), _fold(grad, lead))
        return (None, None, *[None if g is None else g.reshape(x.shape)
                              for g, x in zip(grads, xs)])

    @staticmethod
    def vmap(info, in_dims, solver, lead, *xs):
        moved = [x.movedim(d, 0) if d is not None
                 else x.expand((info.batch_size,) + tuple(x.shape))
                 for x, d in zip(xs, in_dims[2:])]
        return _Solve.apply(solver, lead + 1, *moved), 0


def _per_chain(fn, *xs):
    """``fn`` of one chain's tensors over the leading axis of ``xs``."""
    return vmap(fn)(*xs)


def _vjp(fn, xs, cotangent):
    """``(fn(*xs), vjps)`` of a batched ``fn``: rows are chains, so the
    batch's vector-Jacobian product is each chain's.  Inputs ``fn`` does
    not use get zeros."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in xs]
        out = fn(*xs)
        if out.requires_grad:
            grads = torch.autograd.grad(out, xs, cotangent, allow_unused=True)
        else:
            grads = [None] * len(xs)
    return out.detach(), [torch.zeros_like(x) if g is None else g
                          for g, x in zip(grads, xs)]


# ---------------------------------------------------------- ODE solvers
#
# Dormand-Prince 5(4) as jax.experimental.ode writes it, over a leading
# chain axis: states [B, n], times and step sizes [B]

_ALPHA = (1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0)
_BETA = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_C_SOL = (35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0)
_C_ERROR = (35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
            125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
            11 / 84 - 649 / 6300, -1. / 60.)
_DPS_C_MID = (6025192743 / 30085553152 / 2, 0, 51252292925 / 65400821598 / 2,
              -2691868925 / 45128329728 / 2, 187940372067 / 1594534317056 / 2,
              -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2)


def _comb(coefs, ks):
    """``sum_j coefs[j] * ks[j]`` over the stages given, in stage order."""
    acc = coefs[0] * ks[0]
    for c, k in zip(coefs[1:], ks[1:]):
        acc = acc + c * k
    return acc


def _norm(x):
    return torch.sqrt(torch.sum(x * x, -1))


def _initial_step_size(fun, t0, y0, rtol, atol, f0):
    # Hairer, Norsett, Wanner, Solving ODEs I, Sec. II.4 (order 4)
    scale = atol + torch.abs(y0) * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + h0[:, None] * f0
    f1 = fun(y1, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1. / (4 + 1.)))
    return torch.minimum(100. * h0, h1)


def _runge_kutta_step(fun, y0, f0, t0, dt):
    dtc = dt[:, None]
    ks = [f0]
    for i in range(1, 7):
        ti = t0 + dt * _ALPHA[i - 1]
        yi = y0 + dtc * _comb(_BETA[i - 1], ks)
        ks.append(fun(yi, ti))
    y1 = dtc * _comb(_C_SOL, ks) + y0
    y1_error = dtc * _comb(_C_ERROR, ks)
    return y1, ks[-1], y1_error, ks


def _mean_error_ratio(error_estimate, rtol, atol, y0, y1):
    err_tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    err_ratio = error_estimate / err_tol
    return torch.sqrt(torch.mean(err_ratio ** 2, -1))


def _optimal_step_size(last_step, mean_error_ratio, safety=0.9, ifactor=10.0,
                       dfactor=0.2, order=5.0):
    dfactor = torch.where(mean_error_ratio < 1, 1.0, dfactor)
    factor = torch.clamp(torch.maximum(mean_error_ratio ** (-1.0 / order) * safety,
                                       dfactor), max=ifactor)
    return torch.where(mean_error_ratio == 0, last_step * ifactor, last_step * factor)


def _interp_fit_dopri(y0, y1, ks, dt):
    dt = dt[:, None]
    y_mid = y0 + dt * _comb(_DPS_C_MID, ks)
    dy0, dy1 = ks[0], ks[-1]
    a = -2. * dt * dy0 + 2. * dt * dy1 - 8. * y0 - 8. * y1 + 16. * y_mid
    b = 5. * dt * dy0 - 3. * dt * dy1 + 18. * y0 + 14. * y1 - 32. * y_mid
    c = -4. * dt * dy0 + dt * dy1 - 11. * y0 - 5. * y1 + 16. * y_mid
    d = dt * dy0
    return torch.stack([a, b, c, d, y0], 1)


def _polyval(coeffs, x):
    """Horner from zero, as ``jnp.polyval``: coeffs [B, 5, n], x [B]."""
    y = torch.zeros_like(coeffs[:, 0])
    for j in range(coeffs.shape[1]):
        y = y * x[:, None] + coeffs[:, j]
    return y


class _Graphed:
    """``fn(*tensors) -> [tensors]`` called many times at the same shapes.
    On the card the first call runs eagerly (it warms ``fn``'s constants on
    the device), the second captures one call in a CUDA graph
    (``ops.graphs.capture``), and every call from then on copies its
    arguments into the graph's inputs, replays it and returns copies of its
    outputs.  On the CPU every call runs ``fn``.  ``fn`` may be replaced
    between calls by one that launches the same work (a later evaluation's
    closure over the same Stan function)."""

    def __init__(self, fn=None):
        self.fn = fn
        self.calls = 0
        self.graph = self.ins = self.outs = None

    def __call__(self, *xs):
        self.calls += 1
        if not xs[0].is_cuda or self.calls == 1:
            return self.fn(*xs)
        if self.graph is None:
            self.ins = [x.clone() for x in xs]
            self.graph, self.outs = graphs.capture(lambda: self.fn(*self.ins), xs[0].device)
        for s, x in zip(self.ins, xs):
            s.copy_(x)
        self.graph.replay()
        return [o.clone() for o in self.outs]


class _Dopri:
    """Dormand-Prince over a leading chain axis for a right-hand side
    ``fun(y [B, n], t [B], *args) -> [B, n]``, in three pieces: ``start``
    (the first derivative and step), ``attempt`` (one step attempt of every
    active chain) and ``read`` (the interpolant at an output time), each
    ``_Graphed``.  The arguments ride as inputs, so on the card one
    ``_Dopri`` serves every solve of the same right-hand side at the same
    shapes (``_Ode.dopri`` keeps it with the model's data): every attempt
    after its first two, in this call or a later one, replays a graph (the
    adjoint integrates one interval at a time)."""

    def __init__(self, rtol, atol, mxstep):
        self.rtol, self.atol, self.mxstep = rtol, atol, mxstep
        self.fun = None
        self.start = _Graphed(self._start)
        self.attempt = _Graphed(self._attempt)
        self.read = _Graphed(self._read)

    def _start(self, y0, t0, *args):
        def fun(y, t):
            return self.fun(y, t, *args)
        f0 = fun(y0, t0)
        dt = _initial_step_size(fun, t0, y0, self.rtol, self.atol, f0)
        return [f0, torch.clamp(dt, min=0.)]

    def _active(self, t, dt, i, target):
        return (t < target) & (i < self.mxstep) & (dt > 0)

    def _attempt(self, y, f, t, dt, last_t, coeffs, i, target, *args):
        # the body of the JAX while_loop, kept where a chain is done; its
        # last output says whether any chain goes on
        active = self._active(t, dt, i, target)
        next_y, next_f, next_y_error, ks = _runge_kutta_step(
            lambda y, t: self.fun(y, t, *args), y, f, t, dt)
        next_t = t + dt
        error_ratio = _mean_error_ratio(next_y_error, self.rtol, self.atol, y, next_y)
        new_coeffs = _interp_fit_dopri(y, next_y, ks, dt)
        new_dt = torch.clamp(_optimal_step_size(dt, error_ratio), min=0.)
        take = active & (error_ratio <= 1.)
        y = torch.where(take[:, None], next_y, y)
        f = torch.where(take[:, None], next_f, f)
        last_t = torch.where(take, t, last_t)
        t = torch.where(take, next_t, t)
        dt = torch.where(active, new_dt, dt)
        coeffs = torch.where(take[:, None, None], new_coeffs, coeffs)
        i = i + active
        return [y, f, t, dt, last_t, coeffs, i, self._active(t, dt, i, target).any()]

    @staticmethod
    def _read(coeffs, t, last_t, target):
        return [_polyval(coeffs, (target - last_t) / (t - last_t))]

    def solve(self, fun, y0, ts, args):
        """``fun`` integrated from ``ts[:, 0]``, read at every ``ts[:, k]``:
        ``(ys [B, T, n], attempts [B, T - 1])``.  Each output interval
        loops while any chain is short of its target (and within
        ``mxstep`` attempts, with a positive step); the others keep their
        carry.  The host reads the stop after each attempt and counts the
        intervals whose loop ran to ``mxstep`` in ``SOLVES``."""
        self.fun = fun
        f, dt = self.start(y0, ts[:, 0], *args)
        y, t, last_t = y0, ts[:, 0], ts[:, 0]
        coeffs = torch.stack([y0] * 5, 1)
        outs, attempts = [y0], []
        for k in range(1, ts.shape[1]):
            target = ts[:, k]
            i = torch.zeros(y0.shape[0], dtype=torch.int64, device=y0.device)
            more = bool(self._active(t, dt, i, target).any())
            loops = 0
            while more:
                y, f, t, dt, last_t, coeffs, i, go = self.attempt(
                    y, f, t, dt, last_t, coeffs, i, target, *args)
                more = bool(go)
                loops += 1
            SOLVES["attempts"] += loops
            SOLVES["capped_intervals"] += loops >= self.mxstep
            outs.extend(self.read(coeffs, t, last_t, target))
            attempts.append(i)
        return torch.stack(outs, 1), torch.stack(attempts, 1)


class _Ode:
    """The ODE solve of one call: inputs ``[y0 [B, n], ts [B, T], *args]``
    (``ts`` with the initial time first; ``args`` the floating leaves of
    the Stan function's extra arguments), output ``ys [B, T, n]``.  The
    backward is ``_odeint_rev``'s continuous adjoint: the augmented state
    ``(y, y_bar, t0_bar, args_bar)`` flattened in that order, integrated
    back over each output interval at the forward's tolerances.  ``site``
    names the call in its program (the solvers kept for it live in the
    evaluation's cache, with the model's data on the device)."""

    def __init__(self, f, rebuild, rtol, atol, mxstep, site):
        self.f, self.rebuild = f, rebuild
        self.rtol, self.atol, self.mxstep = rtol, atol, mxstep
        self.site = site
        self.ev = xp.current()

    def rhs(self, y, t, args):
        def one(y, t, *a):
            out = xp.asarray(self.f(t, y, *self.rebuild(a)))
            return out.to(y.dtype).reshape(y.shape)
        return _per_chain(one, y, t, *args)

    def kept(self, role, make, *xs):
        """``make()``, kept across calls on the card in the evaluation's
        cache under this call site, ``role`` and the shapes of ``xs``."""
        cache = self.ev[2]
        if cache is None or not xs[0].is_cuda:
            return make()
        key = ("solver", self.site, role, self.rtol, self.atol, self.mxstep,
               xs[0].dtype) + tuple(tuple(x.shape) for x in xs)
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def dopri(self, role, *xs):
        return self.kept(role, lambda: _Dopri(self.rtol, self.atol, self.mxstep), *xs)

    def forward(self, xs):
        y0, ts, *args = xs
        SOLVES["forward"] += 1
        ys, ATTEMPTS["forward"] = self.dopri("forward", *xs).solve(
            lambda y, t, *a: self.rhs(y, t, a), y0, ts, args)
        return ys

    def backward(self, xs, ys, g):
        _, ts, *args = xs
        n_y = ys.shape[2]
        sizes = [a[0].numel() for a in args]
        SOLVES["backward"] += 1

        def unpack(state, args):
            y, y_bar = state[:, :n_y], state[:, n_y:2 * n_y]
            t0_bar = state[:, 2 * n_y]
            rest = torch.split(state[:, 2 * n_y + 1:], sizes, 1)
            return y, y_bar, t0_bar, [r.reshape(a.shape) for r, a in zip(rest, args)]

        def pack(y, y_bar, t0_bar, args_bar):
            return torch.cat([y, y_bar, t0_bar[:, None],
                              *[a.reshape(a.shape[0], -1) for a in args_bar]], 1)

        def aug_dynamics(state, t, *args):
            # t is negative time
            y, y_bar, _, _ = unpack(state, args)
            y_dot, (vy, vt, *va) = _vjp(lambda y, t, *a: self.rhs(y, t, a),
                                         [y, -t, *args], y_bar)
            return pack(-y_dot, vy, vt, va)

        def measurement(y, t, g_i, *args):
            # the effect of moving the measurement time
            return [torch.sum(self.rhs(y, t, args) * g_i, -1)]

        y_bar = g[:, -1]
        t0_bar = torch.zeros_like(ts[:, 0])
        args_bar = [torch.zeros_like(a) for a in args]
        state = pack(ys[:, -1], y_bar, t0_bar, args_bar)
        dopri = self.dopri("backward", state, ts[:, :2], *args)
        t_bar_of = self.kept("measurement", _Graphed, ys[:, -1], ts[:, -1], g[:, -1], *args)
        t_bar_of.fn = measurement
        rev_ts_bar, attempts = [], []
        for i in range(ts.shape[1] - 1, 0, -1):
            (t_bar,) = t_bar_of(ys[:, i], ts[:, i], g[:, i], *args)
            t0_bar = t0_bar - t_bar
            # the augmented system backwards to the previous observation
            out, att = dopri.solve(aug_dynamics, pack(ys[:, i], y_bar, t0_bar, args_bar),
                                   torch.stack([-ts[:, i], -ts[:, i - 1]], 1), args)
            _, y_bar, t0_bar, args_bar = unpack(out[:, 1], args)
            # the gradient from the current output
            y_bar = y_bar + g[:, i - 1]
            rev_ts_bar.append(t_bar)
            attempts.append(att[:, 0])
        ATTEMPTS["backward"] = torch.stack(attempts[::-1], 1)
        ts_bar = torch.stack([t0_bar] + rev_ts_bar[::-1], 1)
        return [y_bar, ts_bar, *args_bar]


def _static_scalar(val, expr, node, what):
    """A scalar that Stan's signature requires to be data, on the host."""
    if isinstance(val, (int, float, np.generic, np.ndarray)):
        try:
            return float(np.asarray(val).reshape(()))
        except ValueError:
            pass
    lit = _const_fold_floats(expr) if expr is not None else None
    if lit is not None and len(lit) == 1:
        return lit[0]
    raise StanCompileError(
        f"{what} must be data (a literal or a data-block value)",
        node.line, node.col,
    )


def _run_odeint(f, y0, t0, ts, fargs, rel_tol, abs_tol, max_steps, node):
    # both Stan interfaces have f(t, y, ...state-free args); the floating
    # leaves of the extra args ride through the solve so the adjoint
    # differentiates them
    dt = xp.fdtype()
    y0a = xp.asarray(y0, dt)
    flat = y0a.ndim == 0
    if flat:
        y0a = y0a.reshape(1)
    t_full = torch.cat([xp.asarray(t0, dt).reshape(1), xp.asarray(ts, dt).reshape(-1)])
    floats, rebuild = _leaves(fargs)
    solver = _Ode(f, rebuild, _tol_floor(rel_tol, dt), _tol_floor(abs_tol, dt),
                  float(max_steps), id(node))
    sol = _Solve.apply(solver, 0, y0a, t_full, *floats)[1:]
    return sol[:, 0] if flat else sol


def _make_ode(old_interface, default_rel, default_abs, default_max):
    def impl(f, args, node, interp):
        if old_interface:
            # integrate_ode_*(f, y0, t0, ts, theta, x_r, x_i
            #                 [, rel_tol, abs_tol, max_steps]);
            # f(t, y, theta, x_r, x_i) -> array[] real
            if len(args) not in (6, 9):
                raise StanCompileError(
                    "integrate_ode_*(f, y0, t0, ts, theta, x_r, x_i"
                    "[, rel_tol, abs_tol, max_num_steps])",
                    node.line, node.col,
                )
            y0, t0, ts, theta, x_r, x_i = args[:6]
            if len(args) == 9:
                rel, ab, mx = (_static_scalar(args[6 + j], node.args[7 + j], node, what)
                               for j, what in enumerate(("rel_tol", "abs_tol",
                                                         "max_num_steps")))
            else:
                rel, ab, mx = default_rel, default_abs, default_max
            return _run_odeint(f, y0, t0, ts, (theta, x_r, x_i), rel, ab, mx, node)
        # ode_*(f, y0, t0, ts, ...args); f(t, y, ...args) -> vector
        if len(args) < 3:
            raise StanCompileError(
                "ode solver needs (f, y0, t0, ts, ...)",
                node.line, node.col,
            )
        y0, t0, ts, *rest = args
        return _run_odeint(f, y0, t0, ts, tuple(rest),
                           default_rel, default_abs, default_max, node)
    return impl


def _make_ode_tol(default_max):
    def impl(f, args, node, interp):
        # ode_*_tol(f, y0, t0, ts, rel_tol, abs_tol, max_num_steps, ...)
        if len(args) < 6:
            raise StanCompileError(
                "ode_*_tol needs (f, y0, t0, ts, rel_tol, abs_tol, "
                "max_num_steps, ...)", node.line, node.col,
            )
        y0, t0, ts = args[:3]
        rel, ab, mx = (_static_scalar(args[3 + j], node.args[4 + j], node, f"ode_*_tol {what}")
                       for j, what in enumerate(("rel_tol", "abs_tol", "max_num_steps")))
        return _run_odeint(f, y0, t0, ts, tuple(args[6:]), rel, ab, mx, node)
    return impl


def _ode_adjoint_tol_ctl(f, args, node, interp):
    """``ode_adjoint_tol_ctl`` on the same adjoint-differentiated
    Dormand-Prince integrator as ``ode_*`` (the continuous adjoint method
    CVODES implements).  Signature (Stan functions reference 13.3): ``(f,
    y0, t0, times, rel_tol_forward, abs_tol_forward(vector),
    rel_tol_backward, abs_tol_backward(vector), rel_tol_quadrature,
    abs_tol_quadrature, max_num_steps, num_steps_between_checkpoints,
    interpolation_polynomial, solver_forward, solver_backward, ...args)``.

    One tolerance pair serves the forward and the augmented backward
    solve, so the forward/backward/quadrature requests collapse to their
    minimum (never looser than asked); the checkpointing and
    solver-selection integers are performance controls with no effect on
    the solution and are ignored.  The tolerances are data: a vector
    literal such as ``[1e-8]'`` is a tensor of the evaluation, so its
    expression is constant-folded instead of read.
    """
    if len(args) < 14:
        raise StanCompileError(
            "ode_adjoint_tol_ctl needs (f, y0, t0, times, rel_tol_forward, "
            "abs_tol_forward, rel_tol_backward, abs_tol_backward, "
            "rel_tol_quadrature, abs_tol_quadrature, max_num_steps, "
            "num_steps_between_checkpoints, interpolation_polynomial, "
            "solver_forward, solver_backward, ...)", node.line, node.col,
        )
    y0, t0, ts = args[:3]
    # args[10:12] checkpointing/interpolation, args[12:14] solver choices
    rest = tuple(args[14:])

    def static_min(i, what):
        val = args[i]
        if isinstance(val, (int, float, np.generic, np.ndarray)):
            return float(np.min(np.asarray(val)))
        lit = _const_fold_floats(node.args[1 + i])
        if lit is not None:
            return float(np.min(lit))
        raise StanCompileError(
            f"ode_adjoint_tol_ctl {what} must be data (a literal or a "
            f"data-block value); parameters cannot set solver "
            f"tolerances", node.line, node.col,
        )

    rel = min(static_min(3, "rel_tol_forward"),
              static_min(5, "rel_tol_backward"),
              static_min(7, "rel_tol_quadrature"))
    ab = min(static_min(4, "abs_tol_forward"),
             static_min(6, "abs_tol_backward"),
             static_min(8, "abs_tol_quadrature"))
    mx = _static_scalar(args[9], node.args[10], node,
                        "ode_adjoint_tol_ctl max_num_steps")
    return _run_odeint(f, y0, t0, ts, rest, rel, ab, mx, node)


def _const_fold_floats(expr):
    """Constant-fold a tolerance expression: numeric literals, vector /
    row-vector / array literals of them, transposes, and unary minus.
    Returns a list of floats or None."""
    if isinstance(expr, A.Num):
        return [float(expr.value)]
    if isinstance(expr, A.Transpose):
        return _const_fold_floats(expr.operand)
    if isinstance(expr, A.UnaryOp) and expr.op == "-":
        inner = _const_fold_floats(expr.operand)
        return None if inner is None else [-v for v in inner]
    if isinstance(expr, (A.ArrayLit, A.RowVectorLit)):
        out = []
        for e in expr.elements:
            inner = _const_fold_floats(e)
            if inner is None:
                return None
            out.extend(inner)
        return out
    return None


# ------------------------------------------------------ algebra solvers

class _Newton:
    """Damped Newton on ``fun(y, *params) = 0`` for one call: inputs
    ``[y_guess [B, n], *params]`` (the floating leaves), output the root
    ``[B, n]``.  Each step solves with the Jacobian by forward mode and
    backtracks over the factors (1, 0.5, 0.25, 0.0625), while ``max|r| >
    f_tol`` and fewer than ``max_steps`` steps.  The backward is the
    implicit function theorem: ``J_y^T lam = y_bar``, then ``-vjp_params(f)
    (lam)`` (``lax.custom_root`` with ``tangent_solve`` in the JAX
    package); the guess gets no gradient."""

    def __init__(self, fun, rebuild, f_tol, max_steps):
        self.fun, self.rebuild = fun, rebuild
        self.f_tol, self.max_steps = f_tol, max_steps
        self.ev = xp.current()

    def _one(self, y, *p):
        return xp.asarray(self.fun(y, *self.rebuild(p))).to(y.dtype).reshape(-1)

    def resid(self, y, params):
        return _per_chain(self._one, y, *params)

    def jac(self, y, params):
        return _per_chain(jacfwd(self._one, argnums=0), y, *params)

    def forward(self, xs):
        y, *params = xs
        it = torch.zeros(y.shape[0], dtype=torch.int32, device=y.device)
        while True:
            r = self.resid(y, params)
            active = (torch.amax(torch.abs(r), -1) > self.f_tol) & (it < self.max_steps)
            if not bool(active.any()):
                break
            jac = self.jac(y, params)
            dy = torch.linalg.solve_ex(jac, r.unsqueeze(-1))[0].squeeze(-1)
            best_y, best_n = y, torch.sum(r * r, -1)
            for step in (1.0, 0.5, 0.25, 0.0625):
                cand = y - step * dy
                rc = self.resid(cand, params)
                n = torch.sum(rc * rc, -1)
                take = torch.isfinite(n) & (n < best_n)
                best_y = torch.where(take[:, None], cand, best_y)
                best_n = torch.where(take, n, best_n)
            y = torch.where(active[:, None], best_y, y)
            it = it + active.to(it.dtype)
        return y

    def backward(self, xs, y, g):
        _, *params = xs
        jac = self.jac(y, params)
        lam = torch.linalg.solve_ex(jac.mT, g.unsqueeze(-1))[0].squeeze(-1)
        _, grads = _vjp(lambda *p: self.resid(y, p), params, lam)
        return [None, *[-gr for gr in grads]]


def _newton_root(fun, y_guess, params, f_tol, max_steps):
    """The root of ``fun(y, *params)`` from ``y_guess`` (flattened, as
    ``lax.custom_root`` returns it)."""
    dt = xp.fdtype()
    y0 = xp.asarray(y_guess, dt).reshape(-1)
    floats, rebuild = _leaves(params)
    solver = _Newton(fun, rebuild, _tol_floor(f_tol, dt), int(max_steps))
    return _Solve.apply(solver, 0, y0, *floats)


def _algebra_solver(f, args, node, interp):
    # algebra_solver[_newton](f, y_guess, theta, x_r, x_i
    #                         [, rel_tol, f_tol, max_steps])
    if len(args) not in (4, 7):
        raise StanCompileError(
            "algebra_solver(f, y_guess, theta, x_r, x_i[, rel_tol, "
            "function_tol, max_num_steps])", node.line, node.col,
        )
    y_guess, theta, x_r, x_i = args[:4]
    f_tol = args[5] if len(args) == 7 else 1e-6
    max_steps = args[6] if len(args) == 7 else 200
    return _newton_root(lambda y, *p: f(y, *p), y_guess, [theta, x_r, x_i],
                        _static_scalar(f_tol, node.args[6] if len(args) == 7 else None,
                                       node, "function_tol"),
                        _static_scalar(max_steps, node.args[7] if len(args) == 7 else None,
                                       node, "max_num_steps"))


def _solve_newton(f, args, node, interp):
    # solve_newton(f, y_guess, ...args)
    if len(args) < 1:
        raise StanCompileError(
            "solve_newton(f, y_guess, ...)", node.line, node.col
        )
    y_guess, *rest = args
    return _newton_root(lambda y, *p: f(y, *p), y_guess, rest, 1e-6, 200)


def _solve_tol(name):
    def impl(f, args, node, interp):
        # solve_newton_tol(f, y_guess, scaling_step, f_tol, max_steps, ...)
        # solve_powell_tol(f, y_guess, rel_tol, f_tol, max_steps, ...)
        if len(args) < 4:
            second = "scaling_step" if name == "solve_newton_tol" else "rel_tol"
            raise StanCompileError(
                f"{name}(f, y_guess, {second}, function_tol, "
                "max_num_steps, ...)", node.line, node.col,
            )
        y_guess, _, f_tol, max_steps, *rest = args
        return _newton_root(lambda y, *p: f(y, *p), y_guess, rest,
                            _static_scalar(f_tol, node.args[4], node, "function_tol"),
                            _static_scalar(max_steps, node.args[5], node, "max_num_steps"))
    return impl


# ----------------------------------------------------------- DAE solvers

# the TR-BDF2 grid's substeps per output interval
DAE_MIN_SUBSTEPS, DAE_MAX_SUBSTEPS = 4, 256


def _dae_grid(t0, ts, rel_tol, f_tol):
    """``[(n_sub, wanted), ...]`` per output interval: the substeps the
    tolerance asks for (h ~ sqrt(rel_tol), 2nd-order global error ~ h^2 =
    rel_tol) and the clamp of them to ``[DAE_MIN_SUBSTEPS,
    DAE_MAX_SUBSTEPS]``.  ``None`` at the first interval that does not
    move forward."""
    h_target = max(np.sqrt(max(float(rel_tol), 1e-12)), 10 * f_tol)
    out, t_prev = [], t0
    for tk in ts:
        dt_int = float(tk) - t_prev
        if dt_int <= 0:
            return None
        wanted = int(np.ceil(dt_int / h_target))
        out.append((int(np.clip(wanted, DAE_MIN_SUBSTEPS, DAE_MAX_SUBSTEPS)), wanted))
        t_prev = float(tk)
    return out


def _warn_dae_clamp(interp, node, grid) -> None:
    """Warn, once per call site of an interpreter, where the clamp at
    ``DAE_MAX_SUBSTEPS`` cuts the substeps the tolerance asked for."""
    clamped = [wanted for n_sub, wanted in grid if wanted > n_sub]
    warned = interp.__dict__.setdefault("_dae_clamp_warned", set())
    if not clamped or (node.line, node.col) in warned:
        return
    warned.add((node.line, node.col))
    warnings.warn(
        f"{node.name} at line {node.line}, column {node.col}: the tolerance asks for "
        f"up to {max(clamped)} TR-BDF2 substeps an output interval, and the fixed grid "
        f"takes {DAE_MAX_SUBSTEPS} on {len(clamped)} of its {len(grid)} intervals; the "
        f"solution there is less accurate than rel_tol asks", stacklevel=2)


def _dae_times(t0, ts, node):
    t0f = _static_scalar(t0, None, node, "the dae initial time t0")
    if not isinstance(ts, (list, tuple, np.ndarray, int, float, np.generic)):
        raise StanCompileError("the dae output times must be data", node.line, node.col)
    return t0f, np.asarray(ts, float).reshape(-1)


def _run_dae(f, yy0, yp0, t0, ts, fargs, rel_tol, abs_tol, max_steps, node, interp):
    """Residual-form DAE integrator: fixed-grid TR-BDF2 (trapezoid + BDF2
    composite; 2nd order, L-stable, the SPICE/IDA workhorse for index-1
    systems) with each implicit stage solved by the damped Newton above,
    so gradients with respect to parameters in the residual, the initial
    state, or the derivative come from the implicit function theorem at
    every stage and autograd over the substeps.

    Stan's IDAS is adaptive; here the substep grid is fixed per output
    interval (``_dae_grid``); where the clamp at ``DAE_MAX_SUBSTEPS``
    acts, a warning names the substeps asked for.  ``max_num_steps``
    bounds the total substep budget as in Stan.
    """
    dt_ = xp.fdtype()
    y = xp.asarray(yy0, dt_).reshape(-1)
    yp = xp.asarray(yp0, dt_).reshape(-1)
    t0f, ts_np = _dae_times(t0, ts, node)
    f_tol = _tol_floor(abs_tol, dt_)
    grid = _dae_grid(t0f, ts_np, rel_tol, f_tol)
    if grid is None:
        raise StanCompileError(
            "dae output times must be strictly increasing and after "
            "t0", node.line, node.col,
        )
    if sum(n_sub for n_sub, _ in grid) > float(max_steps):
        raise StanCompileError(
            f"dae exceeds max_num_steps={int(float(max_steps))} on the fixed "
            f"TR-BDF2 grid; raise max_num_steps or loosen rel_tol",
            node.line, node.col,
        )
    _warn_dae_clamp(interp, node, grid)
    gamma = 2.0 - np.sqrt(2.0)

    def resid(t, yy, ypv, fa):
        return xp.asarray(f(t, yy, ypv, *fa)).to(dt_).reshape(-1)

    def trapezoid(tg, cg):
        # yp_g = cg (y_g - y_n) - yp_n
        return lambda yg, y_n, yp_n, *fa: resid(tg, yg, cg * (yg - y_n) - yp_n, fa)

    def bdf2(t1, w_n, w_g, w_1):
        # yp_1 = w_n y_n + w_g y_g + w_1 y_1
        return lambda y1, y_n, y_g, *fa: resid(t1, y1, w_n * y_n + w_g * y_g + w_1 * y1, fa)

    outs = []
    t_prev = t0f
    for tk, (n_sub, _) in zip(ts_np, grid):
        h = (float(tk) - t_prev) / n_sub
        # BDF2 differentiation weights at t_n + h for nodes
        # (t_n, t_n + gamma h, t_n + h)
        w_n = (1.0 - gamma) / (gamma * h)
        w_g = -1.0 / (gamma * (1.0 - gamma) * h)
        w_1 = (2.0 - gamma) / ((1.0 - gamma) * h)
        cg = 2.0 / (gamma * h)
        for i in range(n_sub):
            t_n = t_prev + float(i) * h
            y_g = _newton_root(trapezoid(t_n + gamma * h, cg), y + (gamma * h) * yp,
                               [y, yp, *fargs], f_tol, 50)
            yp_g = cg * (y_g - y) - yp
            y_1 = _newton_root(bdf2(t_n + h, w_n, w_g, w_1),
                               y_g + ((1.0 - gamma) * h) * yp_g, [y, y_g, *fargs], f_tol, 50)
            y, yp = y_1, w_n * y + w_g * y_g + w_1 * y_1
        outs.append(y)
        t_prev = float(tk)
    return xp.stack(outs) if outs else xp.zeros((0, y.shape[0]))


def _dae(f, args, node, interp):
    # dae(f, yy0, yp0, t0, ts, ...args); f(t, yy, yp, ...) -> residual
    if len(args) < 4:
        raise StanCompileError(
            "dae needs (f, yy0, yp0, t0, times, ...)", node.line, node.col
        )
    yy0, yp0, t0, ts, *rest = args
    return _run_dae(f, yy0, yp0, t0, ts, tuple(rest), 1e-10, 1e-10, 1e8,
                    node, interp)


def _dae_tols(args, node):
    return tuple(_static_scalar(args[4 + j], node.args[5 + j], node, f"dae_tol {what}")
                 for j, what in enumerate(("rel_tol", "abs_tol", "max_num_steps")))


def _dae_tol(f, args, node, interp):
    # dae_tol(f, yy0, yp0, t0, ts, rel_tol, abs_tol, max_num_steps, ...)
    if len(args) < 7:
        raise StanCompileError(
            "dae_tol needs (f, yy0, yp0, t0, times, rel_tol, abs_tol, "
            "max_num_steps, ...)", node.line, node.col,
        )
    yy0, yp0, t0, ts = args[:4]
    rel, ab, mx = _dae_tols(args, node)
    return _run_dae(f, yy0, yp0, t0, ts, tuple(args[7:]), rel, ab, mx, node, interp)


def check_dae_grids(interp) -> None:
    """When data are bound: every ``dae``/``dae_tol`` call whose times and
    tolerances are data-block values or literals warns here where the
    clamp acts (the others warn at their first evaluation)."""
    from .interpreter import Ctx

    def visit(node):
        if isinstance(node, A.Call) and node.name in ("dae", "dae_tol"):
            try:
                env, ctx = dict(interp.base_env), Ctx("logp")

                def arg(j):
                    return interp.eval_expr(node.args[1 + j], env, ctx)

                t0f, ts_np = _dae_times(arg(2), arg(3), node)
                rel, ab = ((_static_scalar(arg(j), node.args[1 + j], node, "dae_tol")
                            for j in (4, 5)) if node.name == "dae_tol" else (1e-10, 1e-10))
                grid = _dae_grid(t0f, ts_np, rel, _tol_floor(ab, torch.float64))
            except Exception:  # not data alone: checked where it runs
                grid = None
            if grid is not None:
                _warn_dae_clamp(interp, node, grid)
        for child in _children(node):
            visit(child)

    visit(interp.program)


def _children(node):
    if isinstance(node, (list, tuple)):
        return list(node)
    if hasattr(node, "__dataclass_fields__"):
        return [getattr(node, name) for name in node.__dataclass_fields__]
    return []


# ------------------------------------------------------------- dispatch

IMPLS = {
    "reduce_sum": _reduce_sum,
    "reduce_sum_static": _reduce_sum,
    "map_rect": _map_rect,
    "integrate_1d": _integrate_1d,
    # old (deprecated in Stan) array-interface: defaults per Stan math
    "integrate_ode": _make_ode(True, 1e-6, 1e-6, 1e6),
    "integrate_ode_rk45": _make_ode(True, 1e-6, 1e-6, 1e6),
    "integrate_ode_bdf": _make_ode(True, 1e-10, 1e-10, 1e8),
    "integrate_ode_adams": _make_ode(True, 1e-10, 1e-10, 1e8),
    # new variadic interface
    "ode_rk45": _make_ode(False, 1e-6, 1e-6, 1e6),
    "ode_rk45_tol": _make_ode_tol(1e6),
    "ode_bdf": _make_ode(False, 1e-10, 1e-10, 1e8),
    "ode_bdf_tol": _make_ode_tol(1e8),
    "ode_adams": _make_ode(False, 1e-10, 1e-10, 1e8),
    "ode_adams_tol": _make_ode_tol(1e8),
    "ode_ckrk": _make_ode(False, 1e-6, 1e-6, 1e6),
    "ode_ckrk_tol": _make_ode_tol(1e6),
    "ode_adjoint_tol_ctl": _ode_adjoint_tol_ctl,
    "dae": _dae,
    "dae_tol": _dae_tol,
    "algebra_solver": _algebra_solver,
    "algebra_solver_newton": _algebra_solver,
    "solve_newton": _solve_newton,
    "solve_newton_tol": _solve_tol("solve_newton_tol"),
    "solve_powell": _solve_newton,
    "solve_powell_tol": _solve_tol("solve_powell_tol"),
}

FUNCTIONAL_NAMES = frozenset(IMPLS)


def solver_calls(program) -> frozenset:
    """The looping functionals (``LOOPING``) the log density calls: those
    in the transformed parameters and model blocks, and in the user
    functions they call, transitively.  Decided from the program alone,
    before anything runs."""
    bodies = {fdef.name: fdef.body for fdef in program.functions}
    found, seen = set(), set()
    pending = [program.transformed_parameters, program.model]
    while pending:
        node = pending.pop()
        if isinstance(node, A.Call):
            if node.name in LOOPING:
                found.add(node.name)
            if node.name in bodies and node.name not in seen:
                seen.add(node.name)
                pending.append(bodies[node.name])
            if node.name in FUNCTIONAL_NAMES and node.args and isinstance(node.args[0], A.Var):
                name = node.args[0].name
                if name in bodies and name not in seen:
                    seen.add(name)
                    pending.append(bodies[name])
        pending.extend(_children(node))
    return frozenset(found)


def eval_functional(interp, name, node, env, ctx):
    """Resolve the function-valued first argument and dispatch.

    Called from the interpreter BEFORE normal argument evaluation (the
    first argument names a function, which is not a value in any
    environment)."""
    if not node.args:
        raise StanCompileError(
            f"{name!r} needs a function as its first argument",
            node.line, node.col,
        )
    fa = node.args[0]
    if not isinstance(fa, A.Var) or fa.name not in interp.functions:
        raise StanCompileError(
            f"the first argument of {name!r} must name a user-defined "
            f"function from the functions block",
            node.line, node.col,
        )
    ufn = interp.functions[fa.name]

    def f(*fargs):
        return ufn(ctx, *fargs)

    args = [interp.eval_expr(a, env, ctx) for a in node.args[1:]]
    return IMPLS[name](f, args, node, interp)
