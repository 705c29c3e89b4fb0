"""Array operations over torch for the Stan interpreter and math library.

The Stan library is written against this small array namespace (the
subset of ``numpy``'s names it needs, with ``special``, ``nn`` and
``linalg`` groups), so that each function reads as its formula.  Every
operation accepts python numbers, numpy arrays and torch tensors, and
returns torch tensors in the dtype and on the device of the running
evaluation (``evaluation``): float64 on the CPU in the tests, the dtype of
the sampler's positions on the card.

Host values enter the device without a copy per call: a python number is
filled on the device (``torch.full``: a kernel argument, not a transfer),
and a numpy array is copied once per evaluation cache (keyed by its
content; the interpreter keeps one cache per device and dtype).  A log
density built from these operations therefore copies nothing from the
host after its first call, which a CUDA graph capture requires.

Special functions torch lacks, or computes or differentiates less well
than the JAX library, are written here: ``log_ndtr`` (JAX's asymptotic
form), trigamma (a recurrence and series; torch's is off by about 1e-9),
``betainc`` (a continued fraction of a fixed number of terms; its
gradient is taken with respect to ``x`` only, as JAX's) and
``gammainc``/``gammaincc`` (torch's values, with a gradient in both
arguments).
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

pi = math.pi
e = math.e
inf = math.inf
nan = math.nan


class _Evaluation(threading.local):
    dtype = torch.float64
    device = torch.device("cpu")
    cache = None


_EV = _Evaluation()


@contextlib.contextmanager
def evaluation(dtype, device, cache=None):
    """Compute in ``dtype`` on ``device``; host arrays are uploaded once per
    ``cache`` (a dict owned by the caller)."""
    prev = (_EV.dtype, _EV.device, _EV.cache)
    _EV.dtype, _EV.device, _EV.cache = dtype, torch.device(device), cache
    try:
        yield
    finally:
        _EV.dtype, _EV.device, _EV.cache = prev


def fdtype() -> torch.dtype:
    """The float dtype of the running evaluation."""
    return _EV.dtype


def current() -> tuple:
    """``(dtype, device, cache)`` of the running evaluation, to re-enter it
    later (a solver's backward runs after the evaluation has ended)."""
    return _EV.dtype, _EV.device, _EV.cache


def _upload(arr: np.ndarray, dtype) -> torch.Tensor:
    cache = _EV.cache
    if cache is None:
        return torch.from_numpy(np.array(arr)).to(device=_EV.device, dtype=dtype)
    key = (dtype, arr.dtype.str, arr.shape, arr.tobytes())
    t = cache.get(key)
    if t is None:
        t = torch.from_numpy(np.array(arr)).to(device=_EV.device, dtype=dtype)
        cache[key] = t
    return t


def _torch_dtype_of(kind: str):
    if kind == "f":
        return _EV.dtype
    if kind in "iu":
        return torch.int64
    if kind == "b":
        return torch.bool
    raise TypeError(f"cannot hold a numpy array of kind {kind!r} as a tensor")


def asarray(x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor of the evaluation (``dtype`` overrides the kind's
    default: float -> the evaluation's dtype, integer -> int64)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None or x.dtype == dtype else x.to(dtype)
    if isinstance(x, (list, tuple)):
        return stack([asarray(v, dtype) for v in x])
    if isinstance(x, np.ndarray) and x.ndim > 0:
        return _upload(x, dtype or _torch_dtype_of(x.dtype.kind))
    if isinstance(x, (np.ndarray, np.generic)):
        x = x.item()
    if isinstance(x, bool):
        dt = torch.bool
    elif isinstance(x, int):
        dt = torch.int64
    elif isinstance(x, float):
        dt = _EV.dtype
    else:
        raise TypeError(f"cannot hold {type(x).__name__} as a tensor")
    return torch.full((), x, dtype=dtype or dt, device=_EV.device)


def _f(x) -> torch.Tensor:
    """``x`` as a floating tensor."""
    t = asarray(x)
    return t if t.is_floating_point() else t.to(_EV.dtype)


def shape(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    return np.shape(x)


def ndim(x) -> int:
    return len(shape(x))


def broadcast_shapes(*shapes) -> tuple:
    return tuple(torch.broadcast_shapes(*shapes))


# ------------------------------------------------------------ elementwise

def _unary(fn):
    return lambda x: fn(_f(x))


log = _unary(torch.log)
log1p = _unary(torch.log1p)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
exp = _unary(torch.exp)
exp2 = _unary(torch.exp2)
expm1 = _unary(torch.expm1)
sqrt = _unary(torch.sqrt)
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
arcsin = _unary(torch.asin)
arccos = _unary(torch.acos)
arctan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
arcsinh = _unary(torch.asinh)
arccosh = _unary(torch.acosh)
arctanh = _unary(torch.atanh)


def cbrt(x):
    x = _f(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def square(x):
    x = asarray(x)
    return x * x


def abs(x):  # noqa: A001  (numpy's name)
    return torch.abs(asarray(x))


def sign(x):
    return torch.sign(asarray(x))


def floor(x):
    x = asarray(x)
    return torch.floor(x) if x.is_floating_point() else x


def ceil(x):
    x = asarray(x)
    return torch.ceil(x) if x.is_floating_point() else x


def trunc(x):
    x = asarray(x)
    return torch.trunc(x) if x.is_floating_point() else x


def round(x):  # noqa: A001
    # numpy rounds halves to even, as torch.round does
    x = asarray(x)
    return torch.round(x) if x.is_floating_point() else x


def promote(a, b):
    """An integer tensor meeting a float, held in the evaluation's float
    dtype (torch would take its default float32 for an integer tensor and a
    python float, where JAX takes its float type); other operands as they
    are."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    fa = isinstance(a, float) or (ta and a.is_floating_point())
    fb = isinstance(b, float) or (tb and b.is_floating_point())
    if ta and fb and not a.is_floating_point():
        a = a.to(_EV.dtype)
    if tb and fa and not b.is_floating_point():
        b = b.to(_EV.dtype)
    return a, b


def _pair(a, b):
    a, b = asarray(a), asarray(b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def maximum(a, b):
    return torch.maximum(*_pair(a, b))


def minimum(a, b):
    return torch.minimum(*_pair(a, b))


def power(a, b):
    a, b = asarray(a), asarray(b)
    if not (a.is_floating_point() or b.is_floating_point()):
        return a ** b
    return _f(a) ** _f(b)


def hypot(a, b):
    return torch.hypot(*_pair(_f(a), _f(b)))


def arctan2(a, b):
    return torch.atan2(*_pair(_f(a), _f(b)))


def fmod(a, b):
    return torch.fmod(*_pair(a, b))


def mod(a, b):
    return torch.remainder(*_pair(a, b))


def logaddexp(a, b):
    return torch.logaddexp(*_pair(_f(a), _f(b)))


def copysign(a, b):
    return torch.copysign(*_pair(_f(a), _f(b)))


def isinf(x):
    return torch.isinf(asarray(x))


def logical_not(x):
    return torch.logical_not(asarray(x))


def logical_and(a, b):
    return torch.logical_and(asarray(a), asarray(b))


def logical_or(a, b):
    return torch.logical_or(asarray(a), asarray(b))


def where(cond, a, b):
    cond = asarray(cond)
    if cond.dtype != torch.bool:
        cond = cond != 0
    return torch.where(cond, *_pair(a, b))


def clip(x, lo, hi):
    x = asarray(x)
    return torch.clamp(x, lo, hi)


# --------------------------------------------------------- reductions

def _axis_reduce(fn, x, axis):
    x = asarray(x)
    if axis is None:
        return fn(x.reshape(-1), 0)
    return fn(x, axis)


def sum(x, axis=None):  # noqa: A001
    return _axis_reduce(torch.sum, x, axis)


def prod(x, axis=None):
    return _axis_reduce(torch.prod, x, axis)


def mean(x, axis=None):
    return _axis_reduce(torch.mean, _f(x), axis)


def max(x, axis=None):  # noqa: A001
    return _axis_reduce(lambda t, d: torch.amax(t, d), x, axis)


def min(x, axis=None):  # noqa: A001
    return _axis_reduce(lambda t, d: torch.amin(t, d), x, axis)


def std(x, ddof=0):
    return torch.std(_f(x).reshape(-1), correction=ddof)


def var(x, ddof=0):
    return torch.var(_f(x).reshape(-1), correction=ddof)


def cumsum(x, axis=None):
    return _axis_reduce(torch.cumsum, x, axis)


def diff(x, axis=-1):
    return torch.diff(asarray(x), dim=axis)


def sort(x, axis=-1):
    return torch.sort(asarray(x), dim=axis).values


def argsort(x, axis=-1):
    return torch.argsort(asarray(x), dim=axis, stable=True)


def flip(x, axis=0):
    return torch.flip(asarray(x), (axis,))


# ------------------------------------------------------- construction

def zeros(shape=(), dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.zeros(shape, dtype=dtype or _EV.dtype, device=_EV.device)


def ones(shape=(), dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.ones(shape, dtype=dtype or _EV.dtype, device=_EV.device)


def zeros_like(x):
    return torch.zeros_like(_f(x))


def full(shape, value, dtype=None):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.broadcast_to(asarray(value, dtype or _EV.dtype), shape).clone()


def arange(*args, dtype=None):
    if dtype is None:
        dtype = (_EV.dtype if any(isinstance(a, float) for a in args)
                 else torch.int64)
    return torch.arange(*args, dtype=dtype, device=_EV.device)


def linspace(a, b, n):
    n = int(n)
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        steps = torch.arange(n, dtype=_EV.dtype, device=_EV.device)
        a, b = _f(a), _f(b)
        step = (b - a) / (n - 1) if n > 1 else b - a
        out = a + steps * step
        return torch.cat([out[:-1], b.reshape(1)]) if n > 1 else a.reshape(1)
    return torch.linspace(float(a), float(b), n, dtype=_EV.dtype, device=_EV.device)


def eye(n):
    return torch.eye(int(n), dtype=_EV.dtype, device=_EV.device)


def stack(xs, axis=0):
    ts = [asarray(x) for x in xs]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.stack([t.to(dt) for t in ts], dim=axis)


def concatenate(xs, axis=0):
    ts = [asarray(x) for x in xs]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in ts], dim=axis)


def atleast_1d(x):
    x = asarray(x)
    return x.reshape(1) if x.ndim == 0 else x


def atleast_2d(x):
    x = asarray(x)
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        return x.reshape(1, -1)
    return x


def broadcast_to(x, shape):
    return torch.broadcast_to(asarray(x), tuple(shape))


def tile(x, reps):
    return asarray(x).repeat(*reps)


def ravel(x):
    return asarray(x).reshape(-1)


def swapaxes(x, a, b):
    return torch.transpose(asarray(x), a, b)


def diagonal(x, axis1=0, axis2=1):
    return torch.diagonal(asarray(x), dim1=axis1, dim2=axis2)


def diag(v):
    return torch.diag(asarray(v))


def trace(x):
    return torch.diagonal(asarray(x), dim1=-2, dim2=-1).sum(-1)


def outer(a, b):
    return torch.outer(*_pair(a, b))


def take(x, idx, axis=None):
    x, idx = asarray(x), asarray(idx)
    if axis is None:
        return x.reshape(-1)[idx]
    return torch.index_select(x, axis, idx.reshape(-1)).reshape(
        x.shape[:axis % x.ndim] + idx.shape + x.shape[axis % x.ndim + 1:])


def take_along_axis(x, idx, axis):
    return torch.take_along_dim(asarray(x), asarray(idx), axis)


def einsum(spec, *ops):
    return torch.einsum(spec, *[asarray(o) for o in ops])


def finfo(dtype):
    return torch.finfo(dtype)


# ---------------------------------------------------------------- nn

class nn:  # noqa: N801  (a namespace, as jax.nn)
    @staticmethod
    def softplus(x):
        # log(1 + e^x) without torch's switch to x above its threshold
        x = _f(x)
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))

    @staticmethod
    def sigmoid(x):
        return torch.sigmoid(_f(x))

    @staticmethod
    def log_sigmoid(x):
        return -nn.softplus(-_f(x))

    @staticmethod
    def softmax(x, axis=-1):
        return torch.softmax(_f(x), dim=axis)

    @staticmethod
    def log_softmax(x, axis=-1):
        return torch.log_softmax(_f(x), dim=axis)


# ------------------------------------------------------------ linalg

class linalg:  # noqa: N801
    @staticmethod
    def cholesky(a):
        # NaN where the matrix is not positive definite, as LAPACK via JAX
        L, info = torch.linalg.cholesky_ex(_f(a))
        bad = (info != 0)[..., None, None]
        return torch.where(bad, torch.full_like(L, nan), L)

    @staticmethod
    def solve_triangular(a, b, lower=False):
        a, b = _pair(_f(a), _f(b))
        if b.ndim == a.ndim - 1:
            return torch.linalg.solve_triangular(
                a, b.unsqueeze(-1), upper=not lower).squeeze(-1)
        return torch.linalg.solve_triangular(a, b, upper=not lower)

    @staticmethod
    def cho_solve(c_and_lower, b):
        c, lower = c_and_lower
        c, b = _pair(_f(c), _f(b))
        if b.ndim == c.ndim - 1:
            return torch.cholesky_solve(b.unsqueeze(-1), c, upper=not lower).squeeze(-1)
        return torch.cholesky_solve(b, c, upper=not lower)

    @staticmethod
    def solve(a, b):
        a, b = _pair(_f(a), _f(b))
        return torch.linalg.solve(a, b)

    @staticmethod
    def inv(a):
        return torch.linalg.inv(_f(a))

    @staticmethod
    def det(a):
        return torch.linalg.det(_f(a))

    @staticmethod
    def slogdet(a):
        return tuple(torch.linalg.slogdet(_f(a)))

    @staticmethod
    def eigh(a):
        return tuple(torch.linalg.eigh(_f(a)))

    @staticmethod
    def eigvalsh(a):
        return torch.linalg.eigvalsh(_f(a))

    @staticmethod
    def qr(a, mode="reduced"):
        return tuple(torch.linalg.qr(_f(a), mode=mode))

    @staticmethod
    def svd(a, full_matrices=True, compute_uv=True):
        if not compute_uv:
            return torch.linalg.svdvals(_f(a))
        return tuple(torch.linalg.svd(_f(a), full_matrices=full_matrices))

    @staticmethod
    def pinv(a):
        return torch.linalg.pinv(_f(a))

    @staticmethod
    def expm(a):
        return torch.linalg.matrix_exp(_f(a))


# ----------------------------------------------------------- special

_LOG_NDTR_LOWER = {torch.float64: -20.0, torch.float32: -10.0}
_LOG_NDTR_UPPER = {torch.float64: 8.0, torch.float32: 5.0}


def _ndtr(x):
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _log_ndtr_lower(x, series_order=3):
    x2 = x * x
    log_scale = -0.5 * x2 - torch.log(-x) - 0.5 * math.log(2.0 * math.pi)
    even = torch.zeros_like(x)
    odd = torch.zeros_like(x)
    x2n = x2
    for n in range(1, series_order + 1):
        y = float(np.prod(np.arange(2 * n - 1, 0, -2))) / x2n
        if n % 2:
            odd = odd + y
        else:
            even = even + y
        x2n = x2n * x2
    return log_scale + torch.log(1.0 + even - odd)


class _LogNdtr(torch.autograd.Function):
    """``log Phi(x)`` as JAX computes it (three segments), with JAX's
    derivative ``exp(log phi(x) - log Phi(x))``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        lo = _LOG_NDTR_LOWER.get(x.dtype, -20.0)
        hi = _LOG_NDTR_UPPER.get(x.dtype, 8.0)
        return torch.where(
            x > hi, -_ndtr(-x),
            torch.where(x > lo, torch.log(_ndtr(torch.clamp(x, min=lo))),
                        _log_ndtr_lower(torch.clamp(x, max=lo))))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        log_pdf = -0.5 * x * x - 0.5 * math.log(2.0 * math.pi)
        return g * torch.exp(log_pdf - ans)


# terms of the incomplete beta's continued fraction: enough for a and b
# into the thousands in float64 (the fraction converges in O(sqrt(max(a, b)))
# terms); a fixed count keeps the evaluation free of host syncs
BETAINC_TERMS = 300
_TINY = 1e-300


def _betainc_cf(a, b, x):
    """I_x(a, b) by the modified Lentz continued fraction, evaluated where
    it converges fast (x < (a + 1) / (a + b + 2)) and by symmetry elsewhere."""
    tiny = _TINY if x.dtype == torch.float64 else 1e-30
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    qab = aa + bb
    qap = aa + 1.0
    qam = aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 - qab * xx / qap
    d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, BETAINC_TERMS + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 + num * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + num / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 + num * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + num / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    inner = torch.clamp(xx, tiny, 1.0)
    log_front = (aa * torch.log(inner) + bb * torch.log1p(-torch.clamp(xx, 0.0, 1.0 - 1e-16))
                 - _betaln(aa, bb) - torch.log(aa))
    val = torch.exp(log_front) * h
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x <= 0.0, torch.zeros_like(val), val)
    val = torch.where(x >= 1.0, torch.ones_like(val), val)
    bad = (a <= 0.0) | (b <= 0.0) | (x < 0.0) | (x > 1.0) | torch.isnan(a + b + x)
    return torch.where(bad, torch.full_like(val, nan), val)


class _Betainc(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, x):
        return _betainc_cf(a, b, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.needs = ctx.needs_input_grad

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs[0] or ctx.needs[1]:
            raise ValueError("Betainc gradient with respect to a and b not supported.")
        log_pdf = ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - _betaln(a, b))
        return None, None, g * torch.exp(log_pdf)


def _gammainc_da(a, x, upper: bool):
    """d/da of the regularized incomplete gamma function by a
    fourth-order central difference in float64 (torch differentiates
    ``igamma`` in x only)."""
    a64, x64 = a.to(torch.float64), x.to(torch.float64)
    h = 1e-3 * a64
    f = torch.special.gammaincc if upper else torch.special.gammainc
    d = (8.0 * (f(a64 + h, x64) - f(a64 - h, x64))
         - (f(a64 + 2.0 * h, x64) - f(a64 - 2.0 * h, x64))) / (12.0 * h)
    return d.to(a.dtype)


class _Gammainc(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(a, x, upper):
        return torch.special.gammaincc(a, x) if upper else torch.special.gammainc(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x, upper = inputs
        ctx.save_for_backward(a, x)
        ctx.upper = upper

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        gx = ga = None
        if ctx.needs_input_grad[1]:
            gx = g * sign * torch.exp((a - 1.0) * torch.log(x) - x - torch.lgamma(a))
        if ctx.needs_input_grad[0]:
            ga = g * _gammainc_da(a, x, ctx.upper)
        return ga, gx, None


def _betaln(a, b):
    # the sum of log-gammas, accurate to rounding where scipy's betaln is
    # the reference (JAX's branch for b >= 8, scipy's ``algdiv`` series
    # alone, is off by up to 3e-7 relative near b = 8; ROADMAP queue 3)
    return torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))


# the trigamma function: the recurrence psi1(x) = psi1(x + 1) + 1/x^2 lifts
# x to at least _TRIGAMMA_SHIFT in as many fixed steps, then the asymptotic
# series to x^-15 (torch's polygamma(1, x) is off by about 1e-9 relative)
_TRIGAMMA_SHIFT = 10
_TRIGAMMA_SERIES = (1.0 / 6.0, -1.0 / 30.0, 1.0 / 42.0, -1.0 / 30.0, 5.0 / 66.0,
                    -691.0 / 2730.0, 7.0 / 6.0)


def _trigamma(x):
    acc = torch.zeros_like(x)
    for _ in range(_TRIGAMMA_SHIFT):
        low = x < _TRIGAMMA_SHIFT
        acc = acc + torch.where(low, 1.0 / (x * x), torch.zeros_like(x))
        x = torch.where(low, x + 1.0, x)
    inv = 1.0 / x
    inv2 = inv * inv
    series = torch.zeros_like(x)
    for c in reversed(_TRIGAMMA_SERIES):
        series = series * inv2 + c
    return acc + inv + 0.5 * inv2 + inv * inv2 * series


class _Digamma(torch.autograd.Function):
    """torch's digamma, differentiated by ``_trigamma``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.digamma(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _trigamma(x)


class special:  # noqa: N801  (a namespace, as jax.scipy.special)
    @staticmethod
    def gammaln(x):
        return torch.lgamma(_f(x))

    @staticmethod
    def betaln(a, b):
        return _betaln(*_pair(_f(a), _f(b)))

    @staticmethod
    def digamma(x):
        return _Digamma.apply(_f(x))

    @staticmethod
    def polygamma(n, x):
        x = _f(x)
        # positive arguments of trigamma by the series; the rest as torch
        if int(n) == 1:
            return torch.where(x > 0, _trigamma(torch.where(x > 0, x, 1.0)),
                               torch.polygamma(1, x))
        return torch.polygamma(int(n), x)

    @staticmethod
    def multigammaln(a, d):
        a = _f(a)
        js = torch.arange(d, dtype=a.dtype, device=a.device)
        return (d * (d - 1) / 4.0 * math.log(math.pi)
                + torch.lgamma(a.unsqueeze(-1) - js / 2.0).sum(-1))

    @staticmethod
    def erf(x):
        return torch.erf(_f(x))

    @staticmethod
    def erfc(x):
        return torch.erfc(_f(x))

    @staticmethod
    def erfinv(x):
        return torch.erfinv(_f(x))

    @staticmethod
    def ndtr(x):
        return _ndtr(_f(x))

    @staticmethod
    def ndtri(p):
        return torch.special.ndtri(_f(p))

    @staticmethod
    def log_ndtr(x):
        return _LogNdtr.apply(_f(x))

    @staticmethod
    def i0e(x):
        return torch.special.i0e(_f(x))

    @staticmethod
    def logit(x):
        x = _f(x)
        return torch.log(x / (1.0 - x))

    @staticmethod
    def logsumexp(x, axis=None):
        x = _f(x)
        if axis is None:
            x, axis = x.reshape(-1), 0
        return torch.logsumexp(x, axis)

    @staticmethod
    def betainc(a, b, x):
        a, b, x = torch.broadcast_tensors(*(_f(v) for v in (a, b, x)))
        dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), x.dtype)
        return _Betainc.apply(a.to(dt), b.to(dt), x.to(dt))

    @staticmethod
    def gammainc(a, x):
        a, x = torch.broadcast_tensors(*_pair(_f(a), _f(x)))
        return _Gammainc.apply(a, x, False)

    @staticmethod
    def gammaincc(a, x):
        a, x = torch.broadcast_tensors(*_pair(_f(a), _f(x)))
        return _Gammainc.apply(a, x, True)
