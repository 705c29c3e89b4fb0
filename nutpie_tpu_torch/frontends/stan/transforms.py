"""Constraint transforms: unconstrained slice -> constrained value + logJ.

Implements Stan's reference-manual transforms (lower/upper bounds, offset/
multiplier, simplex stick-breaking, ordered, unit_vector, correlation/
covariance Cholesky factors, sum_to_zero) so posteriors match BridgeStan's
unconstrained parameterization semantics (reference ``src/stan.rs:449-520``
relies on these living in the Stan C++ model; here they are explicit torch,
batched over array elements with ``torch.func.vmap``).

Each transform reports its unconstrained size for a given constrained shape
and returns ``(value, log_jacobian)``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import vmap

from . import xp


def _c(v):
    """A constraint bound as an operand: python numbers stay numbers,
    host arrays and tensors become tensors of the evaluation."""
    return v if isinstance(v, (int, float)) else xp.asarray(v)


def identity_transform(shape):
    n = int(math.prod(shape)) if shape else 1

    def forward(u):
        return u.reshape(shape), xp.zeros(())

    return n, forward


def lower_bound(shape, lb):
    n = int(math.prod(shape)) if shape else 1

    def forward(u):
        u = u.reshape(shape)
        return _c(lb) + xp.exp(u), xp.sum(u)

    return n, forward


def upper_bound(shape, ub):
    n = int(math.prod(shape)) if shape else 1

    def forward(u):
        u = u.reshape(shape)
        return _c(ub) - xp.exp(u), xp.sum(u)

    return n, forward


def lower_upper(shape, lb, ub):
    n = int(math.prod(shape)) if shape else 1

    def forward(u):
        u = u.reshape(shape)
        lb_, ub_ = _c(lb), _c(ub)
        inv = xp.nn.sigmoid(u)
        value = lb_ + (ub_ - lb_) * inv
        logj = xp.sum(
            xp.log(ub_ - lb_) - xp.nn.softplus(u) - xp.nn.softplus(-u)
        )
        return value, logj

    return n, forward


def offset_multiplier(shape, offset, multiplier):
    n = int(math.prod(shape)) if shape else 1

    def forward(u):
        u = u.reshape(shape)
        off, mult = _c(offset), _c(multiplier)
        logj = xp.sum(xp.broadcast_to(xp.log(mult), u.shape))
        return off + mult * u, logj

    return n, forward


def simplex(k: int):
    """Stick-breaking: K-1 unconstrained -> K-simplex (Stan ref manual)."""
    n = k - 1

    def forward(u):
        zk = xp.nn.sigmoid(u - xp.log(xp.arange(k - 1, 0, -1.0)))
        # x_i = z_i * (1 - sum_{j<i} x_j), in the scan's order
        rem = xp.ones((), u.dtype)
        parts = []
        for i in range(k - 1):
            x = zk[i] * rem
            rem = rem - x
            parts.append(x)
        xs = torch.stack(parts) if parts else zk
        value = xp.concatenate([xs, rem[None]])
        logj = xp.sum(
            xp.log(zk) + xp.log1p(-zk)
            + xp.log(xp.concatenate([xp.ones(1, u.dtype), 1.0 - xp.cumsum(xs)[:-1]]))
        )
        return value, logj

    return n, forward


def ordered(k: int):
    n = k

    def forward(u):
        first = u[0]
        rest = xp.exp(u[1:])
        value = xp.concatenate([first[None], first + xp.cumsum(rest)])
        return value, xp.sum(u[1:])

    return n, forward


def positive_ordered(k: int):
    n = k

    def forward(u):
        value = xp.cumsum(xp.exp(u))
        return value, xp.sum(u)

    return n, forward


def unit_vector(k: int):
    n = k

    def forward(u):
        norm = xp.sqrt(xp.sum(u * u))
        value = u / norm
        # Stan adds -0.5 * ||u||^2 to the target for unit_vector
        return value, -0.5 * xp.sum(u * u)

    return n, forward


def sum_to_zero_vector(k: int):
    """Isometric zero-sum transform (Stan's sum_to_zero_vector).

    Implemented with a Householder orthonormal basis of the zero-sum
    subspace.  Any isometry onto that subspace yields the same distribution
    over the constrained vector (they differ by a rotation of the
    unconstrained space), so this matches Stan's semantics with a constant
    (zero) log-Jacobian.
    """
    import numpy as _np

    n = k - 1
    v = _np.full(k, 1.0 / _np.sqrt(k))
    v[0] -= 1.0
    v /= _np.linalg.norm(v)
    basis = (_np.eye(k) - 2.0 * _np.outer(v, v))[:, 1:]

    def forward(u):
        return xp.asarray(basis, u.dtype) @ u, xp.zeros((), u.dtype)

    return n, forward


def cholesky_factor_corr(k: int):
    n = k * (k - 1) // 2

    def forward(u):
        z = xp.tanh(u)
        zero = xp.zeros((), u.dtype)
        rows = [[xp.ones((), u.dtype)] + [zero] * (k - 1)]
        logj = xp.zeros((), u.dtype)
        idx = 0
        for i in range(1, k):
            row = [zero] * k
            rem = xp.ones((), u.dtype)
            for j in range(i):
                zij = z[idx]
                lij = zij * xp.sqrt(rem)
                row[j] = lij
                # d l_ij / d z_ij = sqrt(rem); d z / d u = 1 - z^2
                logj = logj + 0.5 * xp.log(rem) + xp.log1p(-zij * zij)
                rem = rem - lij * lij
                idx += 1
            row[i] = xp.sqrt(rem)
            rows.append(row)
        return torch.stack([torch.stack(r) for r in rows]), logj

    return n, forward


def cholesky_factor_cov(k: int, m: int | None = None):
    m = k if m is None else m
    if k != m:
        raise NotImplementedError("non-square cholesky_factor_cov")
    n = k * (k + 1) // 2

    def forward(u):
        zero = xp.zeros((), u.dtype)
        rows = []
        idx = 0
        logj = xp.zeros((), u.dtype)
        for i in range(k):
            row = [zero] * k
            for j in range(i):
                row[j] = u[idx]
                idx += 1
            d = u[idx]
            row[i] = xp.exp(d)
            logj = logj + d
            idx += 1
            rows.append(row)
        return torch.stack([torch.stack(r) for r in rows]), logj

    return n, forward


def cov_matrix(k: int):
    n_unc, chol_fwd = cholesky_factor_cov(k)

    def forward(u):
        L, logj = chol_fwd(u)
        value = L @ L.T
        # jacobian of LL^T given L: K log 2 + sum (K - i + 1) log L_ii
        diag = xp.diagonal(L)
        weights = xp.arange(k, 0, -1, dtype=u.dtype)
        logj = logj + k * xp.log(2.0) + xp.sum(weights * xp.log(diag))
        return value, logj

    return n_unc, forward


def corr_matrix(k: int):
    n_unc, chol_fwd = cholesky_factor_corr(k)

    def forward(u):
        L, logj = chol_fwd(u)
        # Change of variables L -> LL^T for a unit-row-norm Cholesky factor:
        # log|J| = sum_j (K-1-j) * log L_jj (Stan reference manual, corr_matrix
        # transform), on top of the cholesky_factor_corr Jacobian.
        diag = xp.diagonal(L)
        weights = xp.arange(k - 1, -1, -1, dtype=u.dtype)
        logj = logj + xp.sum(weights * xp.log(diag))
        return L @ L.T, logj

    return n_unc, forward


def make_transform(base: str, shape: tuple[int, ...], constraints: dict,
                   dims: tuple[int, ...]) -> tuple[int, Callable]:
    """Resolve (unconstrained size, forward fn) for one parameter.

    ``shape`` is the full constrained shape (array dims + type dims);
    ``dims`` are the type dims only (e.g. the K of a simplex).
    """
    if base in ("int",):
        raise ValueError("integer parameters are not allowed in Stan")
    array_shape = shape[: len(shape) - len(dims)] if dims else shape

    def batched(per_elem_size, per_elem_fwd):
        n_batch = int(math.prod(array_shape)) if array_shape else 1
        total = n_batch * per_elem_size

        def forward(u):
            us = u.reshape((n_batch, per_elem_size))
            vals, logjs = vmap(per_elem_fwd)(us)
            vals = vals.reshape(array_shape + vals.shape[1:])
            return vals, xp.sum(logjs)

        if not array_shape:
            def forward_scalar(u):
                return per_elem_fwd(u)
            return per_elem_size, forward_scalar
        return total, forward

    if base in ("real", "vector", "row_vector", "matrix"):
        lb = constraints.get("lower")
        ub = constraints.get("upper")
        off = constraints.get("offset")
        mult = constraints.get("multiplier")
        if off is not None or mult is not None:
            n, fwd = offset_multiplier(
                shape, 0.0 if off is None else off, 1.0 if mult is None else mult
            )
        elif lb is not None and ub is not None:
            n, fwd = lower_upper(shape, lb, ub)
        elif lb is not None:
            n, fwd = lower_bound(shape, lb)
        elif ub is not None:
            n, fwd = upper_bound(shape, ub)
        else:
            n, fwd = identity_transform(shape)
        if base == "row_vector":
            inner = fwd

            def fwd_row(u):
                v, logj = inner(u)
                return v.reshape(1, -1) if v.ndim == 1 else v, logj

            # row_vector shape bookkeeping: constrained shape (1, n)
            return n, fwd_row
        return n, fwd

    if base == "simplex":
        return batched(*simplex(dims[0]))
    if base == "ordered":
        return batched(*ordered(dims[0]))
    if base == "positive_ordered":
        return batched(*positive_ordered(dims[0]))
    if base == "unit_vector":
        return batched(*unit_vector(dims[0]))
    if base == "sum_to_zero_vector":
        return batched(*sum_to_zero_vector(dims[0]))
    if base == "cholesky_factor_corr":
        return batched(*cholesky_factor_corr(dims[0]))
    if base == "cholesky_factor_cov":
        return batched(*cholesky_factor_cov(*dims))
    if base == "corr_matrix":
        return batched(*corr_matrix(dims[0]))
    if base == "cov_matrix":
        return batched(*cov_matrix(dims[0]))
    raise ValueError(f"unsupported parameter type: {base}")
