"""Low-rank modified diagonal mass matrix, batched over chains.

The port's copy of ``nutpie_tpu/sampler/low_rank.py`` (the reference's
experimental ``adaptation="low_rank"``): the diagonal (gradient-based)
estimate is extended with a low-rank correction that captures posterior
correlations,

    M^{-1} = D^{1/2} (I + U (Lambda - I) U^T) D^{1/2},

with ``D`` the diagonal inverse mass, ``U [dim, R]`` orthonormal columns
and ``Lambda`` their eigenvalues; unused slots are padded with
``lambda = 1`` (``log_eigs = 0``, basis column 0), exact no-ops.  Every
function here carries a leading chains axis ``C``: the metric of C
chains is the pair ``basis [C, dim, R]``, ``log_eigs [C, R]``.

``estimate_low_rank`` recomputes the correction at a chunk boundary from
the chunk's draws and gradients, per chain and in the state's dtype, in
the JAX function's arithmetic order (regularization, the nan-to-num of
the window, the geometric mean ``S = A^{1/2} (A^{1/2} B A^{1/2})^{-1/2}
A^{1/2}``, selection by ``|log lambda|`` under a stable ``argsort(-score)``,
padding with ``lambda = 1``).  QR and eigh are library linear algebra here
as they are XLA's in the JAX package.  Eigenvectors are defined up to sign
(and rotation within equal eigenvalues), so two metrics compare through
``implied_matrix``, never column by column.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LowRankMetric(NamedTuple):
    basis: torch.Tensor     # [C, dim, R] orthonormal columns (padded 0)
    log_eigs: torch.Tensor  # [C, R] log eigenvalues (padded 0 -> lambda 1)


def identity_metric(n_chains: int, dim: int, max_rank: int, dtype,
                    device=None) -> LowRankMetric:
    return LowRankMetric(
        basis=torch.zeros((n_chains, dim, max_rank), dtype=dtype, device=device),
        log_eigs=torch.zeros((n_chains, max_rank), dtype=dtype, device=device),
    )


def _vec_basis(v: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``v @ basis`` per chain: ``[C, dim] x [C, dim, R] -> [C, R]``."""
    return torch.bmm(v[:, None, :], basis)[:, 0]


def _basis_vec(basis: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``basis @ c`` per chain: ``[C, dim, R] x [C, R] -> [C, dim]``."""
    return torch.bmm(basis, c[:, :, None])[:, :, 0]


def lr_velocity(inv_mass, basis, log_eigs, p):
    """v = M^{-1} p = D^{1/2}(I + U(L-1)U^T)D^{1/2} p, per chain ([C, dim])."""
    s = torch.sqrt(inv_mass)
    w = s * p
    coeff = (torch.exp(log_eigs) - 1.0) * _vec_basis(w, basis)
    return s * (w + _basis_vec(basis, coeff))


def lr_velocity_rows(inv_mass, basis, log_eigs, P):
    """Row-batched velocity for the checkpoint checks (``P [C, k, dim]``)."""
    s = torch.sqrt(inv_mass)[:, None, :]
    W = P * s
    coeff = torch.bmm(W, basis) * (torch.exp(log_eigs) - 1.0)[:, None, :]
    return (W + torch.bmm(coeff, basis.transpose(1, 2))) * s


def lr_sample_momentum(inv_mass, basis, log_eigs, gauss):
    """p = M^{1/2} z with M^{1/2} = D^{-1/2}(I + U(L^{-1/2}-1)U^T)."""
    coeff = (torch.exp(-0.5 * log_eigs) - 1.0) * _vec_basis(gauss, basis)
    return (gauss + _basis_vec(basis, coeff)) / torch.sqrt(inv_mass)


def implied_matrix(basis: torch.Tensor, log_eigs: torch.Tensor) -> torch.Tensor:
    """``U diag(exp(log_eigs) - 1) U^T`` per chain, invariant to the sign of
    each column: the quantity two metrics are compared by."""
    return torch.bmm(basis * (torch.exp(log_eigs) - 1.0)[:, None, :],
                     basis.transpose(1, 2))


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[c, ..., idx[c, j]]`` for every chain c and selection j."""
    idx = idx.reshape(idx.shape[:1] + (1,) * (x.dim() - 2) + idx.shape[1:])
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + idx.shape[-1:]))


def estimate_low_rank(draws, grads, valid, inv_mass, max_rank: int,
                      eigval_cutoff: float, gamma: float) -> LowRankMetric:
    """The low-rank correction of C chains from one adaptation window each.

    ``draws`` and ``grads`` are ``[C, W, dim]``, ``valid [C, W]`` bool,
    ``inv_mass [C, dim]`` the diagonal estimate.
    """
    n_chains, W, dim = draws.shape
    dtype = draws.dtype
    validf = valid.to(dtype)[:, :, None]
    cnt = torch.clamp(torch.sum(validf, dim=(1, 2)), min=2.0)[:, None, None]

    s = torch.sqrt(inv_mass)[:, None, :]
    X = torch.nan_to_num(draws / s) * validf
    G = torch.nan_to_num(grads * s) * validf
    X = (X - torch.sum(X, dim=1, keepdim=True) / cnt) * validf
    G = (G - torch.sum(G, dim=1, keepdim=True) / cnt) * validf

    # orthonormal basis of the combined span (rank <= 2W)
    M = torch.cat([X, G], dim=1)                             # [C, 2W, dim]
    q, _ = torch.linalg.qr(M.transpose(1, 2), mode="reduced")  # [C, dim, r]
    r = q.shape[2]

    Xq = torch.bmm(X, q)                                     # [C, W, r]
    Gq = torch.bmm(G, q)
    eye = torch.eye(r, dtype=dtype, device=draws.device)
    A = torch.bmm(Xq.transpose(1, 2), Xq) / (cnt - 1.0) + gamma * eye
    B = torch.bmm(Gq.transpose(1, 2), Gq) / (cnt - 1.0) + gamma * eye

    # geometric mean S = A^{1/2} (A^{1/2} B A^{1/2})^{-1/2} A^{1/2}
    wa, va = torch.linalg.eigh(A)
    wa = torch.maximum(wa, torch.full_like(wa, gamma))
    a_half = torch.bmm(va * torch.sqrt(wa)[:, None, :], va.transpose(1, 2))
    Cm = torch.bmm(torch.bmm(a_half, B), a_half)
    wc, vc = torch.linalg.eigh(Cm)
    wc = torch.maximum(wc, torch.full_like(wc, gamma * gamma))
    c_inv_half = torch.bmm(vc * (wc ** -0.5)[:, None, :], vc.transpose(1, 2))
    S = torch.bmm(torch.bmm(a_half, c_inv_half), a_half)

    wl, vl = torch.linalg.eigh(S)                            # ascending
    wl = torch.maximum(wl, torch.full_like(wl, 1e-12))
    log_wl = torch.log(wl)
    score = torch.abs(log_wl)
    keepable = score > torch.log(torch.tensor(eigval_cutoff, dtype=dtype))

    # the (up to max_rank) largest |log lambda| among the keepable; a
    # stable sort, as jnp.argsort, so ties keep the same vectors
    k = min(max_rank, r)
    sel = torch.argsort(-score, dim=1, stable=True)[:, :k]
    sel_keep = torch.gather(keepable, 1, sel)
    sel_logw = torch.where(sel_keep, torch.gather(log_wl, 1, sel),
                           torch.zeros((), dtype=dtype, device=draws.device))
    sel_vecs = torch.where(sel_keep[:, None, :], _gather_last(vl, sel),
                           torch.zeros((), dtype=dtype, device=draws.device))

    basis = torch.bmm(q, sel_vecs)                           # [C, dim, k]
    if k < max_rank:
        pad = max_rank - k
        basis = torch.cat([basis, basis.new_zeros((n_chains, dim, pad))], dim=2)
        sel_logw = torch.cat([sel_logw, sel_logw.new_zeros((n_chains, pad))], dim=1)
    return LowRankMetric(basis=basis.to(dtype).contiguous(),
                         log_eigs=sel_logw.to(dtype).contiguous())
