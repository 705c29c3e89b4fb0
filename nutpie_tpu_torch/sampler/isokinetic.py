"""The isokinetic dynamics' metric products and velocity update, batched
over chains: the pieces MCLMC (``mclmc.py``) and NUTS's microcanonical
kinetic (``nuts.py``) share, as ``nutpie_tpu/sampler/mclmc.py:102-139``.

With ``A A^T = M^{-1} = D^{1/2}(I + U(L - 1)U^T)D^{1/2}``, ``A = D^{1/2}(I +
U(sqrt(L) - 1)U^T)``: the dynamics run on a unit velocity ``u`` in the
preconditioned space, the position moves along ``A u`` and a model-space
gradient enters as ``A^T g``.  Under the diagonal metric ``basis`` and
``log_eigs`` are None.
"""

from __future__ import annotations

import torch

from .low_rank import _basis_vec, _vec_basis


def iso_metric(cfg, s) -> tuple:
    """``(inv_mass, basis, log_eigs)`` of state ``s`` for the products below
    (the factors under ``cfg.low_rank``, else None)."""
    if cfg.low_rank is not None:
        return s.inv_mass, s.lr_basis, s.lr_log_eigs
    return s.inv_mass, None, None


def apply_A(inv_mass, basis, log_eigs, u):
    """x-space velocity from preconditioned-space ``u [C, dim]``: ``A u`` with
    ``A A^T = M^{-1}``, ``A = D^{1/2}(I + U(sqrt(L) - 1)U^T)``."""
    s = torch.sqrt(inv_mass)
    if basis is None:
        return s * u
    coeff = (torch.exp(0.5 * log_eigs) - 1.0) * _vec_basis(u, basis)
    return s * (u + _basis_vec(basis, coeff))


def apply_At(inv_mass, basis, log_eigs, g):
    """A model-space gradient pulled into the preconditioned space: ``A^T g``."""
    w = torch.sqrt(inv_mass) * g
    if basis is None:
        return w
    coeff = (torch.exp(0.5 * log_eigs) - 1.0) * _vec_basis(w, basis)
    return w + _basis_vec(basis, coeff)


def update_velocity(u, g_z, step, dim: int):
    """Exact isokinetic velocity update for time ``step [C]`` under ``g_z``:

    u' = (u + e(sinh d + (cosh d - 1) <e,u>)) / (cosh d + <e,u> sinh d),
    e = -g_z/|g_z|, d = step |g_z| / (dim - 1), normalized; the
    kinetic-energy weight change is (dim - 1) log(cosh d + <e,u> sinh d).
    Returns ``(u' [C, dim], dke [C])``.
    """
    g_norm = torch.sqrt(torch.sum(g_z * g_z, dim=-1))
    g_norm = torch.clamp(g_norm, min=1e-30)
    e = -g_z / g_norm[:, None]
    delta = step * g_norm / (dim - 1)
    ue = torch.sum(u * e, dim=-1)
    ch = torch.cosh(delta)
    sh = torch.sinh(delta)
    denom = ch + ue * sh
    u_new = (u + e * (sh + (ch - 1.0) * ue)[:, None]) / denom[:, None]
    u_new = u_new / torch.sqrt(torch.sum(u_new * u_new, dim=-1))[:, None]
    dke = (dim - 1) * torch.log(denom)
    return u_new, dke
