"""Chain state of the vectorized NUTS machine, packed into a few tensors.

Every field carries a leading chains axis ``C``.  The slot maps are those
of ``nutpie_tpu/sampler/state.py``: the 14 per-chain ``[dim]`` trajectory
vectors live in ``vecs [C, 14, dim]`` (``[C, 18, dim]`` with the four
divergence-location rows of ``store_divergences``), the float scalars in
``flts [C, 12]`` and the integer/boolean scalars in ``ints [C, 15]``
(int32, booleans as 0/1).  The adaptation state is packed the same way:
``adapt_vecs [C, 9, dim]`` (inverse mass plus four Welford mean/m2 pairs)
and ``adapt_flts [C, 12]`` (dual averaging, Adam, Welford counts).  That
gives the CUDA kernels one flat ABI: seven tensors plus the key data.
Under low-rank adaptation the state also carries the metric's factors
(``lr_basis [C, dim, R]``, ``lr_log_eigs [C, R]``; the JAX package's
``LowRankAdaptState.metric``); they are None under the diagonal metric.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# [dim]-vector slots of vecs.  The first 12 are trajectory state reset at
# each draw start; position/gradient persist across draws.
VEC_SLOTS = {
    "z_minus": 0,
    "p_minus": 1,
    "g_minus": 2,
    "z_plus": 3,
    "p_plus": 4,
    "g_plus": 5,
    "rho": 6,
    "rho_sub": 7,
    "prop_z": 8,
    "prop_g": 9,
    "sprop_z": 10,
    "sprop_g": 11,
    "position": 12,
    "gradient": 13,
}
# divergence-location rows, appended only when store_divergences is set
DIV_SLOTS = {
    "div_start": 14,
    "div_start_grad": 15,
    "div_end": 16,
    "div_mom": 17,
}
N_VEC_BASE = 14
N_VEC_DIV = 18

# float scalar slots of flts
FLT_SLOTS = {
    "logp": 0,
    "eps": 1,
    "h0": 2,
    "logw_traj": 3,
    "prop_logp": 4,
    "prop_energy": 5,
    "logw_sub": 6,
    "sprop_logp": 7,
    "sprop_energy": 8,
    "sum_acc": 9,
    # microcanonical kinetic-weight accumulators (unused under exact_normal)
    "ke_minus": 10,
    "ke_plus": 11,
}
N_FLT = 12

# integer / boolean scalar slots of ints (int32; booleans as 0/1)
INT_SLOTS = {
    "draw_idx": 0,
    "prop_idx": 1,
    "depth": 2,
    "direction": 3,
    "left_idx": 4,
    "right_idx": 5,
    "n_leaves": 6,
    "n_leaf": 7,
    "sprop_idx": 8,
    "ckpt_top": 9,
    "total_steps": 10,
    "divergence_count": 11,
    "diverging": 12,
    "turning_sub": 13,
    "done": 14,
}
N_INT = 15

# [dim]-vector slots of adapt_vecs
ADAPT_VEC_SLOTS = {
    "inv_mass": 0,
    "draws_cur_mean": 1,
    "draws_cur_m2": 2,
    "grads_cur_mean": 3,
    "grads_cur_m2": 4,
    "draws_bg_mean": 5,
    "draws_bg_m2": 6,
    "grads_bg_mean": 7,
    "grads_bg_m2": 8,
}
N_ADAPT_VEC = 9

# scalar slots of adapt_flts: dual averaging (5), Adam (3), Welford counts (4)
ADAPT_FLT_SLOTS = {
    "log_step": 0,
    "log_step_bar": 1,
    "hbar": 2,
    "mu": 3,
    "da_count": 4,
    "adam_m": 5,
    "adam_v": 6,
    "adam_count": 7,
    "draws_cur_count": 8,
    "grads_cur_count": 9,
    "draws_bg_count": 10,
    "grads_bg_count": 11,
}
N_ADAPT_FLT = 12

# the four Welford accumulators: (mean slot, m2 slot, count slot)
WELFORD = {
    name: (ADAPT_VEC_SLOTS[f"{name}_mean"], ADAPT_VEC_SLOTS[f"{name}_m2"],
           ADAPT_FLT_SLOTS[f"{name}_count"])
    for name in ("draws_cur", "grads_cur", "draws_bg", "grads_bg")
}


@dataclasses.dataclass
class NutsMachineState:
    """Complete state of the flattened NUTS machine for C chains."""

    key: torch.Tensor         # [C, 2] int64 raw Threefry key data
    adapt_vecs: torch.Tensor  # [C, 9, dim]
    adapt_flts: torch.Tensor  # [C, 12]
    vecs: torch.Tensor        # [C, 14, dim], or [C, 18, dim] with the divergence rows
    ckpt_p: torch.Tensor      # [C, D, dim] momentum at checkpoint leaves
    ckpt_s: torch.Tensor      # [C, D, dim] momentum prefix-sum before ckpt leaf
    flts: torch.Tensor        # [C, 12]
    ints: torch.Tensor        # [C, 15] int32
    # the low-rank metric (None under the diagonal metric)
    lr_basis: Optional[torch.Tensor] = None     # [C, dim, R] orthonormal columns
    lr_log_eigs: Optional[torch.Tensor] = None  # [C, R] log eigenvalues

    def replace(self, **changes) -> "NutsMachineState":
        return dataclasses.replace(self, **changes)

    def clone(self) -> "NutsMachineState":
        return NutsMachineState(**{k: v.clone() for k, v in self.tensors().items()})

    def tensors(self) -> dict:
        """Every tensor of the state by field name (absent metric left out)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @property
    def position(self):
        return self.vecs[:, VEC_SLOTS["position"]]

    @property
    def gradient(self):
        return self.vecs[:, VEC_SLOTS["gradient"]]

    @property
    def logp(self):
        return self.flts[:, FLT_SLOTS["logp"]]

    @property
    def eps(self):
        return self.flts[:, FLT_SLOTS["eps"]]

    @property
    def draw_idx(self):
        return self.ints[:, INT_SLOTS["draw_idx"]]

    @property
    def total_steps(self):
        return self.ints[:, INT_SLOTS["total_steps"]]

    @property
    def divergence_count(self):
        return self.ints[:, INT_SLOTS["divergence_count"]]

    @property
    def done(self):
        return self.ints[:, INT_SLOTS["done"]] > 0

    @property
    def inv_mass(self):
        return self.adapt_vecs[:, ADAPT_VEC_SLOTS["inv_mass"]]

    def adapt_flt(self, name: str) -> torch.Tensor:
        return self.adapt_flts[:, ADAPT_FLT_SLOTS[name]]


def state_with(state: NutsMachineState, *, position=None, gradient=None,
               logp=None, done=None) -> NutsMachineState:
    """Targeted writes into the packed state (chunk-boundary updates)."""
    vecs, flts, ints = state.vecs, state.flts, state.ints
    if position is not None or gradient is not None:
        vecs = vecs.clone()
        if position is not None:
            vecs[:, VEC_SLOTS["position"]] = position
        if gradient is not None:
            vecs[:, VEC_SLOTS["gradient"]] = gradient
    if logp is not None:
        flts = flts.clone()
        flts[:, FLT_SLOTS["logp"]] = logp
    if done is not None:
        ints = ints.clone()
        ints[:, INT_SLOTS["done"]] = torch.as_tensor(done, dtype=torch.int32)
    return state.replace(vecs=vecs, flts=flts, ints=ints)


def where(pred: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-chain select: ``pred [C]`` broadcast over trailing dims."""
    pred = pred.reshape(pred.shape + (1,) * (new.dim() - pred.dim()))
    return torch.where(pred, new, old)


def tree_where(pred: torch.Tensor, a: NutsMachineState,
               b: NutsMachineState) -> NutsMachineState:
    """Per-chain select between two states."""
    other = b.tensors()
    return NutsMachineState(
        **{name: where(pred, t, other[name]) for name, t in a.tensors().items()}
    )
