"""Carry a chain state between the JAX package's layout and this package's.

The JAX package's ``NutsMachineState`` (diagonal adaptation) flattens to
named numpy arrays: ``rng_key`` (raw key data, ``jax.random.key_data``),
``vecs``, ``ckpt_p``, ``ckpt_s``, ``flts``, ``ints``, and the adaptation
leaves ``adapt.da.*``, ``adapt.adam.*``, ``adapt.inv_mass`` and
``adapt.{draws,grads}_{cur,bg}.{mean,m2,count}``, each with a leading
chains axis.  Under low-rank adaptation the JAX ``LowRankAdaptState``
adds ``adapt.metric.basis`` (``[C, dim, R]``, a ``LowRankMetric`` of
``basis [dim, R]`` per chain) and ``adapt.metric.log_eigs`` (``[C, R]``),
which map to the port's ``lr_basis`` and ``lr_log_eigs``.  With
``store_divergences`` the JAX ``vecs`` has 18 rows (the four divergence
rows after the 14) and is carried as it is, both ways.
``state_from_arrays`` packs such a dict into :class:`NutsMachineState`;
``state_to_arrays`` unpacks it again, so both packages can step the same
state and be compared array by array.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampler.state import (
    ADAPT_FLT_SLOTS,
    ADAPT_VEC_SLOTS,
    N_ADAPT_FLT,
    N_ADAPT_VEC,
    NutsMachineState,
)

# flat adaptation leaf name -> (packed tensor, slot)
ADAPT_LEAVES = {
    "adapt.da.log_step": ("flts", ADAPT_FLT_SLOTS["log_step"]),
    "adapt.da.log_step_bar": ("flts", ADAPT_FLT_SLOTS["log_step_bar"]),
    "adapt.da.hbar": ("flts", ADAPT_FLT_SLOTS["hbar"]),
    "adapt.da.mu": ("flts", ADAPT_FLT_SLOTS["mu"]),
    "adapt.da.count": ("flts", ADAPT_FLT_SLOTS["da_count"]),
    "adapt.adam.m": ("flts", ADAPT_FLT_SLOTS["adam_m"]),
    "adapt.adam.v": ("flts", ADAPT_FLT_SLOTS["adam_v"]),
    "adapt.adam.count": ("flts", ADAPT_FLT_SLOTS["adam_count"]),
    "adapt.inv_mass": ("vecs", ADAPT_VEC_SLOTS["inv_mass"]),
}
for _acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
    ADAPT_LEAVES[f"adapt.{_acc}.mean"] = ("vecs", ADAPT_VEC_SLOTS[f"{_acc}_mean"])
    ADAPT_LEAVES[f"adapt.{_acc}.m2"] = ("vecs", ADAPT_VEC_SLOTS[f"{_acc}_m2"])
    ADAPT_LEAVES[f"adapt.{_acc}.count"] = ("flts", ADAPT_FLT_SLOTS[f"{_acc}_count"])

STATE_LEAVES = ("vecs", "ckpt_p", "ckpt_s", "flts", "ints")
# the low-rank metric's leaves and the port's fields
METRIC_LEAVES = {"adapt.metric.basis": "lr_basis", "adapt.metric.log_eigs": "lr_log_eigs"}


def adapt_from_arrays(arrays: dict, device="cpu", dtype=torch.float64):
    """Pack the ``adapt.*`` leaves into ``(adapt_vecs, adapt_flts)``."""
    n, dim = np.shape(arrays["adapt.inv_mass"])
    adapt_vecs = torch.zeros((n, N_ADAPT_VEC, dim), dtype=dtype, device=device)
    adapt_flts = torch.zeros((n, N_ADAPT_FLT), dtype=dtype, device=device)
    for name, (kind, slot) in ADAPT_LEAVES.items():
        value = torch.as_tensor(np.array(arrays[name]), dtype=dtype, device=device)
        (adapt_vecs if kind == "vecs" else adapt_flts)[:, slot] = value
    return adapt_vecs, adapt_flts


def adapt_to_arrays(adapt_vecs: torch.Tensor, adapt_flts: torch.Tensor) -> dict:
    """Unpack ``(adapt_vecs, adapt_flts)`` into the ``adapt.*`` leaf names."""
    out = {}
    for name, (kind, slot) in ADAPT_LEAVES.items():
        src = adapt_vecs if kind == "vecs" else adapt_flts
        out[name] = src[:, slot].detach().cpu().numpy()
    return out


def state_from_arrays(arrays: dict, device="cpu", dtype=None) -> NutsMachineState:
    """Pack the JAX package's flattened state arrays into a port state."""
    vecs = np.asarray(arrays["vecs"])
    dtype = dtype or (torch.float64 if vecs.dtype == np.float64 else torch.float32)
    t = lambda a, dt=dtype: torch.as_tensor(np.array(a), dtype=dt, device=device)
    adapt_vecs, adapt_flts = adapt_from_arrays(arrays, device, dtype)
    metric = {field: t(arrays[leaf]) for leaf, field in METRIC_LEAVES.items()
              if leaf in arrays}
    return NutsMachineState(
        key=t(np.asarray(arrays["rng_key"]).astype(np.int64), torch.int64),
        adapt_vecs=adapt_vecs,
        adapt_flts=adapt_flts,
        vecs=t(arrays["vecs"]),
        ckpt_p=t(arrays["ckpt_p"]),
        ckpt_s=t(arrays["ckpt_s"]),
        flts=t(arrays["flts"]),
        ints=t(arrays["ints"], torch.int32),
        **metric,
    )


def state_to_arrays(state: NutsMachineState) -> dict:
    """Unpack a port state into the JAX package's flattened leaf names."""
    a = lambda x: x.detach().cpu().numpy()
    out = {"rng_key": a(state.key).astype(np.uint32)}
    for name in STATE_LEAVES:
        out[name] = a(getattr(state, name))
    out.update(adapt_to_arrays(state.adapt_vecs, state.adapt_flts))
    for leaf, field in METRIC_LEAVES.items():
        if getattr(state, field) is not None:
            out[leaf] = a(getattr(state, field))
    return out
