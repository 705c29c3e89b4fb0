"""Helpers shared by the ``test_torch_*`` parity tests.

The tests build the same model and state in both packages in one process:
JAX on the CPU with x64 (``conftest.py``), torch on the CPU in float64,
passing data between them as numpy arrays.
"""

from __future__ import annotations

import jax
import numpy as np
import torch


def jax_state_arrays(state) -> dict:
    """Flatten a JAX ``NutsMachineState`` (diagonal or low-rank adaptation)
    for ``convert``."""
    key = state.rng_key
    if getattr(key, "dtype", None) != np.uint32:
        key = jax.random.key_data(key)
    out = {"rng_key": np.asarray(key)}
    for name in ("vecs", "ckpt_p", "ckpt_s", "flts", "ints"):
        out[name] = np.asarray(getattr(state, name))
    a = state.adapt
    for f in ("log_step", "log_step_bar", "hbar", "mu", "count"):
        out[f"adapt.da.{f}"] = np.asarray(getattr(a.da, f))
    for f in ("m", "v", "count"):
        out[f"adapt.adam.{f}"] = np.asarray(getattr(a.adam, f))
    out["adapt.inv_mass"] = np.asarray(a.inv_mass)
    for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg"):
        w = getattr(a, acc)
        for f in ("mean", "m2", "count"):
            out[f"adapt.{acc}.{f}"] = np.asarray(getattr(w, f))
    if hasattr(a, "metric"):
        out["adapt.metric.basis"] = np.asarray(a.metric.basis)
        out["adapt.metric.log_eigs"] = np.asarray(a.metric.log_eigs)
    return out


def jax_state_from_arrays(template, arrays: dict):
    """Rebuild a JAX ``NutsMachineState`` of ``template``'s structure from
    flattened arrays (the inverse of ``jax_state_arrays``)."""
    import jax.numpy as jnp

    a = template.adapt
    welford = {acc: getattr(a, acc)._replace(**{
        f: jnp.asarray(arrays[f"adapt.{acc}.{f}"]) for f in ("mean", "m2", "count")})
        for acc in ("draws_cur", "grads_cur", "draws_bg", "grads_bg")}
    adapt = a._replace(
        da=a.da._replace(**{f: jnp.asarray(arrays[f"adapt.da.{f}"])
                            for f in ("log_step", "log_step_bar", "hbar", "mu", "count")}),
        adam=a.adam._replace(**{f: jnp.asarray(arrays[f"adapt.adam.{f}"])
                                for f in ("m", "v", "count")}),
        inv_mass=jnp.asarray(arrays["adapt.inv_mass"]),
        **welford,
    )
    if hasattr(a, "metric"):
        adapt = adapt._replace(metric=a.metric._replace(
            basis=jnp.asarray(arrays["adapt.metric.basis"]),
            log_eigs=jnp.asarray(arrays["adapt.metric.log_eigs"])))
    key = template.rng_key
    raw = jnp.asarray(arrays["rng_key"], jnp.uint32)
    if getattr(key, "dtype", None) != np.uint32:
        raw = jax.random.wrap_key_data(raw)
    return template._replace(
        rng_key=raw, adapt=adapt,
        **{name: jnp.asarray(arrays[name]) for name in ("vecs", "ckpt_p", "ckpt_s", "flts", "ints")},
    )


def t64(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def assert_state_close(port_arrays: dict, jax_arrays: dict, rtol: float,
                       atol: float = 0.0) -> None:
    """Ints and keys exact; every float leaf to the given tolerance."""
    assert port_arrays.keys() == jax_arrays.keys()
    for name, ref in jax_arrays.items():
        got = port_arrays[name]
        if name in ("ints", "rng_key"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
