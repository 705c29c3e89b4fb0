"""Threefry-2x32 in torch, bit-equal to ``jax.random``'s default generator.

The sampler's streams are defined by ``jax.random`` in the JAX package:
chain keys ``fold_in(key(seed), chain)``, per-draw momentum normals and
jitter uniforms, and three uniforms per leapfrog step.  This module
reproduces them from raw key data, so both packages draw the same numbers
from the same seed:

- ``key(seed)``: raw key data ``[seed >> 32, seed & 0xFFFFFFFF]``.
- ``threefry2x32``: the 20-round hash.
- ``fold_in_data``: ``jax.random.fold_in`` on raw key data (hash of the
  counts ``(0, data)``).
- ``random_bits32`` / ``random_bits64``: the partitionable bit generator
  (per element the hash of ``(0, flat_index)``; 32-bit words xor-fold the
  two halves, 64-bit words concatenate them).
- ``uniform`` and ``normal``: mantissa randomization into ``[1, 2) - 1``,
  scaled to ``[minval, maxval)``; normals are ``sqrt(2) * erfinv(u)`` with
  ``u`` uniform on ``(-1, 1)``.  float32 draws 32-bit words and float64
  draws 64-bit words.

Key data is held in int64 tensors with values in ``[0, 2**32)``.  All hash
arithmetic runs in int64 masked with ``0xFFFFFFFF``: torch has no uint32
add or shift on the CPU.  The CUDA kernel carries its own copy of the hash
(``csrc/threefry.cuh``) for the per-leapfrog uniforms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def key(seed: int, device=None) -> torch.Tensor:
    """Raw key data of ``jax.random.key(seed)`` (int64 ``[2]``)."""
    seed = int(seed)
    return torch.tensor(
        [(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64, device=device
    )


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x0, x1):
    """20-round Threefry-2x32 hash of counts ``(x0, x1)`` under ``(k1, k2)``.

    All arguments are int64 tensors (or ints) holding uint32 values; they
    broadcast elementwise.  Returns ``(y0, y1)``.
    """
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    rots = (_ROT_A, _ROT_B)
    for block in range(5):
        for r in rots[block % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & MASK32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & MASK32
    return x0, x1


def fold_in_data(kd: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on raw key data ``kd [..., 2]``.

    ``data`` is an int or an integer tensor broadcastable against
    ``kd[..., 0]``; it is taken modulo 2**32 as JAX casts it to uint32.
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=kd.device) & MASK32
    y0, y1 = threefry2x32(kd[..., 0], kd[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _counts(kd: torch.Tensor, shape) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key words broadcast against flat element indices of ``shape``."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=kd.device).reshape(shape)
    extra = (1,) * len(shape)
    k1 = kd[..., 0].reshape(kd.shape[:-1] + extra)
    k2 = kd[..., 1].reshape(kd.shape[:-1] + extra)
    return k1, k2, lo


def random_bits32(kd: torch.Tensor, shape) -> torch.Tensor:
    """32-bit words of ``jax.random.bits(key, shape, uint32)``; ``[..., *shape]``."""
    k1, k2, lo = _counts(kd, tuple(shape))
    b0, b1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b0 ^ b1


def _mantissa64(kd: torch.Tensor, shape) -> torch.Tensor:
    """Top 52 bits of the 64-bit words of ``jax.random.bits(key, shape, uint64)``.

    The 64-bit word is ``hi << 32 | lo``; ``word >> 12`` is computed without
    leaving int64 as ``hi << 20 | lo >> 12``.
    """
    k1, k2, lo = _counts(kd, tuple(shape))
    b0, b1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (b0 << 20) | (b1 >> 12)


def bits_to_uniform(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Mantissa randomization of 32-bit words into float32 ``[0, 1)``, cast to dtype."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return (fb.view(torch.float32) - 1.0).to(dtype)


def _unit_uniform(kd: torch.Tensor, shape, dtype) -> torch.Tensor:
    if dtype == torch.float64:
        fb = _mantissa64(kd, shape) | 0x3FF0000000000000
        return fb.view(torch.float64) - 1.0
    if dtype == torch.float32:
        return bits_to_uniform(random_bits32(kd, shape))
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


def uniform(kd: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` per key.

    ``kd`` is ``[..., 2]`` key data; the result is ``[..., *shape]``.
    """
    shape = tuple(shape)
    lo = torch.tensor(minval, dtype=dtype, device=kd.device)
    hi = torch.tensor(maxval, dtype=dtype, device=kd.device)
    floats = _unit_uniform(kd, shape, dtype)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# Giles' polynomial approximations of erfinv, in the form XLA expands
# ``erf_inv`` into (chlo legalization): w = -log1p(-x^2), one polynomial per
# range of w, evaluated by Horner's rule in the working type.
_ERFINV32_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV32_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356,
)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635,
)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221,
)


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """Inverse error function as XLA computes it (float32 and float64)."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt5 = w < 5.0
        p = torch.where(
            lt5,
            _horner(_ERFINV32_LT5, w - 2.5),
            _horner(_ERFINV32_GE5, torch.sqrt(w) - 3.0),
        )
    else:
        lt625 = w < 6.25
        lt16 = w < 16.0
        p = torch.where(
            lt625,
            _horner(_ERFINV64_LT625, w - 3.125),
            torch.where(
                lt16,
                _horner(_ERFINV64_LT16, torch.sqrt(w) - 3.25),
                _horner(_ERFINV64_GE16, torch.sqrt(w) - 5.0),
            ),
        )
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(kd: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` per key (``[..., *shape]``).

    Bits and uniforms are exact; ``erfinv`` follows XLA's expansion, so
    values agree to a few ULP (the host's ``log1p`` and operation fusion
    may round differently).
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0)))
    u = uniform(kd, shape, dtype, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=dtype, device=kd.device) * erfinv(u)


def uniform1(kd: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32)`` per key (``[...]``)."""
    return bits_to_uniform(random_bits32(kd, ()))


def uniform3(kd: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (3,), float32)`` per key (``[..., 3]``)."""
    return bits_to_uniform(random_bits32(kd, (3,)))
