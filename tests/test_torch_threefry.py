"""Threefry streams of the torch port against ``jax.random``.

Bits and uniforms must be identical (float32 and float64, which draws
64-bit words).  Normals go through ``erfinv``: the port evaluates XLA's
polynomial, so float32 normals agree to 4 ULP; in float64 XLA's CPU
``log1p`` is itself up to 128 ULP off the correctly rounded value
(measured against numpy), which the polynomial carries into normals that
agree to 64 ULP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nutpie_tpu_torch.ops import threefry as tf
from nutpie_tpu_torch.sampler.nuts import LeapfrogUniformTable, leapfrog_uniforms
from nutpie_tpu_torch.sampler.run import chain_keys, draw_randoms

torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _kd(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _ulp(ref: np.ndarray, got: np.ndarray) -> float:
    return float(np.max(np.abs(ref - got) / np.spacing(np.abs(ref).astype(ref.dtype))))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**40 + 5])
def test_key_and_fold_in(seed):
    key = jax.random.key(seed)
    np.testing.assert_array_equal(tf.key(seed).numpy(), np.asarray(jax.random.key_data(key)))
    for data in (0, 1, 3, 7, 1000, 2**31 - 1, 2**32 - 1):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        np.testing.assert_array_equal(tf.fold_in_data(tf.key(seed), data).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 5, 999])
def test_uniform3_and_uniform1(seed):
    key = jax.random.key(seed)
    for step in (0, 1, 17, 4096):
        ku = jax.random.fold_in(jax.random.fold_in(key, 3), step)
        ref3 = np.asarray(jax.random.uniform(ku, (3,), jnp.float32))
        ours = tf.uniform3(tf.fold_in_data(tf.fold_in_data(tf.key(seed), 3), step))
        np.testing.assert_array_equal(ours.numpy(), ref3)
        ref1 = np.asarray(jax.random.uniform(ku, (), jnp.float32))
        np.testing.assert_array_equal(tf.uniform1(_kd(ku)).numpy(), ref1)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_uniform_bits_exact(jdt, tdt):
    for seed in (0, 3, 77):
        key = jax.random.key(seed)
        ref = np.asarray(jax.random.uniform(key, (9, 37), jdt, -2.0, 2.0))
        got = tf.uniform(tf.key(seed), (9, 37), tdt, -2.0, 2.0).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("jdt,tdt,max_ulp", [
    (jnp.float32, torch.float32, 4.0), (jnp.float64, torch.float64, 64.0),
])
def test_normal_within_ulp(jdt, tdt, max_ulp):
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(11), i))(jnp.arange(16))
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2000,), jdt))(keys))
    got = tf.normal(_kd(keys), (2000,), tdt).numpy()
    assert got.dtype == ref.dtype
    assert _ulp(ref, got) <= max_ulp


def test_chain_keys_and_draw_randoms_match_run_py():
    C, L, dim, start = 4, 5, 7, 33
    master = jax.random.key(42)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(master, i))(jnp.arange(C))
    keys = chain_keys(42, C, "cpu")
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jax.random.key_data(jkeys)))
    draw_ids = start + jnp.arange(L, dtype=jnp.int32)

    def per_chain(k):
        mb, jb = jax.random.fold_in(k, 1), jax.random.fold_in(k, 2)
        mom = jax.vmap(lambda d: jax.random.normal(jax.random.fold_in(mb, d), (dim,), jnp.float64))(draw_ids)
        jit = jax.vmap(lambda d: jax.random.uniform(jax.random.fold_in(jb, d), (), jnp.float64))(draw_ids)
        return mom, jit

    mom_ref, jit_ref = jax.vmap(per_chain)(jkeys)
    mom, jit = draw_randoms(keys, start, L, dim, torch.float64)
    np.testing.assert_array_equal(jit.numpy(), np.asarray(jit_ref))
    assert _ulp(np.asarray(mom_ref), mom.numpy()) <= 64.0


def test_leapfrog_uniform_table_matches_direct_stream():
    keys = chain_keys(7, 3, "cpu")
    table = LeapfrogUniformTable(keys, window=8)
    total = torch.tensor([0, 5, 100], dtype=torch.int32)
    for step in range(20):
        ts = total + torch.tensor([step, step // 2, 3 * step], dtype=torch.int32)
        np.testing.assert_array_equal(
            table(keys, ts, torch.float64).numpy(),
            leapfrog_uniforms(keys, ts, torch.float64).numpy(),
        )
    ref = jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(jax.random.key(7), 1), 3), 9),
        (3,), jnp.float32,
    )
    got = leapfrog_uniforms(keys[1:2], torch.tensor([9], dtype=torch.int32), torch.float32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
