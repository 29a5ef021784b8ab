"""The port's murmur3 hash (wavefront_tpu_torch.core.rng) against the JAX
package's (wavefront_tpu.core.rng), bit for bit.

The port carries 32-bit hashes as int64 tensors holding the unsigned
value (PyTorch on the CPU has no right shift for uint32), so every result
is compared as uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.core import rng as jrng
from wavefront_tpu_torch.core import rng

N = 100_000
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _u32(seed):
    v = np.random.default_rng(seed).integers(0, 2 ** 32, N, dtype=np.uint64)
    v = v.astype(np.uint32)
    v[:len(EDGES)] = EDGES
    return v


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def _as_u32(x):
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def test_combine_bitexact():
    h, k = _u32(0), _u32(1)
    want = jrng.murmur3_combine(jnp.asarray(h), jnp.asarray(k))
    got = rng.combine(_t(h), _t(k))
    np.testing.assert_array_equal(_as_u32(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF, 123456789])
def test_combine_scalar_seed_bitexact(seed):
    # the renderer's form: one invocation seed against every pixel id
    k = _u32(2)
    want = jrng.murmur3_combine(jnp.uint32(seed), jnp.asarray(k))
    got = rng.combine(seed, _t(k))
    np.testing.assert_array_equal(_as_u32(got), np.asarray(want))


def test_finalize_bitexact():
    h = _u32(3)
    want = jrng.murmur3_finalize(jnp.asarray(h))
    got = rng.finalize(_t(h))
    np.testing.assert_array_equal(_as_u32(got), np.asarray(want))


def test_finalizef_bitexact():
    h = _u32(4)
    want = np.asarray(jrng.murmur3_finalizef(jnp.asarray(h)))
    got = rng.finalizef(_t(h)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_float_construct_bitexact():
    m = _u32(5)
    want = np.asarray(jrng.float_construct(jnp.asarray(m)))
    got = rng.float_construct(_t(m)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_draw_chain_bitexact():
    # the shade's draw chain: finalizef(combine(combine(seed, rid), i))
    rid = _u32(6)
    for i in (0, 2, 3, 4, 5):
        want = jrng.murmur3_finalizef(jrng.murmur3_combine(
            jrng.murmur3_combine(jnp.uint32(11), jnp.asarray(rid)),
            jnp.uint32(i)))
        got = rng.finalizef(rng.combine(rng.combine(11, _t(rid)), i))
        np.testing.assert_array_equal(
            got.numpy().view(np.uint32), np.asarray(want).view(np.uint32),
            err_msg=f"draw {i}")
