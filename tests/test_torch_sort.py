"""The port's sort utilities (`wavefront_tpu_torch.kernels.sort`) against
the JAX package's (`wavefront_tpu.kernels.sort`, tests/test_sort.py).

The same seeded uint32 keys go to both: numpy uint32 to JAX, int64
holding the same values to the port (int32 bit patterns once, for keys
at or past 2^31).  Every output is held exactly, and its dtype to the
JAX one's counterpart: JAX uint32 is the port's int64, int32 is int32.
Sizes include non-powers of two and keys at or past 2^31.
"""

import numpy as np
import pytest
import torch

from wavefront_tpu.kernels import sort as jsort
from wavefront_tpu_torch.kernels import sort as psort

# the port's dtype for each JAX output dtype
DTYPE = {np.dtype(np.uint32): torch.int64, np.dtype(np.int32): torch.int32,
         np.dtype(np.float32): torch.float32}


def keys_of(n, seed, hi=2 ** 32):
    rs = np.random.RandomState(seed)
    return rs.randint(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == DTYPE[want.dtype], (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy().astype(np.int64)
                                  if want.dtype == np.uint32 else got.numpy(),
                                  want.astype(np.int64)
                                  if want.dtype == np.uint32 else want)


def t64(keys):
    return torch.from_numpy(keys.astype(np.int64))


@pytest.mark.parametrize("n,hi", [(10, 256), (4096, 1000), (65_537, 2 ** 32),
                                  (300_001, 2 ** 32)])
def test_sort_keys(n, hi):
    keys = keys_of(n, n, hi)
    assert hi < 2 ** 31 or (keys >= 2 ** 31).any()
    same(psort.sort_keys(t64(keys)), jsort.sort_keys(keys))


def test_sort_keys_int32_bit_patterns():
    """int32 keys are read as uint32 bit patterns: negative ones sort last."""
    keys = keys_of(5003, 7)
    got = psort.sort_keys(torch.from_numpy(keys.view(np.int32)))
    same(got, jsort.sort_keys(keys))


@pytest.mark.parametrize("n", [10, 4097, 200_003])
def test_sort_key_value(n):
    keys = keys_of(n, n + 1, 2 ** 32 if n > 10 else 8)   # ties when small
    vals = np.arange(n, dtype=np.int32)[::-1].copy()
    k, v = psort.sort_key_value(t64(keys), torch.from_numpy(vals))
    jk, jv = jsort.sort_key_value(keys, vals)
    same(k, jk)
    same(v, jv)


@pytest.mark.parametrize("n", [7, 4096, 100_003])
def test_sort_permutation_and_inverse(n):
    keys = keys_of(n, 3 * n, 1000)                       # many ties
    perm = psort.sort_permutation(t64(keys))
    jperm = jsort.sort_permutation(keys)
    same(perm, jperm)
    same(psort.invert_permutation(perm), jsort.invert_permutation(jperm))
    p32 = perm.to(torch.int32)
    same(psort.invert_permutation(p32),
         jsort.invert_permutation(np.asarray(jperm).astype(np.int32)))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_exclusive_scan(dtype):
    rs = np.random.RandomState(5)
    x = rs.randint(0, 100, size=(3, 1001)).astype(dtype)
    for axis in (-1, 0):
        same(psort.exclusive_scan(torch.from_numpy(x), axis=axis),
             jsort.exclusive_scan(x, axis=axis))
    small = np.array([3, 1, 4, 1, 5], np.int32)
    np.testing.assert_array_equal(
        psort.exclusive_scan(torch.from_numpy(small)).numpy(), [0, 3, 4, 8, 9])


@pytest.mark.parametrize("partition,bits,shift", [(4096, 8, 0), (1000, 8, 24),
                                                  (777, 4, 28), (64, 8, 8)])
def test_segmented_histogram(partition, bits, shift):
    keys = keys_of(partition * 5, partition)
    got = psort.segmented_histogram(t64(keys), partition, bits, shift)
    want = jsort.segmented_histogram(keys, partition=partition,
                                     radix_bits=bits, shift=shift)
    assert tuple(got.shape) == (5, 1 << bits)
    same(got, want)


def test_segmented_histogram_rejects_ragged_keys():
    with pytest.raises(ValueError):
        psort.segmented_histogram(torch.arange(10), 4, 8, 0)
