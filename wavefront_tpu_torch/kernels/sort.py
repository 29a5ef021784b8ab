"""Key / key-value sorting for inter-bounce ray coherence.

The reference ships a 4-pass LSD radix sorter (RADIX=256, 4096-element
partitions, upsweep/spine/downsweep GLSL kernels; reference
src/render_system/radix_sort/mod.rs:29-38 and shader/*.rs), a port of
jaesung-cs/vulkan_radix_sort, invoked between bounces as
`Sorter::sort_key_value` (interactive_rendering.rs:1095-1116).

The counterpart of `wavefront_tpu.kernels.sort`, which has no Pallas
kernel: the JAX package delegates to `lax.sort`, `cumsum` and a one-hot
sum, and so does this module, with `torch.sort(stable=True)`, `cumsum`
and one `bincount`.  (The port's digit-histogram kernel, K4, lives in
`kernels/radix_hist.py`; the renderer's bounce sort in
`render/renderer.py::coherence_sort`.)

Keys are uint32 values.  PyTorch has no uint32 arithmetic, so, as in
`core/rng.py`, a key tensor is int64 holding the unsigned value; an
int32 tensor is read as the bit pattern of uint32 keys (a negative
value is a key at or above 2^31).  Where the JAX functions return
uint32 (sorted keys, permutations), these return int64 holding the same
values; int32 stays int32.
"""

from __future__ import annotations

import torch


def _u32(keys: torch.Tensor) -> torch.Tensor:
    """uint32 keys as int64 values in [0, 2^32)."""
    if keys.dtype == torch.int64:
        return keys
    if keys.dtype == torch.int32:
        return keys.to(torch.int64) & 0xFFFFFFFF
    raise TypeError(f"sort: keys must be int64 (uint32 values) or int32 "
                    f"(uint32 bit patterns), not {keys.dtype}")


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of uint32 keys (reference radix_sort/mod.rs:166-204)."""
    return torch.sort(_u32(keys)).values


def sort_key_value(keys: torch.Tensor, values: torch.Tensor):
    """Ascending stable key-value sort (reference radix_sort/mod.rs:206-228).

    Returns (sorted_keys, permuted_values)."""
    s = torch.sort(_u32(keys), stable=True)
    return s.values, values[s.indices]


def sort_permutation(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that stably sorts `keys` ascending: an index array p
    with sorted[i] = input[p[i]].  Used to permute whole ray SoA batches by
    a single shared key."""
    return torch.sort(_u32(keys), stable=True).indices


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i (scatter of iota), in perm's dtype."""
    n = perm.shape[0]
    inv = torch.zeros(n, dtype=perm.dtype, device=perm.device)
    inv[perm.to(torch.int64)] = torch.arange(n, dtype=perm.dtype,
                                             device=perm.device)
    return inv


def exclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive prefix sum in x's dtype (the reference spine kernel's
    subgroup scan, radix_sort/shader/spine.rs:46-112)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype) - x


def segmented_histogram(keys: torch.Tensor, partition: int, radix_bits: int,
                        shift: int) -> torch.Tensor:
    """Per-partition digit histograms (the reference upsweep kernel,
    radix_sort/shader/upsweep.rs:45-81).

    keys: (N,) uint32 keys (module note), N divisible by `partition`.
    Returns (num_partitions, 2**radix_bits) int32 counts of digit
    (key >> shift) & (2**radix_bits - 1) per partition."""
    radix = 1 << radix_bits
    k = _u32(keys)
    if k.shape[0] % partition:
        raise ValueError(f"segmented_histogram: {k.shape[0]} keys do not "
                         f"split into partitions of {partition}")
    parts = k.shape[0] // partition
    digits = (k >> shift) & (radix - 1)
    row = torch.arange(k.shape[0], device=k.device) // partition
    counts = torch.bincount(row * radix + digits, minlength=parts * radix)
    return counts.reshape(parts, radix).to(torch.int32)
