"""Radix-sort digit histograms: the CUDA kernel `csrc/radix_hist.cu` and
its plain PyTorch version `hist_plain`.

Replaces the TPU kernel `tools/radix_lab.py::hist_kernel` (called by
`hist_pass()`): the 256-bin histogram of one 8-bit digit of 32-bit keys,
the upsweep of an LSD radix sort, and `radix_hist`, the four passes with
their prefix-sum spine.  The TPU kernel counts in float32 through a
one-hot matrix product over zero-padded 2048-key tiles; the port counts
the keys it is given, in int32, with no padding (so its bin 0 lacks the
pad keys the TPU kernel adds there).

Keys are unsigned 32-bit values carried bit for bit in an `int32` tensor
(PyTorch has no arithmetic on uint32); `as_key_bits` makes that form from
the int64-carried u32 values the renderer's `coherence_key` and
`core/rng.py` use.  Other dtypes raise.

Bound on the card: bytes, 4 per key (see the source note in the .cu file
and PERF.md).
"""

from __future__ import annotations

import torch

from wavefront_tpu_torch.kernels import _build


def as_key_bits(keys64):
    """The low 32 bits of int64 values as an int32 tensor of the same
    bits (values at or past 2^31 come out negative)."""
    if keys64.dtype != torch.int64:
        raise ValueError("as_key_bits: keys must be int64")
    low = keys64 & 0xFFFFFFFF
    return torch.where(low >= 2 ** 31, low - 2 ** 32, low).to(torch.int32)


def _check_keys(keys, what: str) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError(f"{what}: keys must be a contiguous (N,) int32 "
                         "tensor holding the u32 key bits")


def _check_shift(shift: int) -> None:
    if not 0 <= int(shift) <= 24:
        raise ValueError(f"digit_histogram: shift {shift} outside 0..24")


def hist_plain(keys, shift: int):
    """Plain PyTorch version of the histogram kernel (same arguments as
    digit_histogram): digit arithmetic and one `torch.bincount`."""
    _check_keys(keys, "hist_plain")
    _check_shift(shift)
    digit = ((keys.to(torch.int64) & 0xFFFFFFFF) >> int(shift)) & 255
    return torch.bincount(digit, minlength=256).to(torch.int32)


_HIST = _build.Launcher("radix_hist", "rh_digit_histogram", "piip",
                       "digit_histogram")
_HIST4 = _build.Launcher("radix_hist", "rh_digit_histograms4", "pip",
                        "digit_histograms4")


def digit_histogram(keys, shift: int):
    """(N,) int32 key bits -> (256,) int32 counts of the digit
    `(key >> shift) & 255` (logical shift, 0 <= shift <= 24).

    CPU tensors take `hist_plain`; CUDA tensors launch the kernel or
    raise."""
    _check_keys(keys, "digit_histogram")
    _check_shift(shift)
    if keys.device.type == "cpu":
        return hist_plain(keys, shift)
    out = torch.zeros(256, dtype=torch.int32, device=keys.device)
    _HIST(keys.get_device(), keys.data_ptr(), keys.shape[0], int(shift),
          out.data_ptr())
    digit_histogram.launches += 1
    return out


digit_histogram.launches = 0


def digit_histograms4(keys):
    """(N,) int32 key bits -> (4, 256) int32: row d counts the digit
    `(key >> 8 d) & 255`, all four in one read of the keys.  CPU tensors
    take four `hist_plain` passes; CUDA tensors launch the kernel or
    raise."""
    _check_keys(keys, "digit_histograms4")
    if keys.device.type == "cpu":
        return torch.stack([hist_plain(keys, 8 * d) for d in range(4)])
    out = torch.zeros((4, 256), dtype=torch.int32, device=keys.device)
    _HIST4(keys.get_device(), keys.data_ptr(), keys.shape[0], out.data_ptr())
    digit_histograms4.launches += 1
    return out


digit_histograms4.launches = 0


def radix_hist(keys, one_read: bool = False):
    """The histogram and spine stages of a 4-pass LSD radix sort: (4, 256)
    int32, row p the inclusive prefix sum of the counts of digit p (the
    form of `tools/radix_lab.py::radix_hist`).  Four `digit_histogram`
    passes, or with `one_read` the single `digit_histograms4` pass; the
    spine is `torch.cumsum`."""
    counts = digit_histograms4(keys) if one_read else torch.stack(
        [digit_histogram(keys, 8 * p) for p in range(4)])
    return torch.cumsum(counts, dim=1).to(torch.int32)
