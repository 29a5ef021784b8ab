"""Radix-sort digit histograms: the CUDA kernel `csrc/radix_hist.cu` and
its plain PyTorch version `hist_plain`.

Replaces the TPU kernel `tools/radix_lab.py::hist_kernel` (called by
`hist_pass()`): the 256-bin histogram of one 8-bit digit of 32-bit keys,
the upsweep of an LSD radix sort, and `radix_hist`, the four passes with
their prefix-sum spine (plain version `radix_hist_plain`).  The TPU
kernel counts in float32 through a one-hot matrix product over
zero-padded 2048-key tiles; the port counts the keys it is given, in
int32, with no padding (so its bin 0 lacks the pad keys the TPU kernel
adds there).  On the card the kernel also takes the spine, and a call is
one device operation: the kernel keeps a small workspace for each device
and stream, zeroed once and left zero by every launch (see the source
note), so nothing is filled before it.

Keys are unsigned 32-bit values carried bit for bit in an `int32` tensor
(PyTorch has no arithmetic on uint32); `as_key_bits` makes that form from
the int64-carried u32 values the renderer's `coherence_key` and
`core/rng.py` use.  Other dtypes raise.

Bound on the card: bytes, 4 per key (see the source note in the .cu file
and PERF.md).
"""

from __future__ import annotations

import itertools

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


def radix_hist_plain(keys):
    """Plain PyTorch version of `radix_hist`: the inclusive prefix sums of
    four `hist_plain` rows, (4, 256) int32."""
    return torch.cumsum(torch.stack([hist_plain(keys, 8 * p)
                                     for p in range(4)]), 1).to(torch.int32)


_HIST = _build.Launcher("radix_hist", "rh_digit_histogram", "piiippii",
                       "digit_histogram")
_HIST4 = _build.Launcher("radix_hist", "rh_digit_histograms4", "piippii",
                        "digit_histograms4")

# int32 words of a workspace (WORK_WORDS in csrc/radix_hist.cu): the
# kernel's start and end tickets and its flag
WORK_WORDS = 3
# (device, raw stream handle) -> [workspace, its generations (a counter
# that threads share safely), the generation of its last launch]
_work: dict = {}


def _launch(launcher, keys, *args, out):
    """Launch `launcher(keys, n, *args, out, work, fresh, gen)` with the
    workspace of the current stream of the keys' device.  A stream's
    workspace is made on its first launch and zeroed by that launch (the
    C function's `fresh`); the kernel leaves it zero but for its flag,
    which holds the generation `gen` of the stream's last call, so later
    launches on the stream need no fill, and launches on two streams never
    share one.  It is kept only once a launch has gone through."""
    dev = keys.get_device()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    kept = _work.get(key)
    first = kept is None
    if first:
        kept = [torch.empty(WORK_WORDS, dtype=torch.int32,
                            device=keys.device), itertools.count(), 0]
    gen = next(kept[1]) % 0x7FFFFFFF + 1
    launcher(dev, keys.data_ptr(), keys.shape[0], *args, out.data_ptr(),
             kept[0].data_ptr(), int(first), gen)
    kept[2] = gen
    if first:
        _work[key] = kept
    return out


def digit_histogram(keys, shift: int):
    """(N,) int32 key bits -> (256,) int32 counts of the digit
    `(key >> shift) & 255` (logical shift, 0 <= shift <= 24).

    CPU tensors take `hist_plain`; CUDA tensors launch the kernel (one
    device operation) or raise."""
    _check_keys(keys, "digit_histogram")
    _check_shift(shift)
    if keys.device.type == "cpu":
        return hist_plain(keys, shift)
    out = torch.empty(256, dtype=torch.int32, device=keys.device)
    _launch(_HIST, keys, int(shift), 0, out=out)
    digit_histogram.launches += 1
    return out


digit_histogram.launches = 0


def digit_histograms4(keys):
    """(N,) int32 key bits -> (4, 256) int32: row d counts the digit
    `(key >> 8 d) & 255`, all four in one read of the keys.  CPU tensors
    take four `hist_plain` passes; CUDA tensors launch the kernel (one
    device operation) or raise."""
    _check_keys(keys, "digit_histograms4")
    if keys.device.type == "cpu":
        return torch.stack([hist_plain(keys, 8 * d) for d in range(4)])
    out = torch.empty((4, 256), dtype=torch.int32, device=keys.device)
    _launch(_HIST4, keys, 0, out=out)
    digit_histograms4.launches += 1
    return out


digit_histograms4.launches = 0


def radix_hist(keys, one_read: bool = False):
    """The histogram and spine stages of a 4-pass LSD radix sort: (4, 256)
    int32, row p the inclusive prefix sum of the counts of digit p (the
    form of `tools/radix_lab.py::radix_hist`).  On the card the kernel
    takes the spine: four passes of one digit each, every pass writing its
    row (four device operations), or with `one_read` one pass over all
    four digits (one device operation).  CPU tensors take
    `radix_hist_plain`."""
    _check_keys(keys, "radix_hist")
    if keys.device.type == "cpu":
        return radix_hist_plain(keys)
    out = torch.empty((4, 256), dtype=torch.int32, device=keys.device)
    if one_read:
        _launch(_HIST4, keys, 1, out=out)
        digit_histograms4.launches += 1
        return out
    for p in range(4):
        _launch(_HIST, keys, 8 * p, 1, out=out[p])
        digit_histogram.launches += 1
    return out
