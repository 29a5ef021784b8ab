"""Device probes: the CUDA kernels of `csrc/device_probe.cu` and their
plain PyTorch versions.

Replaces the three TPU kernels of `tools/tpu_probe.py::micro_suite`: `k`
(a chain of dependent adds of the input), `kg` (a per-lane row gather,
`acc = sum_k t[(i + k) % R, lane]`) and `kv` (an (8, 128) copy through a
scratch buffer, to find the largest the machine grants).  On the card the
scratch is a block's dynamic shared memory: `smem_capacity` asks for 48 KB
to 228 KB and reports the largest size whose launch is accepted and whose
copy is right, with the `cudaError` of the first refusal.

What bounds each kernel on the card is in the source note of the .cu
file.  `tools/gpu_probe.py --micro` prints their rows.
"""

from __future__ import annotations

import torch

from wavefront_tpu_torch.kernels import _build

# dynamic shared memory sizes smem_capacity asks for, in KB; a block on
# Hopper may have 227 KB, so the last one is expected to be refused
SMEM_SIZES_KB = (48, 64, 96, 128, 164, 200, 227, 228)
# the errors by which the runtime refuses a shared-memory size:
# cudaErrorInvalidValue, cudaErrorInvalidConfiguration,
# cudaErrorLaunchOutOfResources
SMEM_REFUSALS = (1, 9, 701)


_LOOP_ADD = _build.Launcher("device_probe", "dp_loop_add", "ppii", "loop_add")
_ROW_GATHER = _build.Launcher("device_probe", "dp_row_gather_sum", "pppii",
                              "row_gather_sum")
# a refused shared-memory size is this probe's measurement: returned
_SMEM_COPY = _build.Launcher("device_probe", "dp_smem_copy", "ppii",
                             "smem_copy", returned=SMEM_REFUSALS)
_I32 = torch.int32


def loop_add_plain(x, iters: int):
    """Plain PyTorch version of loop_add: `iters` float32 adds of x, one
    after another, starting from zero."""
    acc = torch.zeros_like(x)
    for _ in range(int(iters)):
        acc = acc + x
    return acc


def loop_add(x, iters: int):
    """float32 x of any shape -> x added to zero `iters` times in sequence
    (`iters * x` up to float32 rounding of the running sum).  CPU tensors
    take `loop_add_plain`; CUDA tensors launch the kernel or raise."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("loop_add: x must be a contiguous float32 tensor")
    if int(iters) < 0:
        raise ValueError(f"loop_add: iters {iters} is negative")
    if x.device.type == "cpu":
        return loop_add_plain(x, iters)
    out = torch.empty_like(x)
    _LOOP_ADD(x.get_device(), x.data_ptr(), out.data_ptr(), x.numel(),
              int(iters))
    loop_add.launches += 1
    return out


loop_add.launches = 0


def row_gather_sum_plain(table, idx, reps: int = 64):
    """Plain PyTorch version of row_gather_sum: `reps` gathers along the
    row axis (`torch.gather`), summed in int32."""
    rows = table.shape[0]
    acc = torch.zeros_like(table)
    for k in range(int(reps)):
        acc = acc + torch.gather(table, 0, torch.remainder(idx + k, rows)
                                 .to(torch.int64))
    return acc


def _check_gather(table, idx, reps):
    """row_gather_sum's argument checks; returns (R, reps) as ints."""
    shape = table.shape
    if not (table.dtype == _I32 and idx.dtype == _I32 and len(shape) == 2
            and shape[1] == 128 and idx.shape == shape
            and idx.device == table.device
            and table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather_sum: table and idx must be "
                         "contiguous (R, 128) int32 tensors on one device")
    reps = int(reps)
    if shape[0] < 1 or reps < 0:
        raise ValueError("row_gather_sum: needs R >= 1 and reps >= 0")
    return shape[0], reps


def row_gather_sum(table, idx, reps: int = 64):
    """(R, 128) int32 table and row indices ->
    `out[i, l] = sum_{k < reps} table[(idx[i, l] + k) mod R, l]` (floor
    modulo, int32 sums that wrap).  CPU tensors take
    `row_gather_sum_plain`; CUDA tensors launch the kernel or raise."""
    rows, reps = _check_gather(table, idx, reps)
    dev = table.get_device()     # -1 on the CPU
    if dev < 0:
        return row_gather_sum_plain(table, idx, reps)
    out = torch.empty_like(table)
    _ROW_GATHER(dev, table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                reps)
    row_gather_sum.launches += 1
    return out


row_gather_sum.launches = 0


def smem_copy_plain(x, nbytes: int):
    """Plain PyTorch version of smem_copy: the copy."""
    return x.clone()


def smem_copy(x, nbytes: int):
    """Copy float32 x (at most 1024 elements) through the far end of
    `nbytes` of a block's dynamic shared memory.

    Returns (copy, cudaError): error 0 and the copy when the card grants
    the size, else the error of the refused request and None.  A refusal
    is this probe's measurement, so it is returned, not raised; any other
    failure raises.  CPU tensors take `smem_copy_plain` (error 0)."""
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or not 1 <= x.numel() <= 1024):
        raise ValueError("smem_copy: x must be a contiguous float32 tensor "
                         "of 1..1024 elements")
    if int(nbytes) < x.numel() * 4:
        raise ValueError(f"smem_copy: {nbytes} bytes do not hold x")
    if x.device.type == "cpu":
        return smem_copy_plain(x, nbytes), 0
    out = torch.empty_like(x)
    err = _SMEM_COPY(x.get_device(), x.data_ptr(), out.data_ptr(), x.numel(),
                     int(nbytes))
    if err:
        return None, err
    smem_copy.launches += 1
    return out, 0


smem_copy.launches = 0


def smem_capacity(device="cuda") -> dict:
    """The largest of SMEM_SIZES_KB of dynamic shared memory a block is
    granted on `device`: {"max_bytes", "refused_bytes", "refused_error"}
    (the last two None when every size was granted).  A granted size whose
    copy comes back wrong raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("smem_capacity: shared memory is the card's; "
                         "pass a CUDA device")
    x = torch.arange(8 * 128, dtype=torch.float32, device=device)
    out = {"max_bytes": 0, "refused_bytes": None, "refused_error": None}
    for kb in SMEM_SIZES_KB:
        got, err = smem_copy(x, kb * 1024)
        if err != 0:
            out["refused_bytes"], out["refused_error"] = kb * 1024, err
            break
        torch.cuda.synchronize(device)
        if not torch.equal(got, x):
            raise RuntimeError(f"smem_capacity: the copy through {kb} KB of "
                               "shared memory came back wrong")
        out["max_bytes"] = kb * 1024
    return out
