"""Loop-body probes: the CUDA kernels of `csrc/loop_probe.cu` and their
plain PyTorch versions.

Replaces the TPU kernels of `tools/event_lab.py`: the loop kernel of
`_loop_kernel` with the bodies of `bench_issue`, `bench_onehot` and
`bench_zsel`, and the five primitive kernels of `probe_support`.  The
variants (`VARIANTS`) differ in where the looked-up data lives on the
card, not in what they compute:

  issue                        state (a,): 64 chained `a = a + 1`
  onehot_smem / _ldg / _const  state (code, acc), extra: (64, 128) or
                               (8, 128) uint8 table;
                               s = sum_r table[r, code] (0 where code is
                               outside [0, 128))
  zsel_tree / _local / _smem   state (code, acc), extra: (8, 8) int32
                               offsets >= 0; s = sum_c (code + offsets[c,
                               code & 7]); zero offsets give the TPU
                               tool's integers (s = 8 * code)

with `code = (code + s % 2 + 1) mod 128` and `acc += s` (int32, wrapping)
after every iteration of onehot and zsel.  States are int32 of shape
(groups, rows, 128) or (rows, 128); a group (rows * 128 lanes) is one
thread block on the card: a multiple of 32 up to 512, or 1024, 2048 or
4096 lanes.

Every onehot form reads the table column-major (a code's rows together)
in wide chunks; for the global and constant forms the wrapper allocates
the column-major copy that the launch fills, so their time includes
making it.  What bounds each form on the card is in the source note of
the .cu file.
"""

from __future__ import annotations


import torch

from wavefront_tpu_torch.kernels import _build

_I32 = torch.int32
VARIANTS = ("issue", "onehot_smem", "onehot_ldg", "onehot_const",
            "zsel_tree", "zsel_local", "zsel_smem")
PRIMITIVES = ("i16_cmp", "i8_cmp", "bf16_mul", "row_pick", "lane_roll")
ISSUE_ADDS = 64   # chained adds per iteration of `issue`
# dependent integer operations per iteration of the `issue` kernel: each
# add is followed by an XOR with a run-time zero, which keeps the
# assembler from merging neighbouring adds
ISSUE_OPS = 2 * ISSUE_ADDS
ZSEL_CHANNELS = 8


def _body(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"loop_probe: variant {variant!r} is none of "
                         f"{VARIANTS}")
    return variant.split("_")[0]


def _check(variant: str, state, extra, what: str):
    """(body, groups, lanes) after checking the state and extra tensors."""
    body = _body(variant)
    state = tuple(state)
    if len(state) != (1 if body == "issue" else 2):
        raise ValueError(f"{what}: {variant} takes "
                         f"{1 if body == 'issue' else 2} state tensors")
    first = state[0]
    for x in state:
        if (x.dtype != _I32 or x.dim() not in (2, 3) or x.shape[-1] != 128
                or x.shape != first.shape or x.device != first.device
                or not x.is_contiguous()):
            raise ValueError(f"{what}: states must be contiguous int32 "
                             "tensors of one shape (groups, rows, 128) or "
                             "(rows, 128) on one device")
    if body == "onehot" and not (
            extra is not None and extra.dtype == torch.uint8
            and extra.dim() == 2 and extra.shape[0] in (8, 64)
            and extra.shape[1] == 128 and extra.device == first.device
            and extra.is_contiguous()):
        raise ValueError(f"{what}: onehot needs a contiguous (64, 128) or "
                         "(8, 128) uint8 table on the state's device")
    if body == "zsel" and not (
            extra is not None and extra.dtype == _I32
            and extra.shape == (ZSEL_CHANNELS, 8)
            and extra.device == first.device and extra.is_contiguous()):
        raise ValueError(f"{what}: zsel needs a contiguous (8, 8) int32 "
                         "offset table on the state's device")
    lanes = first.shape[-2] * 128
    return body, first.numel() // lanes, lanes


def loop_probe_plain(variant: str, state, extra, iters: int):
    """Plain PyTorch version of loop_probe (same arguments)."""
    body, _, _ = _check(variant, state, extra, "loop_probe_plain")
    if body == "issue":
        a = state[0]
        for _ in range(int(iters)):
            for _ in range(ISSUE_ADDS):
                a = a + 1
        return (a,)
    code, acc = state
    table = extra.to(_I32)
    for _ in range(int(iters)):
        if body == "onehot":
            ok = (code >= 0) & (code < 128)
            col = code.clamp(0, 127).to(torch.int64)
            s = torch.where(ok, table[:, col].sum(dim=0, dtype=_I32),
                            torch.zeros_like(code))
        else:
            pick = table[:, (code & 7).to(torch.int64)]     # (8, *code.shape)
            s = (code.unsqueeze(0) + pick).sum(dim=0, dtype=_I32)
        code = torch.remainder(code + torch.remainder(s, 2) + 1, 128)
        acc = acc + s
    return code, acc


_LOOP = _build.Launcher("loop_probe", "lp_loop", "iipppppppiii",
                        "loop_probe")
_PRIMITIVE = _build.Launcher("loop_probe", "lp_primitive", "ippp",
                             "primitive")


def loop_probe(variant: str, state, extra, iters: int):
    """Carry `state` through `iters` iterations of the body `variant`
    (module note); returns the final state as a tuple, (a,) for `issue`
    and (code, acc) otherwise.  `extra` is the body's table (None for
    `issue`).  CPU tensors take `loop_probe_plain`; CUDA tensors launch
    the kernel or raise."""
    body, groups, lanes = _check(variant, state, extra, "loop_probe")
    if int(iters) < 0:
        raise ValueError(f"loop_probe: iters {iters} is negative")
    first = state[0]
    if first.device.type == "cpu":
        return loop_probe_plain(variant, state, extra, iters)
    outs = tuple(torch.empty_like(x) for x in state)
    table = extra.data_ptr() if body == "onehot" else None
    # the global and constant forms' column-major copy of the table
    cols = (torch.empty(extra.numel(), dtype=torch.uint8, device=first.device)
            if variant in ("onehot_ldg", "onehot_const") else None)
    offsets = extra.data_ptr() if body == "zsel" else None
    acc_in = state[1].data_ptr() if len(state) == 2 else None
    acc_out = outs[1].data_ptr() if len(state) == 2 else None
    _LOOP(first.get_device(), VARIANTS.index(variant),
          extra.shape[0] if body == "onehot" else 0, first.data_ptr(),
          acc_in, table, None if cols is None else cols.data_ptr(), offsets,
          outs[0].data_ptr(), acc_out, int(iters), groups, lanes)
    loop_probe.launches += 1
    return outs


loop_probe.launches = 0


def primitive_plain(name: str, a, idx=None):
    """Plain PyTorch version of `primitive` (same arguments)."""
    rows = torch.arange(a.shape[0], device=a.device).unsqueeze(1)
    if name == "i16_cmp":
        return (a.to(torch.int16) == rows.to(torch.int16)).to(_I32)
    if name == "i8_cmp":
        return (a.to(torch.int8) == rows.to(torch.int8)).to(_I32)
    if name == "bf16_mul":
        b = a.to(torch.float32).to(torch.bfloat16)
        return (b * b).to(torch.float32).to(_I32)
    if name == "row_pick":
        return torch.gather(a, 0, (idx & 7).to(torch.int64)).to(_I32)
    if name == "lane_roll":
        return torch.roll(a, 1, dims=1).to(_I32)
    raise ValueError(f"primitive: {name!r} is none of {PRIMITIVES}")


def primitive(name: str, a, idx=None):
    """One of the five primitive kernels; returns int32 shaped like `a`.

      i16_cmp, i8_cmp  a: (128, 128) int32 -> (a narrowed to int16 / int8,
                       wrapping) == (row index narrowed alike)
      bf16_mul         a: (128, 128) int32 -> int(bf16(a) * bf16(a)), both
                       roundings to nearest even, the conversion back
                       truncating; |a| <= 2^15 keeps the square in int32
      row_pick         a: (8, 128) float32, idx: (8, 128) int32 ->
                       int(a[idx[i, j] mod 8, j])
      lane_roll        a: (8, 128) float32 -> int(a[i, (j - 1) mod 128])

    CPU tensors take `primitive_plain`; CUDA tensors launch the kernel or
    raise."""
    if name not in PRIMITIVES:
        raise ValueError(f"primitive: {name!r} is none of {PRIMITIVES}")
    wide = name in ("i16_cmp", "i8_cmp", "bf16_mul")
    want = ((128, 128), _I32) if wide else ((8, 128), torch.float32)
    if (tuple(a.shape), a.dtype) != want or not a.is_contiguous():
        raise ValueError(f"primitive {name}: a must be a contiguous "
                         f"{want[0]} {want[1]} tensor")
    if name == "row_pick" and not (
            idx is not None and idx.shape == a.shape and idx.dtype == _I32
            and idx.device == a.device and idx.is_contiguous()):
        raise ValueError("primitive row_pick: idx must be a contiguous "
                         "(8, 128) int32 tensor on a's device")
    if a.device.type == "cpu":
        return primitive_plain(name, a, idx)
    out = torch.empty(a.shape, dtype=_I32, device=a.device)
    _PRIMITIVE(a.get_device(), PRIMITIVES.index(name), a.data_ptr(),
               idx.data_ptr() if name == "row_pick" else None,
               out.data_ptr())
    primitive.launches += 1
    return out


primitive.launches = 0
