"""Voxel-extraction probes: the CUDA kernels of `csrc/extract_probe.cu`
and their plain PyTorch versions.

Replaces the TPU kernels `tools/roofline.py::_cur_kernel` and
`::_win_kernel`: lanes (cx, cz) walk along x through a table of voxel
channels, each read feeding the choice of the next position, and sum what
they read.  `extract_cur` reads a whole-scene table, `extract_win` the
32x32-column window that all lanes of a group agree on, from a pre-tiled
table.  The question on the card is what such a dependent read costs from
L2 against from a window staged in shared memory, which is the design
choice of the tracer (`csrc/window_trace.cu`).

Lanes come in groups: `cx` and `cz` are int32 of shape (groups, rows, 128)
or (rows, 128) (one group), and a group (rows * 128 lanes) is what the TPU
kernel holds in one tile, so `extract_win` takes its consensus window over
one group.  On the card a group is one thread block: rows * 128 must be a
multiple of 32 up to 512, or 1024, 2048 or 4096 (rows 8, 16, 32).  Tables
are uint8 (the TPU tool keeps the same integers 0..254 in bf16).

What holds each kernel on the card, and how its design answers it, is in
the source note of the .cu file.
"""

from __future__ import annotations


import torch

from wavefront_tpu_torch.kernels import _build

_I32 = torch.int32
# compared with every read before the next cx is chosen; no XOR of bytes
# equals it (tools/roofline.py uses the same value)
NEVER = -123456


def _groups(cx, cz, what: str):
    """(groups, lanes) of the lane tensors, checked."""
    for x in (cx, cz):
        if (x.dtype != _I32 or x.dim() not in (2, 3) or x.shape[-1] != 128
                or x.shape != cx.shape or x.device != cx.device
                or not x.is_contiguous()):
            raise ValueError(f"{what}: cx and cz must be contiguous int32 "
                             "tensors of one shape (groups, rows, 128) or "
                             "(rows, 128) on one device")
    lanes = cx.shape[-2] * 128
    return cx.numel() // lanes, lanes


def _check_table(table, cx, what: str, shape: str) -> None:
    if (table.dtype != torch.uint8 or table.dim() != 3
            or table.device != cx.device or not table.is_contiguous()):
        raise ValueError(f"{what}: the table must be a contiguous {shape} "
                         "uint8 tensor on the lanes' device")


def extract_cur_plain(table, cx, cz, iters: int):
    """Plain PyTorch version of extract_cur (same arguments)."""
    nc, gz, gx = table.shape
    t = table.to(_I32)
    cx, acc = cx.clone(), torch.zeros_like(cx)
    zi = cz.clamp(0, gz - 1).to(torch.int64)
    z_ok = (cz >= 0) & (cz < gz)
    for _ in range(int(iters)):
        ok = z_ok & (cx >= 0) & (cx < gx)
        xi = cx.clamp(0, gx - 1).to(torch.int64)
        s = torch.zeros_like(cx)
        for c in range(nc):
            s = s ^ t[c][zi, xi]
        s = torch.where(ok, s, torch.zeros_like(s))
        cx = torch.where(s == NEVER, cz, torch.remainder(cx + 1, gx))
        acc = acc + s
    return acc


def extract_win_plain(tw, cx, cz, iters: int, nwx: int, nwz: int):
    """Plain PyTorch version of extract_win (same arguments)."""
    shape = cx.shape
    lanes = shape[-2] * 128
    nc = tw.shape[1] // 8
    t = tw.to(_I32)
    cx, cz = cx.reshape(-1, lanes).clone(), cz.reshape(-1, lanes)
    acc = torch.zeros_like(cx)
    for _ in range(0, int(iters), 8):
        w = ((cx >> 5) * nwz + (cz >> 5)).amin(dim=1, keepdim=True)
        x0 = torch.div(w, nwz, rounding_mode="floor") * 32
        z0 = torch.remainder(w, nwz) * 32
        wc = w.clamp(0, nwx * nwz - 1).to(torch.int64).expand(-1, lanes)
        for _ in range(8):
            xl, zrel = cx - x0, cz - z0
            inw = (xl >= 0) & (xl < 32) & (zrel >= 0) & (zrel < 32)
            row = (zrel & 7).clamp(0, 7).to(torch.int64)
            col = (((zrel >> 3) << 5) + xl).clamp(0, 127).to(torch.int64)
            s = torch.zeros_like(cx)
            for c in range(nc):
                s = s ^ t[wc, c * 8 + row, col]
            s = torch.where(inw, s, torch.zeros_like(s))
            cx = torch.where(s == NEVER, cz,
                             torch.remainder(cx + 1, nwx * 32))
            acc = acc + s
    return acc.reshape(shape)


_CUR = _build.Launcher("extract_probe", "ep_extract_cur", "ppppiiiiii",
                      "extract_cur")
_WIN = _build.Launcher("extract_probe", "ep_extract_win", "ppppiiiiii",
                      "extract_win")


def extract_cur(table, cx, cz, iters: int):
    """`iters` dependent reads per lane from a whole-scene table.

    table: (nc, gz, gx) uint8; cx, cz: int32 lanes (module note).  Per lane
    and iteration: `s = XOR_c table[c, cz, cx]` (0 where cx or cz lies
    outside the table), `acc += s`, `cx = (cx + 1) mod gx`.  Returns acc,
    shaped like cx.  CPU tensors take `extract_cur_plain`; CUDA tensors
    launch the kernel or raise."""
    groups, lanes = _groups(cx, cz, "extract_cur")
    _check_table(table, cx, "extract_cur", "(nc, gz, gx)")
    if cx.device.type == "cpu":
        return extract_cur_plain(table, cx, cz, iters)
    nc, gz, gx = table.shape
    out = torch.empty_like(cx)
    _CUR(cx.get_device(), table.data_ptr(), cx.data_ptr(), cz.data_ptr(),
         out.data_ptr(), gx, gz, nc, int(iters), groups, lanes)
    extract_cur.launches += 1
    return out


extract_cur.launches = 0


def extract_win(tw, cx, cz, iters: int, nwx: int, nwz: int):
    """`iters` (rounded up to a multiple of 8) dependent reads per lane
    from the group's consensus window.

    tw: (nwx * nwz, nc * 8, 128) uint8, window w = wx * nwz + wz holding
    its 32x32 columns as row `c * 8 + (zrel & 7)`, column
    `((zrel >> 3) << 5) + xl`, nc <= 16; cx, cz: int32 lanes (module
    note).  Every 8 iterations a group picks the smallest window index any
    of its lanes stands in; a lane outside that window reads 0.  Otherwise
    as extract_cur, with `cx = (cx + 1) mod (nwx * 32)`.  CPU tensors take
    `extract_win_plain`; CUDA tensors launch the kernel or raise."""
    groups, lanes = _groups(cx, cz, "extract_win")
    _check_table(tw, cx, "extract_win", "(nwx*nwz, nc*8, 128)")
    nwx, nwz = int(nwx), int(nwz)
    if (tw.shape[0] != nwx * nwz or tw.shape[2] != 128 or tw.shape[1] % 8
            or not 8 <= tw.shape[1] <= 128):
        raise ValueError(f"extract_win: table {tuple(tw.shape)} is not "
                         f"({nwx}*{nwz}, nc*8, 128) with nc <= 16")
    if cx.device.type == "cpu":
        return extract_win_plain(tw, cx, cz, iters, nwx, nwz)
    out = torch.empty_like(cx)
    _WIN(cx.get_device(), tw.data_ptr(), cx.data_ptr(), cz.data_ptr(),
         out.data_ptr(), nwx, nwz, tw.shape[1] // 8, int(iters), groups,
         lanes)
    extract_win.launches += 1
    return out


extract_win.launches = 0


def tile_windows(table, nwx: int, nwz: int):
    """The (nc, nwz*32, nwx*32) whole-scene table of extract_cur as the
    (nwx*nwz, nc*8, 128) window table of extract_win, so that both read
    the same voxels."""
    nc = table.shape[0]
    t = table.reshape(nc, nwz, 4, 8, nwx, 32)     # c, wz, zhi, zlo, wx, xl
    return t.permute(4, 1, 0, 3, 2, 5).reshape(nwx * nwz, nc * 8,
                                               128).contiguous()
