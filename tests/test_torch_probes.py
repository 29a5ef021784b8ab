"""The port's probe kernels' plain versions against the TPU tools' kernels.

The port's histogram and probe kernels (`wavefront_tpu_torch/kernels/
radix_hist.py`, `device_probe.py`, `extract_probe.py`, `loop_probe.py`)
compute integers, so every comparison here is exact.  On the CPU a wrapper
runs its plain version, which is what these tests hold:

  * to `tools/roofline.py::_cur_kernel` and `::_win_kernel` and to
    `tools/event_lab.py::_loop_kernel`, run unedited in the TPU interpret
    mode (`pltpu.force_tpu_interpret_mode`), with the event lab's loop
    bodies restated here because the tool defines them as closures;
  * to a restatement of `tools/radix_lab.py::hist_kernel`'s one-hot
    product (a closure inside `main()`), with the TPU's pad keys taken off
    bin 0, and to `np.bincount`;
  * to numpy for the kernels of `tools/tpu_probe.py` and the primitives of
    `event_lab.probe_support`, which are closures too.

Inputs come from a numpy seed and go to both sides.
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels import device_probe as dp
from wavefront_tpu_torch.kernels import extract_probe as ep
from wavefront_tpu_torch.kernels import loop_probe as lp
from wavefront_tpu_torch.kernels import radix_hist as rh
from wavefront_tpu_torch.tools import (
    event_lab,
    gpu_probe,
    kernel_times,
    radix_lab,
    roofline,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    """A module of the repository's root tools/ directory (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_roofline():
    return _tool("roofline")


@pytest.fixture(scope="module")
def jax_event_lab():
    return _tool("event_lab")


def _t(a, dtype=np.int32):
    return torch.as_tensor(np.ascontiguousarray(a).astype(dtype))


# ---- K4: the digit histogram ----


def _tpu_hist(keys_u32, shift, tile=2048):
    """tools/radix_lab.py::hist_kernel over its sequential grid, restated:
    a one-hot of each tile's digits times a column of ones, summed in
    float32 over the zero-padded tiles."""
    pad = -len(keys_u32) % tile
    k2d = jnp.concatenate([jnp.asarray(keys_u32),
                           jnp.zeros(pad, jnp.uint32)]).reshape(-1, tile)
    total = jnp.zeros((1, 256), jnp.float32)
    for row in k2d:
        digit = (jax.lax.shift_right_logical(row, jnp.uint32(shift))
                 & jnp.uint32(255)).astype(jnp.int32).reshape(1, tile)
        iota = jax.lax.broadcasted_iota(jnp.int32, (256, tile), 0)
        oh = (iota == digit).astype(jnp.bfloat16)
        h = jnp.dot(oh, jnp.ones((tile, 1), jnp.bfloat16),
                    preferred_element_type=jnp.float32)
        total = total + h.reshape(1, 256)
    return np.asarray(total[0]).astype(np.int64), pad


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
def test_hist_plain_matches_tpu_one_hot_product(shift):
    keys = np.random.default_rng(3).integers(0, 2 ** 32, 5000, dtype=np.uint32)
    keys[::3] &= 0x7FC000E0          # few distinct low digits, like sort keys
    got = rh.digit_histogram(_t(keys.view(np.int32)), shift).numpy()
    want, pad = _tpu_hist(keys, shift)
    want[0] -= pad                   # the TPU's pad keys count in bin 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.bincount((keys >> shift) & 255, minlength=256))
    assert got.sum() == len(keys) and got.dtype == np.int32


@pytest.mark.parametrize("keys_kind", ["uniform", "coherent"])
def test_radix_hist_spine_matches_tpu_one_hot_product(keys_kind):
    """Both forms of the spine (four passes and one read) and its plain
    version against `tools/radix_lab.py::radix_hist`'s restatement: the
    TPU kernel's histogram of each digit, pad keys off bin 0, then
    np.cumsum."""
    keys = np.random.default_rng(6).integers(0, 2 ** 32, 4099,
                                             dtype=np.uint32)
    if keys_kind == "coherent":
        keys &= 0x7FC000E0
    want = []
    for p in range(4):
        h, pad = _tpu_hist(keys, 8 * p)
        h[0] -= pad
        want.append(np.cumsum(h))
    want = np.stack(want)
    bits = _t(keys.view(np.int32))
    for got in (rh.radix_hist_plain(bits), rh.radix_hist(bits),
                rh.radix_hist(bits, one_read=True)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (4, 256)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -1] == len(keys)).all()


def test_radix_hist_spine_and_key_bits():
    rng = np.random.default_rng(4)
    k64 = rng.integers(0, 2 ** 32, 3000, dtype=np.int64)
    bits = rh.as_key_bits(torch.as_tensor(k64))
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  k64.astype(np.uint32))
    got = rh.radix_hist(bits).numpy()
    want = np.stack([np.cumsum(np.bincount((k64 >> (8 * p)) & 255,
                                           minlength=256)) for p in range(4)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rh.radix_hist(bits, one_read=True).numpy(),
                                  want)
    for bad in (torch.as_tensor(k64), bits[::2], bits.reshape(2, -1)):
        with pytest.raises(ValueError):
            rh.digit_histogram(bad, 0)
    with pytest.raises(ValueError):
        rh.digit_histogram(bits, 32)


# ---- K6: the extraction probes ----


def test_extract_cur_matches_tpu_kernel(jax_roofline):
    rng = np.random.default_rng(5)
    gx, gz, nc, rows, iters = 40, 24, 3, 8, 16
    table = rng.integers(0, 255, (nc, gz, gx))
    cx = rng.integers(0, gx, (rows, 128))
    cz = rng.integers(0, gz, (rows, 128))
    kern = functools.partial(jax_roofline._cur_kernel, gx=gx, gz=gz, nc=nc,
                             iters=iters)
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, in_specs=[spec] * 3, out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        )(jnp.asarray(table.reshape(nc * gz, gx).astype(np.float32),
                      jnp.bfloat16),
          jnp.asarray(cx, jnp.int32), jnp.asarray(cz, jnp.int32))
    got = ep.extract_cur(_t(table, np.uint8), _t(cx), _t(cz), iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().sum() > 0


@pytest.mark.parametrize("iters", [8, 16])
def test_extract_win_matches_tpu_kernel(jax_roofline, iters):
    """2x2 windows, lanes mostly in window (1, 0) with a tenth elsewhere,
    so the consensus window leaves some lanes outside (they read 0) and
    moves on once the lanes in it have walked out."""
    rng = np.random.default_rng(6)
    nwx, nwz, nc, rows = 2, 2, 3, 8
    tw = rng.integers(0, 255, (nwx * nwz, nc * 8, 128))
    cx = rng.integers(40, 64, (rows, 128))
    cz = rng.integers(0, 32, (rows, 128))
    stray = rng.random((rows, 128)) < 0.1
    cx = np.where(stray, rng.integers(0, 64, (rows, 128)), cx)
    cz = np.where(stray, rng.integers(0, 64, (rows, 128)), cz)
    kern = functools.partial(jax_roofline._win_kernel, nwx=nwx, nwz=nwz,
                             nc=nc, iters=iters, dtype=jnp.bfloat16)
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, in_specs=[spec] * 3, out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        )(jnp.asarray(tw.astype(np.float32), jnp.bfloat16),
          jnp.asarray(cx, jnp.int32), jnp.asarray(cz, jnp.int32))
    got = ep.extract_win(_t(tw, np.uint8), _t(cx), _t(cz), iters, nwx, nwz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # lanes in another z-row of windows than the first consensus window
    # read nothing in its 8 steps (x moves, z does not)
    w = ((cx >> 5) * nwz + (cz >> 5)).min()
    away = (cz >> 5) != w % nwz
    first = ep.extract_win(_t(tw, np.uint8), _t(cx), _t(cz), 8, nwx, nwz)
    assert away.any() and not first.numpy()[away].any()
    assert first.numpy()[~away].any()


@pytest.mark.parametrize("form", ["cur", "win"])
def test_extract_lanes_off_the_table_match_tpu_kernel(jax_roofline, form):
    """Lanes that start 3 before the table or 2 past its width read 0
    until they wrap into it, in the TPU kernels as in the port's, and so
    do lanes 2 past its depth, for good.  For the window form the lanes 3
    before the table stand 2 past its depth too, so that the consensus
    window index stays inside the table: below it the port reads the
    nearest block and the interpret mode wraps the index as JAX's
    indexing does (the TPU kernel would read outside its table)."""
    rng = np.random.default_rng(8)
    nwx, nwz, nc, rows, iters = 2, 2, 3, 8, 16
    gx, gz = nwx * 32, nwz * 32
    table = rng.integers(0, 255, (nc, gz, gx))
    edge = rng.random((rows, 128))
    cx = np.where(edge < 0.2, -3, np.where(edge > 0.8, gx + 2,
                                           rng.integers(0, gx, (rows, 128))))
    deep = (edge > 0.9) | ((edge < 0.2) if form == "win" else False)
    cz = np.where(deep, gz + 2, rng.integers(0, gz, (rows, 128)))
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    if form == "cur":
        kern = functools.partial(jax_roofline._cur_kernel, gx=gx, gz=gz,
                                 nc=nc, iters=iters)
        m = table.reshape(nc * gz, gx)
    else:
        kern = functools.partial(jax_roofline._win_kernel, nwx=nwx, nwz=nwz,
                                 nc=nc, iters=iters, dtype=jnp.bfloat16)
        m = ep.tile_windows(_t(table, np.uint8), nwx, nwz).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, in_specs=[spec] * 3, out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        )(jnp.asarray(m.astype(np.float32), jnp.bfloat16),
          jnp.asarray(cx, jnp.int32), jnp.asarray(cz, jnp.int32))
    if form == "cur":
        got = ep.extract_cur(_t(table, np.uint8), _t(cx), _t(cz), iters)
    else:
        got = ep.extract_win(_t(m, np.uint8), _t(cx), _t(cz), iters, nwx,
                             nwz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.abs().sum() > 0


def test_extract_groups_and_window_tiling():
    """Each group takes its own consensus window; lanes that stay inside
    one window read the same voxels from the whole-scene table and from
    its tiling; out-of-table lanes read 0 in both."""
    rng = np.random.default_rng(7)
    nc, nwx, nwz = 4, 3, 2
    table = _t(rng.integers(0, 255, (nc, nwz * 32, nwx * 32)), np.uint8)
    tw = ep.tile_windows(table, nwx, nwz)
    cx = _t(rng.integers(32, 56, (3, 2, 128)))
    cz = _t(rng.integers(32, 64, (3, 2, 128)))
    cur = ep.extract_cur(table, cx, cz, 8)
    np.testing.assert_array_equal(
        cur.numpy(), ep.extract_win(tw, cx, cz, 8, nwx, nwz).numpy())
    # group 1 moved to another window: one call, two consensus windows
    cx[1] -= 32
    both = ep.extract_win(tw, cx, cz, 8, nwx, nwz)
    alone = ep.extract_win(tw, cx[1].contiguous(), cz[1].contiguous(), 8,
                           nwx, nwz)
    np.testing.assert_array_equal(both[1].numpy(), alone.numpy())
    np.testing.assert_array_equal(both[0].numpy(), cur[0].numpy())
    off = torch.full_like(cx, -5)
    assert not ep.extract_cur(table, off, cz, 1).any()
    with pytest.raises(ValueError):
        ep.extract_cur(table, cx.to(torch.int64), cz, 4)
    with pytest.raises(ValueError):
        ep.extract_win(tw, cx, cz, 8, nwx, nwz + 1)


# ---- K5: the loop probes ----


def _onehot_body(n_rows, rows=8):
    """tools/event_lab.py::bench_onehot's body_i32 (n_rows 64) and
    body_i16 (n_rows 8), restated: s = sum of the table's first n_rows
    rows at column `code`, by a one-hot matrix product."""
    n_all = rows * 128
    cmp_t = jnp.int32 if n_rows == 64 else jnp.int16

    def body(blk, i, st):
        code, acc = st
        c = code.astype(cmp_t).reshape(1, n_all)
        iota = jax.lax.broadcasted_iota(cmp_t, (128, n_all), 0)
        oh = (iota == c).astype(jnp.bfloat16)
        a = jnp.dot(blk, oh, preferred_element_type=jnp.float32)
        if n_rows == 64:
            s = jnp.sum(a.reshape(8, 8, -1).sum(1)[:8], axis=0)
        else:
            s = jnp.sum(a[:8], axis=0)
        s = s.reshape(rows, 128).astype(jnp.int32)
        code = (code + s % 2 + 1) % 128
        return code, acc + s

    return body


def _zsel_body(rows=8, n_ch=8):
    """tools/event_lab.py::bench_zsel's body_tree, restated."""
    n_all = rows * 128

    def body(i, st):
        code, acc = st
        a = jnp.broadcast_to(code.reshape(1, n_all).astype(jnp.float32),
                             (n_ch * 8, n_all))
        zlr = (code & 7).reshape(1, n_all)
        sel = a.reshape(n_ch, 8, n_all)
        h = 8
        while h > 1:
            h //= 2
            bit = (zlr & h) != 0
            sel = jnp.where(bit.reshape(1, 1, n_all), sel[:, h:2 * h],
                            sel[:, :h])
        s = sum(sel[c, 0].reshape(rows, 128).astype(jnp.int32)
                for c in range(n_ch))
        code = (code + s % 2 + 1) % 128
        return code, acc + s

    return body


def _issue_body(i, st):
    """tools/event_lab.py::bench_issue's body: 64 chained adds."""
    (a,) = st
    for _ in range(64):
        a = a + 1
    return (a,)


def _acc_first(body):
    """The same body on state (acc, code): _loop_kernel writes out only
    the first state, so this form brings acc out."""
    def swapped(*args):
        acc, code = args[-1]
        code, acc = body(*args[:-1], (code, acc))
        return acc, code
    return swapped


def _run_tpu_loop(event_lab_mod, body, n_state, iters, extra=(), seed=11):
    """_loop_kernel(...)(iters)() in interpret mode, and the states it
    drew (it draws them from numpy's global generator)."""
    np.random.seed(seed)
    with pltpu.force_tpu_interpret_mode():
        out = event_lab_mod._loop_kernel(body, n_state, rows=8,
                                         extra=extra)(iters)()
    np.random.seed(seed)
    states = [np.random.randint(0, 100, (8, 128)) for _ in range(n_state)]
    return np.asarray(out), states


@pytest.mark.parametrize("n_rows", [64, 8])
def test_loop_probe_onehot_matches_tpu_loop_kernel(jax_event_lab, n_rows):
    table = np.random.default_rng(8).integers(0, 255, (64, 128))
    blk = jnp.asarray(table.astype(np.float32), jnp.bfloat16)
    body = _onehot_body(n_rows)
    code_out, (code, acc) = _run_tpu_loop(jax_event_lab, body, 2, 12, (blk,))
    acc_out, (acc2, code2) = _run_tpu_loop(jax_event_lab, _acc_first(body), 2,
                                           12, (blk,))
    extra = _t(table[:n_rows], np.uint8)
    for variant in ("onehot_smem", "onehot_ldg", "onehot_const"):
        got = lp.loop_probe(variant, (_t(code), _t(acc)), extra, 12)
        np.testing.assert_array_equal(got[0].numpy(), code_out)
        got = lp.loop_probe(variant, (_t(code2), _t(acc2)), extra, 12)
        np.testing.assert_array_equal(got[1].numpy(), acc_out)
    assert acc_out.max() > 12 * 100


def test_loop_probe_zsel_and_issue_match_tpu_loop_kernel(jax_event_lab):
    body = _zsel_body()
    code_out, (code, acc) = _run_tpu_loop(jax_event_lab, body, 2, 9)
    acc_out, (acc2, code2) = _run_tpu_loop(jax_event_lab, _acc_first(body), 2,
                                           9)
    zeros = torch.zeros((8, 8), dtype=torch.int32)
    for variant in ("zsel_tree", "zsel_local", "zsel_smem"):
        got = lp.loop_probe(variant, (_t(code), _t(acc)), zeros, 9)
        np.testing.assert_array_equal(got[0].numpy(), code_out)
        got = lp.loop_probe(variant, (_t(code2), _t(acc2)), zeros, 9)
        np.testing.assert_array_equal(got[1].numpy(), acc_out)
    a_out, (a,) = _run_tpu_loop(jax_event_lab, _issue_body, 1, 5)
    np.testing.assert_array_equal(
        lp.loop_probe("issue", (_t(a),), None, 5)[0].numpy(), a_out)


def test_loop_probe_offsets_groups_and_checks():
    """Non-zero zsel offsets against numpy, groups side by side, codes
    outside [0, 128) (an empty one-hot), and the wrapper's refusals."""
    rng = np.random.default_rng(9)
    code = rng.integers(-3, 131, (2, 2, 128))
    acc = rng.integers(0, 50, (2, 2, 128))
    off = rng.integers(0, 255, (8, 8))
    got = lp.loop_probe("zsel_tree", (_t(code), _t(acc)), _t(off), 6)
    c, a = code.copy(), acc.copy()
    for _ in range(6):
        s = (c[None] + off[:, c & 7]).sum(0)
        c, a = (c + s % 2 + 1) % 128, a + s
    np.testing.assert_array_equal(got[0].numpy(), c)
    np.testing.assert_array_equal(got[1].numpy(), a)
    table = rng.integers(0, 255, (8, 128))
    got = lp.loop_probe("onehot_smem", (_t(code), _t(acc)),
                        _t(table, np.uint8), 1)
    s = np.where((code >= 0) & (code < 128),
                 table[:, code.clip(0, 127)].sum(0), 0)
    np.testing.assert_array_equal(got[1].numpy(), acc + s)
    with pytest.raises(ValueError):
        lp.loop_probe("onehot_dram", (_t(code), _t(acc)), None, 1)
    with pytest.raises(ValueError):
        lp.loop_probe("issue", (_t(code), _t(acc)), None, 1)
    with pytest.raises(ValueError):
        lp.loop_probe("onehot_smem", (_t(code), _t(acc)), _t(table), 1)


def test_primitives_match_numpy():
    rng = np.random.default_rng(10)
    a = rng.integers(-30000, 30000, (128, 128))
    row = np.arange(128)[:, None]
    a[:, ::5], a[:, 1::5], a[:, 2::5] = row, row + 65536, row + 256
    ta = _t(a)
    for name, narrow in (("i16_cmp", np.int16), ("i8_cmp", np.int8)):
        want = (a.astype(narrow) == row.astype(narrow)).astype(np.int32)
        np.testing.assert_array_equal(lp.primitive(name, ta).numpy(), want)
        assert want.sum() > 128 * 25
    small = a.clip(-30000, 30000)    # the square stays inside int32
    bf = jnp.asarray(small, jnp.int32).astype(jnp.bfloat16)
    want = np.asarray((bf * bf).astype(jnp.int32))
    np.testing.assert_array_equal(
        lp.primitive("bf16_mul", _t(small)).numpy(), want)
    f = (rng.random((8, 128)) * 1000 - 500).astype(np.float32)
    idx = rng.integers(-20, 20, (8, 128))
    np.testing.assert_array_equal(
        lp.primitive("row_pick", _t(f, np.float32), _t(idx)).numpy(),
        np.take_along_axis(f, idx % 8, axis=0).astype(np.int32))
    np.testing.assert_array_equal(
        lp.primitive("lane_roll", _t(f, np.float32)).numpy(),
        np.roll(f, 1, axis=1).astype(np.int32))
    with pytest.raises(ValueError):
        lp.primitive("row_pick", _t(f, np.float32))
    with pytest.raises(ValueError):
        lp.primitive("i16_cmp", _t(f, np.float32))


# ---- K7: the device probes ----


def test_device_probe_plain_versions_match_numpy():
    rng = np.random.default_rng(12)
    x = rng.random((8, 128), np.float32)
    want = np.zeros_like(x)
    for _ in range(40):
        want = want + x
    np.testing.assert_array_equal(
        dp.loop_add(_t(x, np.float32), 40).numpy(), want)
    assert torch.equal(dp.loop_add(torch.ones(8, 128), 4096),
                       torch.full((8, 128), 4096.0))
    for rows in (8, 40):
        t = rng.integers(0, 100, (rows, 128))
        i = rng.integers(-rows, 2 * rows, (rows, 128))
        want = sum(np.take_along_axis(t, (i + k) % rows, axis=0)
                   for k in range(64))
        np.testing.assert_array_equal(
            dp.row_gather_sum(_t(t), _t(i), 64).numpy(), want)
    got, err = dp.smem_copy(_t(x, np.float32), 200 * 1024)
    assert err == 0
    np.testing.assert_array_equal(got.numpy(), x)
    with pytest.raises(ValueError):
        dp.smem_copy(_t(x, np.float32), 16)
    with pytest.raises(ValueError):
        dp.smem_capacity("cpu")
    with pytest.raises(ValueError):
        dp.row_gather_sum(_t(t), _t(i)[:, :64], 64)


# ---- the labs ----


@pytest.mark.parametrize("lab", [radix_lab, gpu_probe, roofline, event_lab,
                                 kernel_times],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_lab_parses_help_and_needs_no_card_to_import(lab, capsys):
    with pytest.raises(SystemExit) as e:
        lab.main(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


def test_labs_refuse_to_measure_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the labs would measure it")
    for lab in (radix_lab, roofline, event_lab, kernel_times):
        with pytest.raises(SystemExit) as e:
            lab.main([])
        assert e.value.code not in (0, None)
    log = tmp_path / "probe.jsonl"
    assert gpu_probe.main(["--log", str(log)]) == 1
    assert '"up": false' in log.read_text()
    assert '"ok"' not in capsys.readouterr().out


# a tracer loop as `cuobjdump -sass` prints it: head 0x10; the skip branch
# (0x20) jumps over the fine path to 0x80; the fine path 0x10-0x70 may
# leave at 0x50; both paths branch back to the head
FAKE_SASS = """
        Function : _ZN37_GLOBAL__N__c6aadfbd_15_window_trace_cu_wt_trace12trace_kernelEPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   ISETP.GE.AND P0, PT, R0, 0x2, PT ;
        /*0020*/              @P0 BRA 0x80 ;
        /*0030*/                   FADD R2, R2, R3 ;
        /*0040*/                   FMUL R2, R2, R3 ;
        /*0050*/              @!P1 BRA 0x100 ;
        /*0060*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0070*/                   BRA 0x10 ;
        /*0080*/                   FADD R5, R5, R6 ;
        /*0090*/                   FADD R5, R5, R6 ;
        /*00a0*/                   FADD R5, R5, R6 ;
        /*00b0*/                   FADD R5, R5, R6 ;
        /*00c0*/                   FADD R5, R5, R6 ;
        /*00d0*/                   FADD R5, R5, R6 ;
        /*00e0*/              @P2 EXIT ;
        /*00f0*/                   BRA 0x10 ;
        /*0100*/                   EXIT ;
"""


@pytest.mark.parametrize("library", [None, "other/libwindow_trace_0.so"])
def test_march_loop_instructions_counts_the_fine_path(monkeypatch, library):
    """The fine crossing is the shortest way from the loop head back to
    it (7 instructions here); the loop's span covers the skip path too.
    The library read is this tree's, or the one named."""
    read = []

    def run(cmd, **kw):
        read.append(cmd[-1])
        return types.SimpleNamespace(stdout=FAKE_SASS)

    monkeypatch.setattr(event_lab.subprocess, "run", run)
    monkeypatch.setattr(event_lab._build, "nvcc_path", lambda: "/cuda/nvcc")
    monkeypatch.setattr(event_lab._build, "library_path", lambda name: "lib")
    assert event_lab.march_loop_instructions(library) == {"fine_crossing": 7,
                                                          "loop_span": 15}
    assert read == [library or "lib"]


# two probe kernels as `cuobjdump -sass` prints them: the second one's loop
# (0x20-0x90) holds a 16-byte, an 8-byte and a byte shared load, a dp4a,
# a global and a constant load; the first one's loop must not be read
FAKE_PROBE_SASS = """
        Function : _ZN12_GLOBAL__N_111loop_kernelILi1ELi8ELi4EEEvPKi
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/              @P0 BRA 0x0 ;
        Function : _ZN12_GLOBAL__N_111loop_kernelILi1ELi64ELi4EEEvPKi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/              @!P1 LDS.64 R8, [R3+0x10] ;
        /*0040*/                   LDS.U8 R9, [R3] ;
        /*0050*/                   IDP.4A.U8.U8 R9, R4, UR6, R9 ;
        /*0060*/                   LDG.E.CONSTANT R10, desc[UR8][R12.64] ;
        /*0070*/                   LDC R11, c[0x0][0x240] ;
        /*0080*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0090*/              @P0 BRA 0x20 ;
        /*00a0*/                   EXIT ;
"""


def test_probe_loop_sass_counts_the_loop_of_the_named_kernel(monkeypatch):
    monkeypatch.setattr(event_lab.subprocess, "run", lambda cmd, **kw:
                        types.SimpleNamespace(stdout=FAKE_PROBE_SASS))
    monkeypatch.setattr(event_lab._build, "nvcc_path", lambda: "/cuda/nvcc")
    monkeypatch.setattr(event_lab._build, "library_path", lambda name: "lib")
    assert event_lab.probe_loop_sass(
        "loop_probe", r"loop_kernelILi1ELi64ELi4EE") == {
        "instructions": 8, "shared_loads": 3, "shared_load_bytes": 25,
        "shared_bank_bytes": 28, "dp4a": 1, "global_loads": 1,
        "constant_loads": 1}


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN37_GLOBAL__N__c6aadfbd_15_window_trace_cu_wt_trace12trace_kernelEPKfS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN37_GLOBAL__N__c6aadfbd_15_window_trace_cu_wt_trace12trace_kernelEPKfS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__e755e4d6_8_shade_cu_785f9c2712shade_kernelILi8ELb1EEEvNS_7ShadeInE' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__e755e4d6_8_shade_cu_785f9c2712shade_kernelILi8ELb1EEEvNS_7ShadeInE
    64 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 91 registers, used 1 barriers, 16 bytes smem, 640 bytes cmem[0]
"""


def test_resource_usage_reads_the_assembler_report(tmp_path, monkeypatch):
    lib = tmp_path / "libx.so"
    (tmp_path / "libx.so.log").write_text(PTXAS_LOG)
    monkeypatch.setattr(_build, "library_path", lambda name: str(lib))
    assert _build.resource_usage("x") == [
        {"kernel": "trace_kernel", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 48, "smem": 0},
        {"kernel": "shade_kernel<8,1>", "stack": 64, "spill_stores": 4,
         "spill_loads": 8, "registers": 91, "smem": 16}]
