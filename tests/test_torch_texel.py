"""The port's texel fetch against the JAX package's, and the launch path
every kernel wrapper of the port shares.

`wavefront_tpu_torch.kernels.texel.texel_fetch` takes its plain version
(`texel_plain`, the function the CUDA kernel is held to on the card by
chip_smoke.py) for CPU tensors.  Here it runs against the JAX
`kernels/texel.py::texel_fetch` in interpret mode, as tests/test_texel.py
runs it, and against the numpy gather, on that file's five input classes
and on channel lists of one, all twelve, out of order and with a repeat.
A fetch copies float32 values, so every comparison is bit-exact.

The launch path (`kernels/_build.py::Launcher`) and the options of
`tools/kernel_times.py` are checked here without a card: each wrapper's
C signature against its source, and the tool's arguments.
"""

import glob
import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.kernels.texel import texel_fetch as jax_texel_fetch
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.texel import (
    texel_fetch,
    texel_index,
    texel_plain,
)
from wavefront_tpu_torch.tools import kernel_times

CHANS = (0, 1, 2, 3, 4, 5, 6, 8)
OTHER_CHANNELS = {"one_channel": (9,), "all_twelve": tuple(range(12)),
                  "unordered": (8, 3, 11, 0, 5), "repeated": (2, 2, 7, 2)}


def _gather_ref(atlas, tex, u, v):
    size = atlas.shape[1]
    ti = np.clip((u * size).astype(np.int32), 0, size - 1)
    tj = np.clip((v * size).astype(np.int32), 0, size - 1)
    return atlas[np.clip(tex, 0, atlas.shape[0] - 1), tj, ti]  # (N, nch)


def _inputs(name):
    """The five input classes of tests/test_texel.py:
    (atlas, tex, u, v, channels, jax tile)."""
    if name == "mixed":
        rng, n, n_tex = np.random.default_rng(0), 5000, 7
        wide, tile, chans = True, 1024, None
    elif name == "one_texture":
        rng, n, n_tex = np.random.default_rng(1), 1500, 4
        wide, tile, chans = False, 2048, None
    elif name == "unaligned":
        rng, n, n_tex = np.random.default_rng(3), 2048 + 37, 7
        wide, tile, chans = True, 256, None
    elif name == "tex_out_of_range":
        rng, n, n_tex = np.random.default_rng(2), 600, 3
        wide, tile, chans = False, 2048, None
    elif name == "channels":
        rng, n, n_tex = np.random.default_rng(4), 3000, 7
        wide, tile, chans = False, 2048, CHANS
    else:
        # the channel lists the kernel picks at run time
        rng, n, n_tex = np.random.default_rng(6), 777, 5
        wide, tile, chans = True, 256, OTHER_CHANNELS[name]
    atlas = rng.random((n_tex, 16, 16, 12), np.float32)
    if name == "one_texture":
        tex = np.full(n, 2, np.int32)
    elif name == "tex_out_of_range":
        tex = rng.integers(-2, 9, n, dtype=np.int32)
    else:
        tex = rng.integers(0, n_tex, n, dtype=np.int32)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    if wide:
        # [-0.1, 1.1]: coordinates past both edges clamp
        u, v = u * 1.2 - 0.1, v * 1.2 - 0.1
    return atlas, tex, u, v, chans, tile


@pytest.mark.parametrize("name", ["mixed", "one_texture", "unaligned",
                                  "tex_out_of_range", "channels",
                                  *OTHER_CHANNELS])
def test_texel_matches_jax_and_gather(name):
    atlas, tex, u, v, chans, tile = _inputs(name)
    args = tuple(torch.as_tensor(a) for a in (atlas, tex, u, v))
    got = texel_fetch(*args, channels=chans)
    assert torch.equal(got, texel_plain(*args, channels=chans))
    assert got.dtype == torch.float32 and got.is_contiguous()
    want = _gather_ref(atlas, tex, u, v)
    if chans is not None:
        want = want[:, list(chans)]
    np.testing.assert_array_equal(got.numpy(), want.T)
    jax_out = jax_texel_fetch(jnp.asarray(atlas), jnp.asarray(tex),
                              jnp.asarray(u), jnp.asarray(v), tile=tile,
                              channels=chans, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))


def test_texel_non_finite_lanes_saturate():
    """Miss and dead lanes reach the fetch with huge, infinite or NaN
    coordinates: NaN and negatives read texel 0, +huge reads size-1, and
    no lane indexes out of bounds."""
    rng = np.random.default_rng(5)
    atlas = torch.as_tensor(rng.random((3, 16, 16, 12), np.float32))
    bad = np.float32([np.nan, np.inf, -np.inf, 3e38, -3e38, 1e10, -1e10,
                      0.5])
    u = torch.as_tensor(np.repeat(bad, len(bad)))
    v = torch.as_tensor(np.tile(bad, len(bad)))
    tex = torch.as_tensor(
        rng.integers(-300, 2000, len(u)).astype(np.int32))
    t, tj, ti = texel_index(atlas, tex, u, v)
    want_cell = np.array([0, 15, 0, 15, 0, 15, 0, 8])
    np.testing.assert_array_equal(ti.numpy(), np.repeat(want_cell, len(bad)))
    np.testing.assert_array_equal(tj.numpy(), np.tile(want_cell, len(bad)))
    assert int(t.min()) >= 0 and int(t.max()) <= 2
    got = texel_fetch(atlas, tex, u, v, channels=CHANS)
    assert got.shape == (8, len(u)) and bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(
        got.numpy(), atlas.numpy()[t.numpy(), tj.numpy(), ti.numpy()]
        [:, list(CHANS)].T)


def test_texel_rejects_bad_channels():
    atlas = torch.zeros((2, 16, 16, 12))
    z = torch.zeros(4)
    for chans in ((), (12,), (-1,), tuple(range(12)) + (0,)):
        with pytest.raises(ValueError):
            texel_fetch(atlas, z.to(torch.int32), z, z, channels=chans)


def _c_signatures():
    """{C function: its parameters' letters (Launcher.signature plus the
    stream)} of every `extern "C"` function of the port's CUDA sources."""
    def letter(param):
        kind = param.split()[0]
        if "*" in param:
            return "p"
        return {"int": "i", "float": "f", "uint32_t": "u",
                "unsigned": "u"}[kind]

    out = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            out[m.group(1)] = "".join(
                letter(p.strip()) for p in m.group(2).split(","))
    return out


def test_launchers_match_their_c_functions():
    """Every wrapper's Launcher names a C function of its library and
    types each of its parameters as the source declares it, the stream
    last; building the modules loads no library."""
    sigs = _c_signatures()
    seen = []
    for name in _build.SOURCES:
        mod = importlib.import_module(f"wavefront_tpu_torch.kernels.{name}")
        for launcher in vars(mod).values():
            if isinstance(launcher, _build.Launcher):
                assert launcher.lib == name
                assert sigs[launcher.fn] == launcher.signature + "p"
                assert launcher._call is None
                seen.append(launcher.fn)
    assert sorted(seen) == sorted(sigs)


def _fake_launcher(result=0, current=0):
    """A Launcher whose typed function, stream and device calls are fakes
    that log what they are asked; the log and the device state returned
    beside it."""
    log, state = [], {"device": current}
    launcher = _build.Launcher("texel", "texel_launch", "pi", "fake")

    def call(*args):
        log.append(("launch", state["device"], args))
        if isinstance(result, Exception):
            raise result
        return result

    def set_device(d):
        log.append(("set", d))
        state["device"] = d

    launcher._call = call
    launcher._stream = lambda d: 1000 + d
    launcher._get_device = lambda: state["device"]
    launcher._set_device = set_device
    return launcher, log, state


def test_launcher_switches_device_only_when_it_differs():
    """On the current device a launch switches nothing; on another it
    makes that device current for the launch, with that device's stream,
    and restores the old one after it, also when the launch fails or
    raises."""
    launcher, log, state = _fake_launcher()
    assert launcher(0, 7, 3) == 0
    assert log == [("launch", 0, (7, 3, 1000))]
    log.clear()
    assert launcher(2, 7, 3) == 0
    assert log == [("set", 2), ("launch", 2, (7, 3, 1002)), ("set", 0)]
    assert state["device"] == 0
    for result in (700, RuntimeError("lost")):
        launcher, log, state = _fake_launcher(result, current=1)
        with pytest.raises(RuntimeError):
            launcher(3, 7, 3)
        assert log == [("set", 3), ("launch", 3, (7, 3, 1003)), ("set", 1)]
        assert state["device"] == 1


def test_launcher_asks_for_no_device_with_one_card():
    """With one card visible the launcher neither asks for the current
    device nor switches it: that card is current."""
    launcher, log, state = _fake_launcher()

    def no_query():
        raise AssertionError("asked for the current device")

    launcher._get_device = no_query
    launcher._one_card = True
    assert launcher(0, 7, 3) == 0
    assert log == [("launch", 0, (7, 3, 1000))]


def test_launcher_refuses_an_unknown_parameter_type():
    with pytest.raises(ValueError):
        _build.Launcher("texel", "texel_launch", "pix", "texel_fetch")


def test_kernel_times_takes_the_probe_kernels():
    args = kernel_times.parse(["--kernels", "loop_probe", "extract_cur",
                               "extract_win", "--root", "build/parent"])
    assert args.kernels == ["loop_probe", "extract_cur", "extract_win"]
    assert args.root == "build/parent"


def test_kernel_times_takes_the_histogram():
    args = kernel_times.parse(["--kernels", "radix", "--root",
                               "build/parent", "--reps", "50"])
    assert args.kernels == ["radix"] and args.reps == 50
    assert "radix" in kernel_times.KERNELS


def test_kernel_times_takes_frame_blocks():
    args = kernel_times.parse(["--frames", "25", "--blocks", "12"])
    assert (args.frames, args.blocks) == (25, 12)
    assert kernel_times.parse([]).blocks == 1


def test_kernel_times_options_parse_with_no_card(capsys):
    args = kernel_times.parse(["--kernels", "texel", "row_gather",
                               "--frames", "3", "--root", "build/parent"])
    assert args.kernels == ["texel", "row_gather"] and args.frames == 3
    assert kernel_times.parse([]).kernels == ["trace", "shade"]
    with pytest.raises(SystemExit) as e:
        kernel_times.parse(["--kernels", "sort"])
    assert e.value.code != 0
    with pytest.raises(SystemExit) as e:
        kernel_times.main(["--help"])
    assert e.value.code == 0
    usage = capsys.readouterr().out
    assert "--kernels" in usage and "--frames" in usage
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            kernel_times.main(["--kernels", "texel", "row_gather"])
        assert e.value.code not in (0, None)
