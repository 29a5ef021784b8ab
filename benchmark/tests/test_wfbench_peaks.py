"""K2's byte count from a launch's shapes, and the roofline reader."""

import inspect
import types

import pytest
import torch

from benchmark.harness import peaks
from benchmark.harness.spec import reader


def test_k2_bytes_from_shapes():
    assert peaks.k2_bytes(2_073_600, 0) == 2_073_600 * 112
    assert peaks.k2_bytes(1000, 5000) == 1000 * 112 + 5000
    assert peaks.k2_bytes(1000, 0, bf16=True) == 1000 * 100
    assert peaks.k2_bytes(1000, 0, stream=True) == 1000 * 116


class FakeTrace:
    def __init__(self, k2_ms, records, launched=None, lost=()):
        self.frames = 2
        self.records = {"k2_shade": records}
        self._ms = k2_ms
        self._launched = len(records) if launched is None else launched
        self._lost = set(lost)

    def device_ms(self, match):
        return self._ms if match == "shade_kernel" else 0.0

    def whole(self, *names):
        return not self._lost & set(names)

    def launches(self, name):
        return self._launched if name == "shade_kernel" else 0


def test_roofline_share():
    mod = reader("metrics", "k2_shade_roofline")
    nbytes = 4 * peaks.k2_bytes(2_073_600, 100_000)
    bound_ms = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    got = mod.read(FakeTrace(2 * bound_ms, [nbytes // 4] * 4))
    assert got == pytest.approx(50.0)
    # nothing launched or nothing timed: silent, never 0
    assert mod.read(FakeTrace(1.0, [])) is None
    assert mod.read(FakeTrace(0.0, [nbytes])) is None


def test_roofline_silent_on_lost_or_uncounted_launches():
    """A K2 record the profiler lost, or a launch whose bytes the
    wrapper did not count, leaves the share out rather than off."""
    mod = reader("metrics", "k2_shade_roofline")
    nbytes = peaks.k2_bytes(2_073_600, 100_000)
    assert mod.read(FakeTrace(1.0, [nbytes] * 4)) is not None
    assert mod.read(FakeTrace(1.0, [nbytes] * 4,
                              lost={"shade_kernel"})) is None
    assert mod.read(FakeTrace(1.0, [nbytes] * 4, launched=5)) is None


def test_roofline_wrapper_counts_each_launch():
    """The wrapper hands render_frame a shade that records each launch's
    bytes from its rays and tables, and calls the real shade."""
    from benchmark.harness.tracing import Spans
    import wavefront_tpu_torch.render.renderer as r

    mod = reader("metrics", "k2_shade_roofline")
    saved = r.render_frame
    calls = []

    def fake_frame(*a, shade=None, **kw):
        tables = types.SimpleNamespace(atlas=torch.zeros(10),
                                       nodes=torch.zeros(4),
                                       prims=torch.zeros(6))
        for n in (100, 50):
            o = types.SimpleNamespace(x=torch.zeros(n))
            shade(tables, None, o, color_bf16=False, tri_attrs=None)
        return "img", {}

    def real_shade(*a, **kw):
        calls.append(a[2].x.shape[0])

    try:
        def proto(scene, shade=real_shade, **kw):
            pass

        fake_frame.__signature__ = inspect.signature(proto)
        r.render_frame = fake_frame
        spans = Spans()
        assert mod.install(spans, None)
        r.render_frame("scene")
        assert calls == [100, 50]
        assert spans.records["k2_shade"] == [
            peaks.k2_bytes(100, 80), peaks.k2_bytes(50, 80)]
    finally:
        r.render_frame = saved
