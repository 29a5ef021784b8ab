"""A trace's kernel records are held against the program's launch
counters: a record the profiler lost leaves the metrics that read
records out of the line."""

import types

import pytest

from benchmark.harness.spec import reader
from benchmark.harness.tracing import FRAME_SPAN, WINDOW_SPAN, Trace


class Event:
    def __init__(self, kind, name, start, dur, corr=0):
        self._v = (kind, name, start, dur, corr)

    def activity_type(self):
        return self._v[0]

    def device_type(self):
        return "cpu" if self._v[0] in ("user_annotation", "cpu_op",
                                       "cuda_runtime") else "cuda"

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0


def session(k1_records: int, k2_records: int):
    """Two frames in a 1-ms window: launch calls and their kernels."""
    ev = [Event("user_annotation", WINDOW_SPAN, 0, 1_000_000),
          Event("user_annotation", FRAME_SPAN, 0, 500_000),
          Event("user_annotation", FRAME_SPAN, 500_000, 500_000)]
    t, corr = 10_000, 1
    for name, n in (("trace_kernel", k1_records), ("shade_kernel", 4)):
        for i in range(4):
            ev.append(Event("cuda_runtime", "cudaLaunchKernel", t, 1_000,
                            corr))
            if name == "trace_kernel" and i >= n or \
                    name == "shade_kernel" and i >= k2_records:
                pass  # the profiler lost this record
            else:
                ev.append(Event("kernel", f"void {name}<float>", t + 5_000,
                                20_000, corr))
            t += 100_000
            corr += 1
    results = types.SimpleNamespace(events=lambda: ev)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


LAUNCHED = {"trace_kernel": 4, "shade_kernel": 4, "texel_kernel": 0}


def test_whole_trace_reads_every_metric():
    tr = Trace(session(4, 4), 2, {"k2_shade": [10**6] * 4}, (), LAUNCHED)
    assert tr.lost == {} and tr.whole()
    assert reader("metrics", "k1_trace.ms_per_frame").read(tr) == \
        pytest.approx(4 * 0.020 / 2)
    assert reader("metrics", "frame_loop.device_ops").read(tr) == 4.0
    assert reader("metrics", "device.idle_pct").read(tr) == \
        pytest.approx(100.0 * (1 - 8 * 0.020 / 1.0))
    assert reader("metrics", "k2_shade_roofline").read(tr) is not None


@pytest.mark.parametrize("k1, k2", [(3, 4), (4, 2)])
def test_lost_records_silence_what_reads_them(k1, k2):
    tr = Trace(session(k1, k2), 2, {"k2_shade": [10**6] * 4}, (), LAUNCHED)
    lost = {n for n, r in (("trace_kernel", k1), ("shade_kernel", k2))
            if r < 4}
    assert set(tr.lost) == lost and not tr.whole()
    for name in ("frame_loop.device_ops", "device.idle_pct",
                 "frame_loop.sort_ms"):
        assert reader("metrics", name).read(tr) is None
    k1_read = reader("metrics", "k1_trace.ms_per_frame").read(tr)
    k2_read = reader("metrics", "k2_shade_roofline").read(tr)
    assert (k1_read is None) == ("trace_kernel" in lost)
    assert (k2_read is None) == ("shade_kernel" in lost)


def test_uncounted_launches_read_nothing():
    """Without the program's counters nothing can be held: the metrics
    that read records stay silent."""
    tr = Trace(session(4, 4), 2, {"k2_shade": [10**6] * 4}, (), None)
    assert not tr.whole()
    assert reader("metrics", "k1_trace.ms_per_frame").read(tr) is None
    assert reader("metrics", "frame_loop.device_ops").read(tr) is None
