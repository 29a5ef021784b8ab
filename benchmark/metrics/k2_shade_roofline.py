"""k2_shade_roofline: the fused shade K2's share of its roofline, in %.

The bytes its launches had to move (`harness/peaks.py::k2_bytes`, from
each launch's own ray count and tables, recorded by a wrapper that the
harness hands `render_frame` as its `shade`) over the HBM peak, divided
by the device time of K2's records (`shade_kernel`).  K2 is bound by
bytes: its operations take less time at the card's issue rate.  Left
out unless the trace holds a record of every K2 launch the program
counted and the wrapper counted the bytes of each of them.
"""

import functools
import importlib
import inspect

from benchmark.harness import peaks

KERNEL = "shade_kernel"
MODULE = "wavefront_tpu_torch.render.renderer"
KEY = "k2_shade"


def install(spans, system) -> bool:
    try:
        mod = importlib.import_module(MODULE)
    except ImportError:
        return False
    frame = getattr(mod, "render_frame", None)
    if frame is None or getattr(frame, "_bench_k2", False):
        return frame is not None
    try:
        default = inspect.signature(frame).parameters["shade"].default
    except (KeyError, TypeError, ValueError):
        return False
    records = spans.records[KEY]

    @functools.wraps(frame)
    def wrapped(*a, **kw):
        shade = kw.get("shade", default)

        def counted(tables, go, o, *rest, **skw):
            table_bytes = sum(t.numel() * t.element_size() for t in (
                tables.atlas, tables.nodes, tables.prims))
            records.append(peaks.k2_bytes(
                int(o.x.shape[0]), table_bytes,
                bf16=bool(skw.get("color_bf16")),
                stream=skw.get("tri_attrs") is not None))
            return shade(tables, go, o, *rest, **skw)

        return frame(*a, **{**kw, "shade": counted})

    wrapped._bench_k2 = True
    mod.render_frame = wrapped
    return True


def read(trace):
    counted = trace.records.get(KEY, [])
    if not trace.whole(KERNEL) or len(counted) != trace.launches(KERNEL):
        return None
    nbytes = sum(counted)
    ms = trace.device_ms(KERNEL)
    if not nbytes or ms <= 0:
        return None
    return 100.0 * (nbytes / peaks.HBM_BYTES_PER_S * 1e3) / ms
