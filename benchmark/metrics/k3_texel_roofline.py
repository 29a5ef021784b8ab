"""k3_texel_roofline: the texel kernel K3's share of its roofline, in %.

The bytes its launches had to move (per ray the texture slot, u and v
in and 4 bytes a channel out, and the atlas read once: the arithmetic of
`chip_smoke.py::texel_bound_ms`), from each launch's own ray and channel
counts and atlas, recorded by a wrapper that the harness hands
`render_frame` as its `texel`, over the HBM peak, divided by the device
time of K3's records (`texel_kernel`).  K3 is bound by bytes.  Left out
unless the trace holds a record of every K3 launch the program counted
and the wrapper counted the bytes of each of them.
"""

import functools
import importlib
import inspect

from benchmark.harness import peaks

KERNEL = "texel_kernel"
MODULE = "wavefront_tpu_torch.render.renderer"
KEY = "k3_texel"
# tex (int32), u and v (float32) in a ray; each channel a float32 out
BYTES_IN_PER_RAY = 12
BYTES_PER_CHANNEL = 4


def k3_bytes(rays: int, channels: int, atlas_bytes: int) -> int:
    """Bytes one K3 launch over `rays` rays and `channels` channels must
    move, the atlas once."""
    return rays * (BYTES_IN_PER_RAY + BYTES_PER_CHANNEL * channels) \
        + atlas_bytes


def install(spans, system) -> bool:
    try:
        mod = importlib.import_module(MODULE)
    except ImportError:
        return False
    frame = getattr(mod, "render_frame", None)
    if frame is None or getattr(frame, "_bench_k3", False):
        return frame is not None
    try:
        default = inspect.signature(frame).parameters["texel"].default
    except (KeyError, TypeError, ValueError):
        return False
    records = spans.records[KEY]

    @functools.wraps(frame)
    def wrapped(*a, **kw):
        texel = kw.get("texel", default)

        def counted(atlas, tex, u, v, channels=None):
            out = texel(atlas, tex, u, v, channels=channels)
            records.append(k3_bytes(int(tex.shape[0]), int(out.shape[0]),
                                    atlas.numel() * atlas.element_size()))
            return out

        return frame(*a, **{**kw, "texel": counted})

    wrapped._bench_k3 = True
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
