"""frame_loop.sort_ms: device ms a frame of the ops launched inside the
bounce sort (`render.renderer.bounce_sort_key` and `coherence_sort`,
wrapped in spans from here): the key, the sort and the gathers.  Left
out of a trace that lost kernel records."""

SPAN = "frame_loop.sort"
MODULE = "wavefront_tpu_torch.render.renderer"


def install(spans, system) -> bool:
    return (spans.wrap_global(MODULE, "bounce_sort_key", SPAN)
            and spans.wrap_global(MODULE, "coherence_sort", SPAN))


def read(trace):
    if not trace.whole():
        return None
    ms = trace.device_ms_under(SPAN)
    return None if ms is None or not trace.frames else ms / trace.frames
