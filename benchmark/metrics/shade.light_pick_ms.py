"""shade.light_pick_ms: device ms a frame of the ops launched inside the
program's `render.light_pick` span: the general shade's light pick (the
stochastic light-BVH walk of a sparse light set, or the dense pick).
Left out of a trace that lost kernel records; silent where the trace
holds no such span."""

from benchmark.harness import program

SPAN = "render.light_pick"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, SPAN)
