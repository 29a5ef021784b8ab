"""frame_loop.compact_ms: device ms a frame of the ops launched inside the
program's `render.compact` span (the alive mask, its count and the
bucket's head copies) and `render.merge` span (the bucket's outputs
joined to the dead tail).  Left out of a trace that lost kernel records;
silent where the trace holds neither span."""

from benchmark.harness import program

SPANS = ("render.compact", "render.merge")


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, *SPANS)
