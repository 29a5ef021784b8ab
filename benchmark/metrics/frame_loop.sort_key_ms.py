"""frame_loop.sort_key_ms: device ms a frame of the ops launched inside
the program's `render.sort_key` span: the bounce sort's key
(`bounce_sort_key`).  With `render.permute` (the sort and its gathers)
it makes up `frame_loop.sort_ms`.  Left out of a trace that lost kernel
records; silent where the trace holds no such span."""

from benchmark.harness import program

SPAN = "render.sort_key"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, SPAN)
