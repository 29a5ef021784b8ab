"""entry.image_copy_ms: device ms a frame of the ops launched inside the
program's `sync.image_copy` span: the image's copy to the host
(`Renderer.render` and `render_batch`, one copy an image).  Left out of
a trace that lost kernel records; silent where the trace holds no such
span."""

from benchmark.harness import program

SPAN = "sync.image_copy"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, SPAN)
