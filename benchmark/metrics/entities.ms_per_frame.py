"""entities.ms_per_frame: device ms a frame of the ops launched inside the
program's `render.entities` span: the fused path's entity triangles, the
triangle sweep and the gathers that make K2's entity stream
(`renderer.py::entity_attrs`).  Left out of a trace that lost kernel
records; silent where the trace holds no such span (a frame without
entities)."""

from benchmark.harness import program

SPAN = "render.entities"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, SPAN)
