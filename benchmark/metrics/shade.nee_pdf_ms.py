"""shade.nee_pdf_ms: device ms a frame of the ops launched inside the
program's `render.nee_pdf` span: the general shade's NEE pdf sweep (on a
sparse light set the crossing tests, the slots and the reverse walk).
Left out of a trace that lost kernel records; silent where the trace
holds no such span."""

from benchmark.harness import program

SPAN = "render.nee_pdf"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    return program.device_ms_per_frame(trace, SPAN)
