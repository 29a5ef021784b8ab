"""frame_loop.host_bound_ms: ms a frame in which the card runs nothing
while the host is inside one of the program's spans (`renderer.*`,
`render.*`, `sync.*`): the card waiting on the program's host work.
Idle time outside them (the harness between images) is left out.  Left
out of a trace that lost kernel records or holds no device operation,
and silent where it holds no program span."""

from benchmark.harness import program


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    if not trace.whole() or not trace.ops:
        return None
    inside = program.spans(trace)
    if not inside:
        return None
    ns = program.overlap_ns(program.idle(trace), inside)
    return program.per_frame(trace, ns * 1e-6)
