"""world.managers_ms: host ms a step inside the program's `world.managers`
span, around `GameWorld.step`'s manager pipeline [chunk, physics, ego,
scene] (each manager in a `world.*` span of its own inside it).  Read
from the host spans, as `frame_loop.sync_wait_ms` reads the `sync.*`
spans; silent where the trace holds none (a program that does not name
its managers)."""

from benchmark.harness import program

SPAN = "world.managers"


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    iv = program.spans(trace, SPAN)
    return program.per_frame(trace, sum(b - a for a, b in iv) * 1e-6)
