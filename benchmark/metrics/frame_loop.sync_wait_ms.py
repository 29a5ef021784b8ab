"""frame_loop.sync_wait_ms: host ms a frame inside the program's `sync.*`
spans, each around one point where the host waits for the card (the
work it waits on, and the copy out).  Read from the host spans; silent
where the trace holds none."""

from benchmark.harness import program


def install(spans, system) -> bool:
    return program.install_spans(spans)


def read(trace):
    iv = program.spans(trace, program.SYNC)
    return program.per_frame(trace, sum(b - a for a, b in iv) * 1e-6)
