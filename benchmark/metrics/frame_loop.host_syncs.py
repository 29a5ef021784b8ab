"""frame_loop.host_syncs: the points a frame where the host waits for the
card (the program's `host_syncs` counter, one `sync.*` span each): the
compaction counts, the audit read, the image copy.  Counted over the
window's images by a wrapper of the system's `frame`; silent where the
program keeps no such counter."""

from benchmark.harness import program


def install(spans, system) -> bool:
    return program.install_counters(spans, system)


def read(trace):
    return program.per_frame(trace, program.counted(trace, "host_syncs"))
