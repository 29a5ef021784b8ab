"""shade.nee_crossings: the light-prim crossings a frame that the sparse
NEE sweep found (the program's `nee_crossings` counter), counted over
the window's images by a wrapper of the system's `frame`; silent where
the program keeps no such counter or no crossing was found."""

from benchmark.harness import program


def install(spans, system) -> bool:
    return program.install_counters(spans, system)


def read(trace):
    return program.per_frame(trace, program.counted(trace, "nee_crossings"))
