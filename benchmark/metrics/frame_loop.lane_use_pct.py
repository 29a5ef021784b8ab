"""frame_loop.lane_use_pct: the share of the ray slots given to each
bounce's shade (and trace) that hold an alive ray, in %: 100 x the
program's `rays_alive` over its `ray_slots` counter, over the window's
images.  The compaction's bucket (n, n/2 or n/4) sets the slots; bounce
0's rays are all alive.  Silent where the program keeps no such
counters."""

from benchmark.harness import program


def install(spans, system) -> bool:
    return program.install_counters(spans, system)


def read(trace):
    slots = program.counted(trace, "ray_slots")
    alive = program.counted(trace, "rays_alive")
    if not slots or not alive:
        return None
    return 100.0 * alive / slots
