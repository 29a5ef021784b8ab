"""The frame path's spans and counters.

The frame path names its stages in spans (`span`): `renderer.*` around
`Renderer`'s calls, `render.*` around `render_frame`'s stages, and
`sync.*` around each point where the host waits for the device
(`host_sync`); the game's step names its managers in `world.*` spans.
A span is a `record_function` while a torch.profiler session records,
so it lands in that session's trace beside the device records and on
their clock; with no session recording it is one shared
no-op context.  The counters are always on (module-level ints, as the
kernels' `launches`): host syncs, the ray slots each bounce's shade
was given with the alive rays among them, and on the general shade's
sparse light path the light-prim crossings the NEE sweep found (counted
on the device and read with the frame's audit) and the levels the
light-BVH walk's plain version stepped (summed from loop counts the host
already holds; the card's walk is one kernel launch and counts none);
the active entity triangles each triangle sweep tested (counted on the
device and read with the frame's audit); and what the game's chunk
manager did (`count_world`).
`profiling.counters()` snapshots them with the frame kernels' launches.

This module imports nothing of the port, so the kernels' helpers and the
renderer import it at the top.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

# every span name of the frame path: a profiler whose events carry no
# activity type (torch 2.11's) tells a span from a host op by its name
SPAN_NAMES = (
    "renderer.render", "renderer.batch", "renderer.prepare",
    "render.frame", "render.raygen", "render.bounce", "render.sort_key",
    "render.permute", "render.compact", "render.k1_trace",
    "render.entities", "render.k2_shade", "render.shade", "render.merge",
    "render.restore", "render.postprocess", "render.light_pick",
    "render.nee_pdf", "render.texel",
    "sync.compaction_count", "sync.audit", "sync.image_copy",
    "sync.light_walk", "sync.reverse_walk", "sync.nee_sweep",
    "sync.nee_slots", "sync.nee_overflow", "sync.seed", "sync.tri_pool",
    "sync.nan_check",
    "world.managers", "world.chunk", "world.physics", "world.ego",
    "world.scene", "world.entity_table",
)
_NO_SPAN = contextlib.nullcontext()
# whether a profiler session records on this thread: the profiler's own
# state (torch 2.11's `torch.profiler.profile.start` leaves the Python
# flag `torch.autograd.profiler._is_profiler_enabled` unset)
_recording = torch._C._autograd._profiler_enabled

# the points where the host waits for the device; the ray slots of the
# bounces whose alive rays the host knows, and those alive rays
host_syncs = 0
ray_slots = 0
rays_alive = 0
# the sparse NEE sweep's light-prim crossings; the light-BVH walk's levels
# (its plain version's: the kernel on the card steps them unseen)
nee_crossings = 0
light_walk_levels = 0
# the active entity triangles of each triangle sweep, summed
entity_tris = 0
# the chunk manager's work: chunks asked of the generator, chunks whose
# data arrived, chunks evicted, window rebuilds applied to the scene, and
# block edits applied
WORLD_COUNTERS = ("chunks_requested", "chunks_adopted", "chunks_evicted",
                  "window_rebuilds", "block_edits")
world_counts = dict.fromkeys(WORLD_COUNTERS, 0)


def span(name: str, args=None):
    """A span named `name` while a torch.profiler session records (a
    `record_function`, with `args`, converted by `str`, as its
    arguments); otherwise one shared no-op context, which allocates
    nothing."""
    if _recording():
        return record_function(name, None if args is None else str(args))
    return _NO_SPAN


def host_sync(name: str):
    """Counts one host sync of the frame path and returns its span:
    `name` is the span's whole name, `sync.<what>`."""
    global host_syncs
    host_syncs += 1
    return span(name)


def count_lanes(slots: int, alive: int) -> None:
    """Counts a bounce's `slots` ray slots and the `alive` rays among
    them."""
    global ray_slots, rays_alive
    ray_slots += slots
    rays_alive += alive


def count_crossings(n: int) -> None:
    """Counts `n` light-prim crossings found by the sparse NEE sweep."""
    global nee_crossings
    nee_crossings += n


def count_walk_level() -> None:
    """Counts one level stepped by the light-BVH walk's plain version
    (`render/wavefront.py::light_walk_plain`, the CPU's walk; the card's
    kernel counts no levels)."""
    global light_walk_levels
    light_walk_levels += 1


def count_entity_tris(n: int) -> None:
    """Counts `n` active entity triangles swept (over a frame's
    sweeps)."""
    global entity_tris
    entity_tris += n


def count_world(name: str, n: int = 1) -> None:
    """Counts `n` of the chunk manager's events `name` (one of
    WORLD_COUNTERS)."""
    world_counts[name] += n


def device_events(prof) -> list:
    """The device records (kernels, copies, fills) among a finished
    torch.profiler session's events (`prof.events()`).  A span's
    device-side copy is left out: some profilers (torch 2.11's) give it
    the device's type, and it covers whole stages, not device work."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in SPAN_NAMES]
