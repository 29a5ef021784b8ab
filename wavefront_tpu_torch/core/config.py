"""Engine configuration: constants, static render settings, runtime
preferences and world-generation settings.

Field for field the same objects as `wavefront_tpu.core.config`, so a
settings object reads the same in both packages.  The renderer honours
`sort_bounces` (which bounces re-sort), `trace_skips` (the tracer's
empty-space skips) and `trace_presort` (the bounce sort's key) as the
reference does (`render/renderer.py`).  These are accepted and ignored:
  * `trace_tile`, `trace_unroll`, `trace_phases`, `trace_phase_events`,
    `trace_phases_at`, `trace_windows`, `trace_windows_hot`: the TPU
    kernel's tile, phase and resident-window schedule; the CUDA tracer
    walks one ray a thread over the whole grid;
  * `trace_skip_stride`: alternates the TPU kernel's lean and full event
    forms, which the CUDA march does not have;
  * `trace_wskip`: the TPU kernel's skip of whole empty 32^3 windows; the
    port's aux grid has no whole-window skip;
  * `use_column_trace`: False picks the reference's XLA DDA, whose
    counterpart is the tracer's plain version, which the card's path
    never runs.
None of them changes an image.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Ray-march epsilon of the trace (reference raytrace.rs:16); the NEE pdf
# uses the smaller one (nee_pdf.rs:15).
EPSILON_BLOCK = 1e-3
EPSILON_NEE = 1e-4

# Maximum ray parameter (raytrace.rs:368).
T_MAX = 1000.0

# Distance that missed rays are propelled to (raytrace.rs:529).
MISS_DISTANCE = 5000.0

# Sky: emissivity 50 iff direction . (0,1,0) > 0.9 (raytrace.rs:532).
SKY_EMISSION = 50.0
SKY_COS_CUTOFF = 0.9

# Emission texture scale (raytrace.rs:585).
EMISSION_SCALE = 1000.0

# One-sample MIS probability of sampling the light (raytrace.rs:622).
NEE_MIS_WEIGHT = 0.3


@dataclass(frozen=True)
class RenderSettings:
    """Static renderer geometry and path options."""

    width: int = 1024
    height: int = 1024
    num_bounces: int = 6
    # supersampling factor: rays are traced at (width*scale, height*scale)
    # and box-filtered down (postprocess)
    scale: int = 1
    # step budget of the reference's XLA DDA; the port's tracer budget is
    # per ray and defaults to window_trace.auto_events (see trace_events)
    max_trace_steps: int = 256
    # sparse light sets (past 512 nodes): slots per ray of the NEE pdf
    # sweep; a ray that crosses more light prims under-counts its pdf and
    # is counted in aux["nee_overflow"] when trace_audit is on.  The dense
    # path has no cap.
    max_nee_hits: int = 8
    # level cap of the light-BVH descent and of its reverse walk
    max_bvh_depth: int = 32
    # the reference's pool size; the port's pool belongs to the scene
    # (VoxelScene(max_entity_tris=...))
    max_entity_tris: int = 64
    # sub-pixel jitter amplitude in pixels (0 = reference behaviour)
    jitter: float = 0.0
    # terminal-ray compaction: sort alive rays first and shade the smallest
    # of n, n/2, n/4 that holds them
    compaction: bool = False
    # keep bounce 0's intersections of a pose and reuse them for later
    # frames at that pose (they do not depend on the frame's seed); the
    # renderer holds them only while jitter is 0
    cache_primary: bool = False
    # accepted for settings parity; the port has one tracer
    use_column_trace: "bool | None" = None
    # the bounce sort's key: the tracer's coherence key (True), or the
    # reference's non-hoisted key, morton >> 1 for sort_type 1 (False)
    trace_presort: bool = True
    # per-ray event budget of the tracer; 0 = auto_events(gx, gy, gz)
    trace_events: int = 0
    trace_windows: int = 1
    trace_phases: int = 1
    trace_phase_events: int = 64
    trace_phases_at: tuple = ()
    trace_windows_hot: int = 0
    trace_tile: int = 1024
    # False: the tracer marches without its empty-space skips (aux & 3)
    trace_skips: bool = True
    trace_wskip: bool = True
    trace_unroll: int = 1
    trace_skip_stride: int = 1
    # count rays that exhausted the tracer's budget (aux["truncated"]) and
    # rays that overflowed the sparse NEE sweep (aux["nee_overflow"])
    trace_audit: bool = False
    # None or True: the fused shade kernel, falling back (with a warning)
    # to the general path for a light set that is sparse or past the
    # kernel's caps of 512 nodes / 256 prims; False: the general path
    # (plain stages around the texel kernel)
    shade_fused: "bool | None" = None
    # None: every bounce re-sorts; a tuple: only the bounces it names
    sort_bounces: "tuple | None" = None
    # general path only: True fetches texels with the texel kernel, False
    # with PyTorch's indexed read of the atlas (same texels)
    shade_texel_kernel: bool = True
    # the bf16 color pipeline (render/renderer.py)
    shade_bf16: bool = False
    # stage-isolation timing variants: "freetrace" (a synthetic constant
    # hit replaces the tracer), "notex" (a constant texel replaces the
    # fetch), "nonee_pdf" (the NEE pdf sweep is elided); the last two run
    # on the general path
    debug_stage: str = ""

    @property
    def render_width(self) -> int:
        return self.width * self.scale

    @property
    def render_height(self) -> int:
        return self.height * self.scale

    @property
    def n_rays(self) -> int:
        return self.render_width * self.render_height

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RenderingPreferences:
    """Runtime preferences (reference camera.rs:37-58).

    nee_type: 0 = BSDF sampling only, 1 = NEE on every bounce,
              2 = NEE on the first bounce only (raytrace.rs:614).
    sort_type: 0 = no inter-bounce sort, 1 = coherence sort.
    debug_view: 0 = the radiance image; otherwise the ray-layout view
              (bounce-1 ray slots painted with their 2-D morton position).
    """

    nee_type: int = 0
    debug_view: int = 0
    sort_type: int = 0
    should_screenshot: bool = False

    def replace(self, **kw) -> "RenderingPreferences":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class WorldSettings:
    """Voxel world geometry (reference chunk.rs:13-15, chunk_manager.rs:29-37)."""

    chunk_size: int = 32
    load_radius: int = 6
    evict_radius: int = 8
    # worldgen parameters (reference chunk.rs:70-104)
    noise_scale: float = 20.0
    noise_threshold: float = 0.2
    depth_gradient: float = 50000.0
    worldgen_seed: int = 0
    # every voxel with |wx|,|wy|,|wz| < 3 becomes a lamp (chunk.rs:102-104)
    central_lamp: bool = True

    def replace(self, **kw) -> "WorldSettings":
        return dataclasses.replace(self, **kw)
