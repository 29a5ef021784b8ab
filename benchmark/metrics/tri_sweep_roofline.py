"""tri_sweep_roofline: the entity triangle sweep S5's share of its
roofline, in %.

The least time its launches could take, the larger of the bytes they
must move over the HBM peak and the operations their inputs ask for over
the card's rate of plain float32 operations, from each launch's own ray
count and pool, divided by the device time of S5's records
(`tri_sweep_kernel`).  The program calls S5 in two forms, each wrapped
here where the program's module calls it: the sweep (`tri_sweep`, as
`render/intersect.py` calls it: the general shade's) and the fused
shade's, which also writes K2's entity stream (`entity_stream`, as
`render/renderer.py` calls it).  The pool's active triangles are counted
after the window, so the wrappers add no sync.

Bytes: per ray 24 in (origin and direction) and 21 out (hit, t, the slot
as int64, two barycentrics), the pool (36 bytes of vertices and the
active flag a slot) once; the stream form reads the tracer's pa and t
too and writes the merged t and the 12 stream words in place of the
sweep's outputs (84 a ray), and reads each slot's uv and texture too (65
a slot).  Operations: per ray and active triangle OPS_PER_TEST, the
elementwise operations of the plain sweep
(`render/intersect.py::triangle_sweep_plain`), and per ray those of its
result (the stream form's merge, texture clamp and flag too); the
stream's frame on the few rays an entity wins is left out, so the bound
is a floor.  Left out unless the trace holds a record of every S5 launch
the program counted and the wrappers saw each of them; silent where the
program has no such kernel.
"""

import functools
import importlib

from benchmark.harness import peaks

KERNEL = "tri_sweep_kernel"
KEY = "tri_sweep"
# (module, attribute, whether the stream form, the origin's argument
# position) of each form of S5 the program calls
FORMS = (("wavefront_tpu_torch.render.intersect", "tri_sweep", False, 2),
         ("wavefront_tpu_torch.render.renderer", "entity_stream", True, 5))
# 132 SMs x 128 float32 lanes x 1.98 GHz: one H100 SXM at 700 W
OPS_PER_S = 132 * 128 * 1.98e9
# by form (False: the sweep, True: the stream)
BYTES_PER_RAY = {False: 24 + 21, True: 32 + 52}
BYTES_PER_SLOT = {False: 37, True: 37 + 28}
# the plain sweep's elementwise operations: per ray and triangle the
# edge-direction cross (9), det (5), its test (2), 1 / det kept (3), the
# origin offset (3), u (6), the second cross (9), v (6), t (6), the range
# and direction tests (13), the miss select and the arg-min (2); per ray
# the direction test (5), the winner's gathers (3), the hit test, the
# slot select and its pool index (3); the stream's merge (8), texture
# clamp and flag (4) and merged t (1) in place of the last 6
OPS_PER_TEST = 64
OPS_PER_RAY = {False: 11, True: 18}


def s5_bytes(rays: int, slots: int, stream: bool = False) -> int:
    """Bytes one S5 launch over `rays` rays and a pool of `slots` slots
    must move, the pool once."""
    return rays * BYTES_PER_RAY[stream] + slots * BYTES_PER_SLOT[stream]


def s5_ops(rays: int, active: int, stream: bool = False) -> int:
    """Operations one S5 launch over `rays` rays and `active` active
    triangles computes."""
    return rays * (OPS_PER_RAY[stream] + active * OPS_PER_TEST)


def s5_bound_s(rays: int, slots: int, active: int,
               stream: bool = False) -> float:
    """The least seconds one launch could take on the card."""
    return max(s5_bytes(rays, slots, stream) / peaks.HBM_BYTES_PER_S,
               s5_ops(rays, active, stream) / OPS_PER_S)


def _wrap(mod, attr: str, stream: bool, at: int, records) -> bool:
    fn = getattr(mod, attr, None)
    if fn is None or not callable(fn):
        return False
    if getattr(fn, "_bench_s5", False):
        return True

    @functools.wraps(fn)
    def counted(*a, **kw):
        rays = int(a[at].x.shape[0])
        # an empty call launches nothing
        if rays:
            records.append((rays, a[1], stream))
        return fn(*a, **kw)

    counted._bench_s5 = True
    setattr(mod, attr, counted)
    return True


def install(spans, system) -> bool:
    records = spans.records[KEY]
    found = False
    for module, attr, stream, at in FORMS:
        try:
            mod = importlib.import_module(module)
        except ImportError:
            continue
        found = _wrap(mod, attr, stream, at, records) or found
    return found


def read(trace):
    counted = trace.records.get(KEY, [])
    if not counted or not trace.whole(KERNEL) \
            or len(counted) != trace.launches(KERNEL):
        return None
    active = {}
    bound = 0.0
    for rays, mask, stream in counted:
        if id(mask) not in active:
            active[id(mask)] = int(mask.sum())
        bound += s5_bound_s(rays, int(mask.shape[0]), active[id(mask)],
                            stream)
    ms = trace.device_ms(KERNEL)
    if bound <= 0 or ms <= 0:
        return None
    return 100.0 * bound * 1e3 / ms
