"""The entity triangle sweep's kernel (`kernels/tri_sweep.py`,
`csrc/tri_sweep.cu`, S5) against its plain version
(`render/intersect.py::triangle_sweep_plain`), on the card (marker
`cuda`; this file imports no JAX, so it runs there with `--noconftest`).

The kernel repeats the plain sweep's float32 operations in its order, so
hit, t and the winning slot are equal bit for bit on every ray, and the
barycentrics on every hit ray (a miss writes 0 where the plain sweep
keeps the first active triangle's), and both add the active triangles to
the caller's counter.  Its stream form (`entity_stream`) equals
`render/renderer.py::entity_attrs_plain` over the plain sweep: the merged
t and the flag word on every ray, the other 11 words on every ray an
entity wins (0 elsewhere), so the frame it shades is the plain stream's
bit for bit.  Held on the rays of all four bounces of a
1920x1080 frame of the game world (`app/main.py::build_world`, the
radius-6 window with the ego cube, the `world.orbit` cell's frame), and
at the edges: no active triangle, all 64 slots active, inactive slots
between active ones, a pool of more slots than a block stages at once,
rays parallel to a face (det about 0), two triangles at equal t (the
lower slot wins), zero-direction rays, hits at t_min and t_max, and
non-finite origins.  One launch a call, none for no rays, and no host
sync.  The CPU's side of the sweep is held in
tests/test_torch_world_cell.py.
"""

import argparse

import numpy as np
import pytest
import torch

from wavefront_tpu_torch.core.config import EPSILON_BLOCK, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.tri_sweep import entity_stream, tri_sweep
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render.intersect import (
    TriHit,
    triangle_sweep,
    triangle_sweep_plain,
)
from wavefront_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

DEV = "cuda"
N = 40_000           # not a multiple of the kernel's 256-thread block
CAP = 64


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device(DEV)


def bits(x):
    """The raw bits of a float32 tensor (so -0 and 0, and NaNs, differ)."""
    return x.contiguous().view(torch.int32)


def held(verts, active, o: V3, d: V3, t_min=EPSILON_BLOCK, t_max=T_MAX):
    """The kernel's sweep of the rays against the plain version's on the
    same CUDA tensors: hit, t and slot bit for bit on every ray, the
    barycentrics on every hit ray, one launch and no host sync, each
    adding the active triangles to its counter.  Returns the kernel's
    TriHit."""
    counts = [torch.zeros(1, dtype=torch.int64, device=DEV) for _ in "ab"]
    launches, syncs = tri_sweep.launches, spans.host_syncs
    got = TriHit(*tri_sweep(verts, active, o, d, t_min, t_max, counts[0]))
    torch.cuda.synchronize()
    n = o.x.shape[0]
    assert tri_sweep.launches - launches == int(n > 0)
    assert spans.host_syncs == syncs
    want = triangle_sweep_plain(verts, active, o, d, t_min=t_min,
                                t_max=t_max, counts=counts[1])
    assert torch.equal(got.hit, want.hit)
    assert torch.equal(bits(got.t), bits(want.t))
    assert got.tri.dtype == torch.int64
    assert torch.equal(got.tri, want.tri)
    h = got.hit
    assert torch.equal(bits(got.bary_u[h]), bits(want.bary_u[h]))
    assert torch.equal(bits(got.bary_v[h]), bits(want.bary_v[h]))
    assert not bool(got.bary_u[~h].any() | got.bary_v[~h].any())
    assert counts[0].item() == counts[1].item() \
        == (int(active.sum()) if n else 0)
    return got


def held_stream(arrays, verts, active, uv, tex, n_tex, o, d, pa, t):
    """The stream form against `entity_attrs_plain` over the plain sweep
    (the sweep's counterpart on the same CUDA tensors): the merged t and
    the flag word bit for bit on every ray, the 11 words on the rays an
    entity wins and 0 on the others; one launch, no host sync, the
    active triangles counted.  Returns the rays an entity wins."""
    counts = torch.zeros(1, dtype=torch.int64, device=DEV)
    launches, syncs = tri_sweep.launches, spans.host_syncs
    got_t, got = entity_stream(verts, active, uv, tex, n_tex, o, d, pa, t,
                               EPSILON_BLOCK, T_MAX, counts)
    torch.cuda.synchronize()
    assert tri_sweep.launches - launches == 1
    assert spans.host_syncs == syncs
    assert counts.item() == int(active.sum())
    sweep = rr.triangle_sweep
    rr.triangle_sweep = triangle_sweep_plain
    try:
        want_t, want = rr.entity_attrs_plain(
            arrays._replace(tri_verts=verts, tri_active=active, tri_uv=uv,
                            tri_tex=tex), o, d, pa, t)
    finally:
        rr.triangle_sweep = sweep
    assert torch.equal(bits(got_t), bits(want_t))
    assert torch.equal(got[11], want[11])
    use = ((got[11] >> 16) & 1).bool()
    for k in range(11):
        assert torch.equal(bits(got[k][use]), bits(want[k][use])), k
        assert not bool(got[k][~use].any()), k
    return use


def rays(g, n: int, lo=-3.0, hi=3.0):
    """n seeded rays: origins in a box, unit directions."""
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (V3.from_array(torch.as_tensor(o, device=DEV)),
            V3.from_array(torch.as_tensor(d, device=DEV)))


def pool(g, cap: int = CAP, active=None):
    """A pool of `cap` seeded triangles about the origin, those named by
    `active` (a bool array; default all) active."""
    c = g.uniform(-1.5, 1.5, (cap, 1, 3))
    v = (c + g.uniform(-0.8, 0.8, (cap, 3, 3))).astype(np.float32)
    a = np.ones(cap, bool) if active is None else np.asarray(active, bool)
    return (torch.as_tensor(v, device=DEV),
            torch.as_tensor(a, device=DEV))


def test_world_frame_bounces(card):
    """Every bounce's sweep of a 1920x1080 frame of the game world, as
    its renderer calls it (the stream form): the kernel's sweep equals
    the plain sweep, its stream the plain stream, the ego cube wins rays
    on bounce 0, and the frame equals bit for bit the frame shaded from
    the plain stream."""
    from wavefront_tpu_torch.app.main import build_world

    world = build_world(argparse.Namespace(
        width=1920, height=1080, bounces=4, max_steps=192, nee_type=1,
        sort_type=0, window_chunks=None, assets=None, headless=False,
        device=DEV, accumulate=False, drop_cubes=0, trace_audit=True))
    cm = world.managers[0]
    cm.synchronous, cm._async_rebuild_opt = True, False
    world.step()
    world.camera.yaw = 0.3
    seen, stream = [], rr.entity_stream

    def spy(*a):
        seen.append(a)
        return stream(*a)

    rr.entity_stream = spy
    try:
        world.frame_count = 7
        world.step()
    finally:
        rr.entity_stream = stream
    img = world.last_image
    assert world.last_aux == {"truncated": 0, "nee_overflow": 0}
    assert len(seen) == 4
    arrays = world.scene.get_arrays()
    for b, a in enumerate(seen):
        verts, active, o, d = a[0], a[1], a[5], a[6]
        assert int(active.sum()) == 12
        got = held(verts, active, o, d)
        use = held_stream(arrays, *a[:9])
        if b == 0:
            assert int(got.hit.sum()) > 1000 and int(use.sum()) > 1000
    attrs, sweep = rr.entity_attrs, rr.triangle_sweep
    rr.entity_attrs, rr.triangle_sweep = rr.entity_attrs_plain, \
        triangle_sweep_plain
    try:
        world.frame_count = 7
        world.step()
    finally:
        rr.entity_attrs, rr.triangle_sweep = attrs, sweep
    assert np.array_equal(world.last_image, img)


def test_seeded_pools(card):
    g = np.random.default_rng(5)
    o, d = rays(g, N)
    verts, active = pool(g)
    got = held(verts, active, o, d)
    assert int(got.hit.sum()) > N // 10
    # inactive slots between active ones
    mask = g.random(CAP) < 0.4
    mask[[0, CAP - 1]] = [False, True]
    verts, active = pool(g, active=mask)
    got = held(verts, active, o, d)
    assert bool(active[got.tri[got.hit]].all())
    # a pool of more slots than a block stages at once
    mask = g.random(700) < 0.5
    verts, active = pool(g, 700, mask)
    held(verts, active, o, d)


def test_no_active_triangle_and_no_rays(card):
    g = np.random.default_rng(6)
    o, d = rays(g, N)
    verts, active = pool(g, active=np.zeros(CAP, bool))
    got = held(verts, active, o, d)
    assert not bool(got.hit.any()) and bool((got.t == 3.0e38).all())
    assert not bool(got.tri.any())
    verts, active = pool(g)
    empty = V3(*(torch.zeros(0, device=DEV) for _ in range(3)))
    assert held(verts, active, empty, empty).hit.shape == (0,)


def test_equal_t_takes_the_lower_slot(card):
    """The same triangle in slots 3 and 7 (and 9, inactive): every hit
    names slot 3, as `argmin` picks the first of equal values."""
    g = np.random.default_rng(7)
    o, d = rays(g, N, -2.0, 2.0)
    mask = np.zeros(CAP, bool)
    mask[[3, 7]] = True
    v = np.zeros((CAP, 3, 3), np.float32)
    tri = np.array([[-2.0, -2.0, 0.0], [3.0, -2.0, 0.0], [-2.0, 3.0, 0.0]],
                   np.float32)
    v[[3, 7, 9]] = tri
    got = held(torch.as_tensor(v, device=DEV),
               torch.as_tensor(mask, device=DEV), o, d)
    assert int(got.hit.sum()) > N // 10
    assert bool((got.tri[got.hit] == 3).all())


def test_parallel_zero_and_non_finite_rays(card):
    """Rays along a face's plane (det about 0, one a hair off it), rays
    of zero direction and rays from infinite or NaN origins."""
    g = np.random.default_rng(8)
    verts, active = pool(g)
    v = verts.cpu().numpy()
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    n = 4096
    k = g.integers(0, CAP, n)
    a, b = g.random((2, n, 1)).astype(np.float32)
    # directions in each face's plane, nudged by 0, 1e-7 and 1e-4 of its
    # normal; origins just outside the face
    dirs = a * e1[k] + b * e2[k]
    nrm = np.cross(e1[k], e2[k])
    nudge = np.array([0.0, 1e-7, 1e-4], np.float32)[g.integers(0, 3, n)]
    dirs = (dirs + nudge[:, None] * nrm).astype(np.float32)
    org = (v[k, 0] - 0.5 * dirs).astype(np.float32)
    org[:64] = np.inf
    org[64:128] = np.nan
    org[128:192, 1] = -np.inf
    dirs[192:256] = 0.0
    dirs[256:320] = -0.0
    got = held(verts, active,
               V3.from_array(torch.as_tensor(org, device=DEV)),
               V3.from_array(torch.as_tensor(dirs, device=DEV)))
    assert not bool(got.hit[:320].any())


@pytest.mark.parametrize("bound", ["t_min", "t_max"])
def test_hits_at_the_range_ends(card, bound):
    """Rays that meet a face at t_min or t_max, and a few ulps on either
    side: in or out as the plain sweep decides."""
    g = np.random.default_rng(9)
    mask = np.zeros(CAP, bool)
    mask[0] = True
    v = np.zeros((CAP, 3, 3), np.float32)
    v[0] = [[-50.0, -50.0, 0.0], [80.0, -50.0, 0.0], [-50.0, 80.0, 0.0]]
    end = np.float32(EPSILON_BLOCK if bound == "t_min" else T_MAX)
    n = 8192
    t = end * (1.0 + np.float32(2 ** -23) * g.integers(-8, 9, n)).astype(
        np.float32)
    xy = g.uniform(-10.0, 10.0, (n, 2)).astype(np.float32)
    org = np.concatenate([xy, -t[:, None]], 1).astype(np.float32)
    dirs = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    got = held(torch.as_tensor(v, device=DEV),
               torch.as_tensor(mask, device=DEV),
               V3.from_array(torch.as_tensor(org, device=DEV)),
               V3.from_array(torch.as_tensor(dirs, device=DEV)))
    assert 0 < int(got.hit.sum()) < n


def test_stream_seeded(card):
    """The stream form on seeded pools, tracer hits and texture slots
    (some outside the atlas, which the flag word clamps), with inactive
    slots between active ones and zero-direction rays: the tracer's hit
    nearer than the triangle's keeps the ray."""
    from wavefront_tpu_torch.headline import headline_setup

    scene = headline_setup(32, 18, 1, device=DEV)[0]
    arrays = scene.get_arrays()
    n_tex = arrays.atlas_packed.shape[0]
    g = np.random.default_rng(11)
    o, d = rays(g, N)
    dz = d.x.clone()
    dz[:300] = 0.0
    d = V3(dz, d.y.clone(), d.z.clone())
    d.y[:300] = 0.0
    d.z[:300] = 0.0
    mask = g.random(CAP) < 0.6
    verts, active = pool(g, active=mask)
    uv = torch.as_tensor(g.random((CAP, 3, 2)), dtype=torch.float32,
                         device=DEV)
    tex = torch.as_tensor(g.integers(-3, n_tex + 5, CAP), dtype=torch.int32,
                          device=DEV)
    pa = torch.as_tensor(g.integers(0, 2 ** 20, N), dtype=torch.int32,
                         device=DEV)
    t = torch.as_tensor(g.uniform(0.0, 6.0, N), dtype=torch.float32,
                        device=DEV)
    use = held_stream(arrays, verts, active, uv, tex, n_tex, o, d, pa, t)
    assert N // 20 < int(use.sum()) < N
    assert not bool(use[:300].any())


def test_triangle_sweep_takes_the_kernel(card):
    """`triangle_sweep` launches S5 once for CUDA tensors and takes no
    host sync (no `sync.tri_pool`)."""
    g = np.random.default_rng(10)
    o, d = rays(g, N)
    verts, active = pool(g)
    launches, syncs = tri_sweep.launches, spans.host_syncs
    got = triangle_sweep(verts, active, o, d)
    torch.cuda.synchronize()
    assert tri_sweep.launches - launches == 1
    assert spans.host_syncs == syncs
    want = triangle_sweep_plain(verts, active, o, d)
    assert torch.equal(got.tri, want.tri)
    assert torch.equal(bits(got.t), bits(want.t))
