"""The sparse NEE pdf sweep's kernel (`kernels/nee_sweep.py`,
`csrc/nee_sweep.cu`) against its plain version
(`render/wavefront.py::nee_sweep_plain`), and the renderer's reading of
its counts.

On the CPU: `nee_pdf_sweep` takes the plain version for CPU tensors and
never the kernel; the kernel's wrapper refuses CPU tensors and malformed
inputs; given a `counts` tensor the sweep adds its crossings and
overflowing rays there and reads nothing itself; a frame counts the
crossings and reports the overflow from its audit read; the operations
`tools/kernel_times.py` bounds the kernel by equal a float64 count over
every (ray, prim) pair.  The
plain version itself is held to the JAX package in
tests/test_torch_lights.py.

On the card (marker `cuda`; this file imports no JAX, so it runs there
with `--noconftest`): the kernel against the plain version on the same
CUDA tensors, on seeded sparse light sets built as the port builds them
(rooms of isolated lamp voxels; 100 lamps, 600 prims, more than one
shared-memory tile of 256; seeded quads and triangles; a stack of quads
that overflows the slots), at `max_hits` 1, 2, 8 and 16 (more than the 8
crossings a thread holds before it walks them), and on 524,288 rays,
more than the card keeps resident, so that the persistent grid's blocks
stride past their first group of rays; with rays that have no MIS
weight, no direction, or lie in a prim's plane, and rays aimed at prims'
edges and corners.  The kernel repeats the plain version's float32
operations, so the crossings are the same: the crossings and overflow
counts are equal, a ray with one crossing has the same pdf bit for bit,
and a ray with more is within 1e-6 relative (tests/_card.py: its slots
summed in slot order, the plain version's by PyTorch's reduction: at
most 7 roundings of terms of one sign).  One launch a call; a frame's
sweeps take no host sync.
"""

import numpy as np
import pytest
import torch

from wavefront_tpu_torch.core.config import EPSILON_NEE, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import general_setup
from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render import wavefront as wf
from wavefront_tpu_torch.render.scene import light_arrays
from wavefront_tpu_torch.tools import kernel_times
from wavefront_tpu_torch.utils import spans
from wavefront_tpu_torch.world.blocks import BlockRegistry

from _card import NEE_REL as REL
from _light_sets import lamp_room, quads_and_tris

N = 1 << 15
# rays of the cases past the kernel's resident grid: more than the 2048
# threads an SM holds at once, on every SM of a 132-SM card
N_GRID = 1 << 19


@pytest.fixture(scope="module")
def registry():
    return BlockRegistry.load("assets")


def quad_stack():
    """12 unit quads stacked along +z: a ray up the stack crosses all."""
    k = 12
    p0 = np.array([[-0.5, -0.5, 2.0 + i] for i in range(k)], np.float32)
    e1 = np.tile(np.float32([[1, 0, 0]]), (k, 1))
    e2 = np.tile(np.float32([[0, 1, 0]]), (k, 1))
    return lights_mod.build_light_set(p0, e1, e2, np.full(k, 5.0, np.float32),
                                      np.zeros(k, bool), 64,
                                      dense_threshold=8)


def light_set(name: str, registry):
    if name == "room_7":
        return lamp_room(registry, 24, 20, 7)
    if name == "room_11":
        return lamp_room(registry, 32, 30, 11)
    if name == "lamps_600":
        return lamp_room(registry, 64, 100, 3)
    if name == "quads_tris":
        return quads_and_tris(300, 5)
    return quad_stack()


def rays(ls, n: int, seed: int):
    """(point, normal, direction, mis) as numpy: rays from seeded points
    aimed at seeded points of seeded prims (two in five), at their edges
    and corners (one in five), along a prim's edge vector, in its plane
    (one in ten), and in seeded directions; one in ten with no MIS weight,
    one in twenty with no direction.  The normal leans toward the
    direction, so that every cosine is positive."""
    g = np.random.default_rng(seed)
    p, e1, e2 = (np.asarray(getattr(ls, f))[:ls.num_prims]
                 for f in ("p0", "e1", "e2"))
    lo, hi = p.min(0) - 4, p.max(0) + 4
    point = g.uniform(lo, hi, (n, 3))
    prim = g.integers(0, ls.num_prims, n)
    u, v = g.random(n), g.random(n)
    kind = g.random(n)
    edge = (kind >= 0.4) & (kind < 0.6)
    u[edge] = g.choice([0.0, 1.0], edge.sum())
    v[edge & (g.random(n) < 0.5)] = g.choice([0.0, 1.0])
    tri = np.asarray(ls.is_tri)[prim]
    fold = tri & (u + v > 1)
    u[fold], v[fold] = 1 - u[fold], 1 - v[fold]
    target = p[prim] + u[:, None] * e1[prim] + v[:, None] * e2[prim]
    d = target - point
    grazing = (kind >= 0.6) & (kind < 0.7)
    d[grazing] = np.where(g.random((grazing.sum(), 1)) < 0.5,
                          e1[prim[grazing]], e2[prim[grazing]])
    free = kind >= 0.7
    d[free] = g.normal(0, 1, (free.sum(), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[g.random(n) < 0.05] = 0.0
    normal = d + g.normal(0, 0.4, (n, 3))
    normal[~np.any(d != 0, axis=1)] = [0.0, 1.0, 0.0]
    flip = np.sum(normal * d, axis=1) <= 0
    normal[flip] = d[flip] + [0.0, 1e-3, 0.0]
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    mis = np.where(g.random(n) < 0.9, 0.3, 0.0)
    return tuple(a.astype(np.float32) for a in (point, normal, d, mis))


def _v3(a, dev):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=dev)
                for i in range(3)))


def tensors(ls, n: int, seed: int, dev):
    point, normal, d, mis = rays(ls, n, seed)
    return (light_arrays(ls, dev), _v3(point, dev), _v3(normal, dev),
            _v3(d, dev), torch.as_tensor(mis, device=dev))


def crossings(la, o, d, mis):
    """Each ray's light-prim crossings by the plain version's test."""
    live = (mis > 0) & vec_nonzero(d)
    out = torch.zeros_like(mis, dtype=torch.int64)
    for base in range(0, la.num_prims, 64):
        pid = torch.arange(base, base + 64, device=mis.device)
        out += wf._prim_tile_hits(la, o, d, live, pid)[0].sum(1)
    return out


def vec_nonzero(d):
    return (d.x != 0) | (d.y != 0) | (d.z != 0)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_hits", [1, 2, 8])
def test_cpu_tensors_take_the_plain_path(registry, max_hits):
    la, o, n, d, mis = tensors(light_set("room_7", registry), 2048, 1, "cpu")
    before = nee_sweep.launches
    syncs, crossed = spans.host_syncs, spans.nee_crossings
    counts = torch.zeros(2, dtype=torch.int64)
    want = wf.nee_sweep_plain(la, o, n, d, mis, 32, max_hits, counts)
    plain_syncs = spans.host_syncs - syncs
    got, ovf = wf.nee_pdf_sweep(la, o, n, d, mis, None, max_depth=32,
                                max_hits=max_hits, with_overflow=True)
    assert nee_sweep.launches == before
    assert torch.equal(got, want) and (want > 0).sum() > 100
    c = crossings(la, o, d, mis)
    assert counts.tolist() == [int(c.sum()), int((c > max_hits).sum())]
    assert ovf == int(counts[1]) and (ovf > 0 or max_hits > 1)
    # its own counts read in one sync, the crossings counted once
    assert spans.host_syncs - syncs == 2 * plain_syncs + 1
    assert spans.nee_crossings - crossed == int(counts[0]) > 0


def test_given_counts_the_sweep_reads_nothing_itself(registry):
    la, o, n, d, mis = tensors(light_set("stack", registry), 512, 2, "cpu")
    counts = torch.full((2,), 5, dtype=torch.int64)
    own = wf.nee_pdf_sweep(la, o, n, d, mis, None, max_hits=2)
    syncs, crossed = spans.host_syncs, spans.nee_crossings
    got = wf.nee_pdf_sweep(la, o, n, d, mis, None, max_hits=2, counts=counts)
    with_own = spans.host_syncs - syncs
    assert torch.equal(got, own)
    assert spans.nee_crossings == crossed
    c = crossings(la, o, d, mis)
    assert counts.tolist() == [5 + int(c.sum()), 5 + int((c > 2).sum())]
    syncs = spans.host_syncs
    wf.nee_pdf_sweep(la, o, n, d, mis, None, max_hits=2)
    assert spans.host_syncs - syncs == with_own + 1
    with pytest.raises(ValueError):
        wf.nee_pdf_sweep(la, o, n, d, mis, None, with_overflow=True,
                         counts=counts)


def test_kernel_wrapper_refuses_cpu_tensors(registry):
    la, o, n, d, mis = tensors(light_set("room_7", registry), 64, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        nee_sweep(la, o, n, d, mis, 32, 8, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("audit", [True, False])
def test_frame_reads_the_counts_with_its_audit(audit):
    """A general frame on a sparse light set: each bounce's sweep adds to
    one device tensor that the audit reads; the crossings counted are its
    sum, and the overflow is reported only under the trace audit."""
    scene, settings, basis, prefs = general_setup(32, 32, 2, device="cpu",
                                                  max_nee_hits=1)
    seen, real = [], rr.nee_pdf_sweep

    def spy(*a, **kw):
        seen.append(kw["counts"])
        return real(*a, **kw)

    rr.nee_pdf_sweep = spy
    try:
        crossed = spans.nee_crossings
        _, aux = rr.Renderer(settings.replace(trace_audit=audit),
                             device="cpu").render(scene, basis, prefs, 7,
                                                  with_aux=True)
    finally:
        rr.nee_pdf_sweep = real
    assert len(seen) == settings.num_bounces
    assert all(c is seen[0] for c in seen)
    total, overflow = seen[0].tolist()
    assert spans.nee_crossings - crossed == total > 0
    assert overflow > 0
    assert aux == {"truncated": 0, "nee_overflow": overflow if audit else 0}


def interior_rays(ls, n: int, seed: int):
    """(point, direction, mis) as CPU tensors: rays from seeded points,
    half aimed at seeded points inside seeded quads (0.1-0.9 along each
    edge), half in seeded directions; one in ten with no MIS weight, one
    in twenty with no direction.  No ray grazes a prim's edge or lies in
    its plane, so a float64 count of the crossing test agrees with the
    sweep's float32 one."""
    g = np.random.default_rng(seed)
    p, e1, e2 = (np.asarray(getattr(ls, f))[:ls.num_prims]
                 for f in ("p0", "e1", "e2"))
    assert not np.asarray(ls.is_tri)[:ls.num_prims].any()
    point = g.uniform(p.min(0) - 4, p.max(0) + 4, (n, 3))
    prim = g.integers(0, ls.num_prims, n)
    u, v = g.uniform(0.1, 0.9, (2, n, 1))
    d = p[prim] + u * e1[prim] + v * e2[prim] - point
    free = g.random(n) < 0.5
    d[free] = g.normal(0, 1, (free.sum(), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[g.random(n) < 0.05] = 0.0
    mis = np.where(g.random(n) < 0.9, 0.3, 0.0)
    return (_v3(point.astype(np.float32), "cpu"),
            _v3(d.astype(np.float32), "cpu"),
            torch.as_tensor(mis.astype(np.float32)))


def pairs_f64(la, o, d, live):
    """Every (ray, prim) pair's crossing test in float64, apart from the
    sweep's formula: the plane's t from the normal e1 x e2, the hit
    point's (u, v) from cross products, (h x e2).n / n.n and
    (e1 x h).n / n.n.  Returns (crossings a ray, the pairs of live rays
    with the plane ahead within T_MAX, each pair's hit)."""
    k = la.num_prims
    p0, e1, e2 = (getattr(la, f)[:k].double() for f in ("p0", "e1", "e2"))
    nv = torch.cross(e1, e2, dim=1)
    pt = torch.stack([o.x, o.y, o.z], 1).double()
    dr = torch.stack([d.x, d.y, d.z], 1).double()
    denom = dr @ nv.T
    t = ((p0 * nv).sum(1)[None, :] - pt @ nv.T) / denom
    h = pt[:, None, :] + dr[:, None, :] * t[..., None] - p0[None]
    nn = (nv * nv).sum(1)
    u = (torch.cross(h, e2[None].expand_as(h), dim=2) * nv).sum(2) / nn
    v = (torch.cross(e1[None].expand_as(h), h, dim=2) * nv).sum(2) / nn
    ahead = live[:, None] & (denom.abs() > 1e-12) & (t >= EPSILON_NEE) \
        & (t <= T_MAX)
    hit = ahead & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return hit.sum(1), int(ahead.sum()), hit


def test_kernel_times_counts_what_the_sweep_is_asked(registry):
    """`tools/kernel_times.py::nee_stats`, which S3's operations bound is
    counted from, on 48x48 rays at a lamp room equals a float64 count
    over every (ray, prim) pair (`pairs_f64`, not the sweep's crossing
    test): each ray's crossings, the live rays, the planes ahead within
    T_MAX, and the walk levels, each crossing's walk climbed from its
    prim's leaf."""
    ls = light_set("room_7", registry)
    la = light_arrays(ls, "cpu")
    o, d, mis = interior_rays(ls, 48 * 48, 6)
    depth = 32
    live = (mis > 0) & vec_nonzero(d)
    crossed, ahead, hit = pairs_f64(la, o, d, live)
    parent = la.node_parent.tolist()
    levels = 0
    for j in range(la.num_prims):
        k, walk = int(la.leaf_node[j]), 0
        while walk < depth and 0 <= parent[k] != 0xFFFFFFFF:
            k, walk = parent[k], walk + 1
        levels += walk * int(hit[:, j].sum())
    got = kernel_times.nee_stats(la, o, d, mis, depth)
    assert torch.equal(got[0], crossed)
    assert got[1:] == (int(live.sum()), ahead, levels)
    assert int(crossed.sum()) > 100 and levels > int(crossed.sum())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def hold(ls, n: int, seed: int, max_hits: int, dev):
    """The kernel on `n` seeded rays (`rays`) at light set `ls` against
    the plain version: one launch; the crossings and overflowing rays
    equal to the plain version's and to the crossing test's; a ray with
    one crossing or none bit for bit, one with more within REL.  Returns
    the counts."""
    la, o, n_, d, mis = tensors(ls, n, seed, dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    before = nee_sweep.launches
    got = nee_sweep(la, o, n_, d, mis, 32, max_hits, counts)
    assert nee_sweep.launches == before + 1
    want_counts = torch.zeros_like(counts)
    want = wf.nee_sweep_plain(la, o, n_, d, mis, 32, max_hits, want_counts)
    c = crossings(la, o, d, mis)
    torch.cuda.synchronize()
    assert counts.tolist() == want_counts.tolist() == [
        int(c.sum()), int((c > max_hits).sum())]
    assert bool(torch.isfinite(want).all())
    one = c == 1
    assert int((c > 0).sum()) > n // 10 and int((c > 1).sum()) > 100
    assert torch.equal(got[one], want[one])
    assert torch.equal(got[c == 0], want[c == 0])
    assert bool(((got - want).abs() <= REL * want.abs()).all())
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("max_hits", [1, 2, 8, 16])
@pytest.mark.parametrize("name", ["room_7", "room_11", "lamps_600",
                                  "quads_tris", "stack"])
def test_kernel_matches_plain(card, registry, name, max_hits):
    ls = light_set(name, registry)
    if name == "lamps_600":
        assert ls.num_prims == 600
    counts = hold(ls, N, 10 + max_hits, max_hits, card)
    if name == "stack" and max_hits < 12:
        assert counts[1] > 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lamps_600", "quads_tris"])
def test_kernel_matches_plain_past_its_resident_grid(card, registry, name):
    """N_GRID rays, more than the card holds resident at once: the
    persistent grid's blocks stride past their first group of rays."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert N_GRID > sms * 2048
    hold(light_set(name, registry), N_GRID, 40, 8, card)


@pytest.mark.cuda
def test_kernel_one_launch_a_call_and_none_for_no_rays(card, registry):
    la, o, n, d, mis = tensors(light_set("room_7", registry), 1000, 4, card)
    counts = torch.zeros(2, dtype=torch.int64, device=card)
    before = nee_sweep.launches
    a = nee_sweep(la, o, n, d, mis, 32, 8, counts)
    b = nee_sweep(la, o, n, d, mis, 32, 8, counts)
    assert nee_sweep.launches == before + 2 and torch.equal(a, b)
    first = int(counts[0]) // 2
    assert first > 0 and counts.tolist() == [2 * first, 0]
    empty = V3(*(c[:0] for c in o))
    got = nee_sweep(la, empty, empty, empty, mis[:0], 32, 8, counts)
    assert got.shape == (0,) and nee_sweep.launches == before + 2
    with pytest.raises(ValueError):
        nee_sweep(la, o, n, d, mis.double(), 32, 8, counts)
    with pytest.raises(ValueError):
        nee_sweep(la, o, n, d, mis, 32, 8, counts.int())


@pytest.mark.cuda
def test_frame_sweeps_take_no_host_sync(card):
    """A general frame on a sparse light set: one kernel launch a bounce,
    no host sync inside any sweep, and the crossings counted from the
    audit equal to the kernel's counts."""
    scene, settings, basis, prefs = general_setup(128, 72, 4, device="cuda")
    calls, real = [], rr.nee_pdf_sweep

    def spy(*a, **kw):
        syncs, launches = spans.host_syncs, nee_sweep.launches
        out = real(*a, **kw)
        calls.append((spans.host_syncs - syncs,
                      nee_sweep.launches - launches))
        return out

    renderer = rr.Renderer(settings)
    renderer.render(scene, basis, prefs, 1)
    rr.nee_pdf_sweep = spy
    try:
        crossed = spans.nee_crossings
        _, aux = renderer.render(scene, basis, prefs, 2, with_aux=True)
    finally:
        rr.nee_pdf_sweep = real
    assert calls == [(0, 1)] * settings.num_bounces
    assert spans.nee_crossings > crossed
    assert aux == {"truncated": 0, "nee_overflow": 0}
