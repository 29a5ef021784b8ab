"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
`nvcc`; they carry the `cuda` marker and skip where there is no card.
Run them on the GPU machine with every other card test:

    python -m pytest tests/test_torch_card_paths.py tests/test_torch_cuda.py tests/test_torch_nee_sweep.py tests/test_torch_light_walk.py tests/test_torch_tri_sweep.py -q -m cuda --noconftest

(`--noconftest` because tests/conftest.py imports JAX, which the GPU
machine need not have; this file imports none of it.)  The tolerances
are those of tests/_card.py: the tracer's words may differ on at most
1e-5 of the rays (coplanar ties), every shade output within max |diff|
1e-3 and RMS 1e-5 (with and without the entity stream; K2's float32
light pick and pdf bit for bit at every prim bucket), K2's bf16 color build's
bfloat16 values within 1 bfloat16 ulp (stated at its test), the texel
fetch bit-exact, frames under the golden gate; the histogram and the
probe kernels compute integers (and sums in one fixed order), so they
equal their plain versions bit for bit; batched frames equal single
frames bit for bit.  The bounce sort's key repeats its plain version's
float32 operations and the permute copies values, so both equal their
plain versions bit for bit, and a streamed frame sorted by them equals
the frame sorted by the 64-bit key and the gathers.
"""

import numpy as np
import pytest
import torch

from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import (
    config1_grid,
    config1_pose,
    headline_setup,
)
from wavefront_tpu_torch.kernels import device_probe, extract_probe, loop_probe
from wavefront_tpu_torch.kernels import radix_hist as rh
from wavefront_tpu_torch.kernels.shade import (
    prep_shade_tables,
    shade_pass,
    shade_plain,
)
from wavefront_tpu_torch.kernels.ray_sort import (
    ray_key,
    ray_key_plain,
    ray_permute,
    ray_permute_plain,
)
from wavefront_tpu_torch.kernels.texel import texel_fetch, texel_plain
from wavefront_tpu_torch.kernels.window_trace import (
    auto_events,
    coherence_key,
    window_trace,
)
from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render.intersect import make_aux_grid, trace_plain
from wavefront_tpu_torch.render.renderer import (
    Renderer,
    bounce_sort_key,
    coherence_sort,
    entity_attrs,
    render_frame,
)
from wavefront_tpu_torch.render.scene import VoxelScene, light_arrays
from wavefront_tpu_torch.render.wavefront import raygen_soa
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry

from _card import bf16_ulp, golden_gate

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    reg = BlockRegistry.load("assets")
    return VoxelScene(reg, config1_grid(reg), (0, 0, 0),
                      max_light_prims=256, device="cuda")


def _rays(n_side=96, seed=0):
    b = config1_pose()
    o, d, rid = raygen_soa(b.eye, b.front, b.right, b.up, n_side, n_side,
                           device="cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = n_side * n_side
    # a fan of random directions from above the terrain, as a bounce makes
    o2 = torch.rand((n, 3), generator=g) * torch.tensor([16.0, 7.0, 16.0])
    o2 += torch.tensor([0.0, 5.01, 0.0])
    d2 = torch.randn((n, 3), generator=g)
    d2 /= d2.norm(dim=1, keepdim=True)
    o = V3(*(torch.cat([c, o2[:, i].cuda()]) for i, c in enumerate(o)))
    d = V3(*(torch.cat([c, d2[:, i].cuda()]) for i, c in enumerate(d)))
    return o, d, torch.cat([rid, rid + n]).contiguous()


def test_trace_kernel_matches_plain(scene):
    arrays = scene.get_arrays()
    o, d, _ = _rays()
    events = auto_events(*arrays.grid.shape)
    before = window_trace.launches
    got = window_trace(arrays, o, d, events)
    want = trace_plain(arrays, o, d, events)
    torch.cuda.synchronize()
    assert window_trace.launches == before + 1
    n = o.x.shape[0]
    for g, w in zip(got, want):
        assert int((g != w).sum()) <= 1e-5 * n
    assert int((got[0] & 1).sum()) > n // 4


def test_trace_kernel_exact_ties(scene):
    """Lattice-diagonal rays from voxel centers tie exactly at every
    crossing; the kernel must break the ties as the plain version does."""
    arrays = scene.get_arrays()
    g = np.random.default_rng(17)
    grid = (g.random((12, 12, 12)) < 0.2).astype(np.uint8)
    dirs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)],
                    np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cells = g.integers(0, 12, (64, 3)).astype(np.float32) + 0.5
    o = np.repeat(cells, len(dirs), axis=0)
    d = np.tile(dirs, (len(cells), 1))
    tied = arrays._replace(
        grid=torch.as_tensor(grid, device="cuda"),
        aux_grid=torch.as_tensor(make_aux_grid(
            grid, arrays.transparent.cpu().numpy(),
            arrays.translucent.cpu().numpy()), device="cuda"))

    def v3(a):
        return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]),
                                    device="cuda") for i in range(3)))

    got = window_trace(tied, v3(o), v3(d), 256)
    want = trace_plain(tied, v3(o), v3(d), 256)
    for gw, ww in zip(got, want):
        assert torch.equal(gw, ww)


def _cuda_v3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]),
                                device="cuda") for i in range(3)))


def _skip_case(case, arrays):
    """(grid, origins, directions) of a case where the march skips."""
    g = np.random.default_rng(23)
    reg = BlockRegistry.load("assets")
    stone, glass = reg.block_idx("stone"), reg.block_idx("glass")
    if case == "sky":
        # the golden scene: rays from above the terrain, most of them up
        # or level, so that they leave through air
        grid = arrays.grid.cpu().numpy()
        o = g.uniform((0.5, 5.2, 0.5), (15.5, 15.5, 15.5), (4096, 3))
        d = g.standard_normal((4096, 3))
        d[:, 1] = np.abs(d[:, 1]) * np.where(g.random(4096) < 0.8, 1, -1)
    elif case == "air_columns":
        # pillars on a floor, with tall columns of air between them; rays
        # down the columns, steep, level and along the axes
        grid = np.full((48, 64, 48), reg.air, np.uint8)
        grid[:, :2, :] = stone
        for x in range(3, 48, 9):
            for z in range(5, 48, 11):
                grid[x, :20 + (x * z) % 37, z] = (stone, glass)[(x + z) % 2]
        o = g.uniform((0.0, 30.0, 0.0), (48.0, 63.0, 48.0), (4096, 3))
        d = g.standard_normal((4096, 3))
        d[:2048, 1] = -np.abs(d[:2048, 1]) * 8.0
        d[2048:2560] = [0.0, -1.0, 0.0]
        d[2560:2600] = [1.0, 0.0, 0.0]
        d[2600:2640] = [0.0, 0.0, -1.0]
    else:
        # lattice-diagonal rays from voxel centers in a sparse grid: ties
        # at every crossing, skips between the solids
        grid = np.where(g.random((24, 24, 24)) < 0.01, stone,
                        reg.air).astype(np.uint8)
        dirs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                         for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)],
                        np.float64)
        cells = g.integers(0, 24, (128, 3)) + 0.5
        o = np.repeat(cells, len(dirs), axis=0)
        d = np.tile(dirs, (len(cells), 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return grid, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("case", ["sky", "air_columns", "sparse_ties"])
def test_trace_kernel_skips_match_plain(scene, case):
    """K1 with the empty-space skip against the plain march, skipped and
    unskipped, on rays that cross much air: at most 1e-5 of the words
    differ (a skip that lands beside a grazed edge), none on the ties."""
    arrays = scene.get_arrays()
    grid, o, d = _skip_case(case, arrays)
    aux = make_aux_grid(grid, arrays.transparent.cpu().numpy(),
                        arrays.translucent.cpu().numpy())
    assert (aux >> 2).max() >= 2
    skipping = arrays._replace(grid=torch.as_tensor(grid, device="cuda"),
                               aux_grid=torch.as_tensor(aux, device="cuda"))
    unskipped = skipping._replace(aux_grid=skipping.aux_grid & 3)
    o, d = _cuda_v3(o), _cuda_v3(d)
    events = auto_events(*grid.shape)
    got = window_trace(skipping, o, d, events)
    stats = {}
    for ref in (skipping, unskipped):
        want = trace_plain(ref, o, d, events, stats=stats)
        if ref is skipping:
            assert stats["skips"] > 0
        for gw, ww in zip(got, want):
            if case == "sparse_ties":
                assert torch.equal(gw, ww)
            else:
                assert int((gw != ww).sum()) <= max(1e-5 * o.x.shape[0], 0)
    assert not bool(((got[0] >> 22) & 1).any())


# lamp voxels of `_lamp_arrays` for each prim bucket P of the kernel
LAMPS_FOR_P = {8: 1, 16: 2, 32: 4, 64: 8, 128: 20, 256: 25}


def _lamp_arrays(n_lamps, cube=False):
    """The golden grid with its lamp block replaced by `n_lamps` lamp
    voxels hung in the air (six prims each; up to 25), as scene arrays on
    the card; `cube` adds a 4x3x4 cuboid entity over the lamps' row."""
    reg = BlockRegistry.load("assets")
    grid = config1_grid(reg)
    grid[6:9, 5:8, 6:9] = reg.air
    cells = [(x, 9 + (7 * x + z) % 5, z) for x in range(1, 15, 3)
             for z in range(1, 15, 3)][:n_lamps]
    for c in cells:
        grid[c] = reg.block_idx("lamp")
    scene = VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256,
                       device="cuda")
    if cube:
        scene.add_object("box", *meshes.cuboid((8.0, 6.5, 8.0),
                                               (4.0, 3.0, 4.0)))
    return scene.get_arrays()


@pytest.mark.parametrize("light_set", ["headline", "lamps_16", "lamps_32",
                                       "lamps_64", "lamps_128", "lamps_256"])
def test_shade_kernel_pick_and_pdf_bit_equal(light_set):
    """K2's once-per-ray node table gives the plain version's light pick
    and NEE pdf bit for bit at the headline's 6 prims and at every larger
    prim bucket up to 256 (512 nodes: a 2 KB table a ray, in local
    memory): every output equal, on the NEE and the lambertian bounce
    alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    if light_set == "headline":
        scene, _, basis, _ = headline_setup(160, 90, 4, device="cuda")
        arrays = scene.get_arrays()
        o, d, rid = raygen_soa(basis.eye, basis.front, basis.right,
                               basis.up, 160, 90, device="cuda")
        want_p = 8
    else:
        want_p = int(light_set.split("_")[1])
        arrays = _lamp_arrays(LAMPS_FOR_P[want_p])
        o, d, rid = _rays(64)
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    assert tables.p_prims == want_p and tables.dense
    n = o.x.shape[0]
    pa, pb, t = trace_plain(arrays, o, d, auto_events(*arrays.grid.shape))
    assert int((pa & 1).sum()) > n // 4
    one = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    zero = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    for bounce in (0, 1):
        args = (tables, arrays.grid_origin, o, d, pa, pb, t, one, zero, rid,
                3 + bounce, bounce, arrays.lights.num_prims)
        got = shade_pass(*args, nee_type=1)
        want = shade_plain(*args, nee_type=1)
        torch.cuda.synchronize()
        for gv, wv in zip(got, want):
            for gc, wc in zip(gv, wv):
                assert torch.equal(gc, wc)


@pytest.mark.parametrize("tri", [False, True], ids=["voxels", "entity"])
@pytest.mark.parametrize("p_prims", sorted(LAMPS_FOR_P))
def test_shade_kernel_bf16_matches_plain(p_prims, tri):
    """K2's bf16 color build against shade_plain's bf16 path at every prim
    bucket P and with and without the entity stream, on the NEE bounce
    and the one after: tp (bfloat16 in and out) within 1 bfloat16 ulp,
    radiance within 1 bfloat16 ulp of its bfloat16 term tp * emission,
    origin and direction within the float32 bounds.  Both round each
    color where the reference does, from the same float32 values, so
    they are expected equal; an ulp is allowed because a float32 input
    to a rounding point that comes from cos, sin, log or exp may round an
    ulp apart in CUDA and PyTorch and cross a bfloat16 boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    arrays = _lamp_arrays(LAMPS_FOR_P[p_prims], cube=tri)
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    assert tables.p_prims == p_prims and tables.dense
    o, d, rid = _rays(64)
    n = o.x.shape[0]
    pa, pb, t = trace_plain(arrays, o, d, auto_events(*arrays.grid.shape))
    tri_attrs = None
    if tri:
        t, tri_attrs = entity_attrs(arrays, o, d, pa, t)
        assert int(((tri_attrs[11] >> 16) & 1).sum()) > n // 100
    g = torch.Generator(device="cpu").manual_seed(p_prims)
    tp = V3(*(torch.rand(n, generator=g).cuda().to(torch.bfloat16)
              for _ in range(3)))
    rad = V3(*(torch.rand(n, generator=g).cuda() for _ in range(3)))
    for bounce in (0, 1):
        args = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid,
                7 + bounce, bounce, arrays.lights.num_prims)
        before = shade_pass.launches
        got = shade_pass(*args, nee_type=1, tri_attrs=tri_attrs,
                         color_bf16=True)
        assert shade_pass.launches == before + 1
        want = shade_plain(*args, nee_type=1, tri_attrs=tri_attrs,
                           color_bf16=True)
        torch.cuda.synchronize()
        for gv, wv in zip(got[:2], want[:2]):
            for gc, wc in zip(gv, wv):
                diff = (gc - wc).abs()
                assert float(diff.max()) < 1e-3
                assert float(diff.pow(2).mean().sqrt()) < 1e-5
        for gc, wc, r in zip(got[2], want[2], rad):
            assert gc.dtype == wc.dtype == torch.bfloat16
            assert bool(torch.isfinite(gc).all())
            assert bool(((gc.double() - wc.double()).abs()
                         <= bf16_ulp(wc.float())).all())
        for gc, wc, r in zip(got[3], want[3], rad):
            assert gc.dtype == torch.float32
            assert bool(((gc.double() - wc.double()).abs()
                         <= bf16_ulp(wc - r) + 1.2e-7 * wc.abs().clamp_min(1)
                         ).all())
    with pytest.raises(ValueError):
        shade_pass(*args, nee_type=1, tri_attrs=tri_attrs)


@pytest.mark.parametrize("nee_type", [0, 1, 2])
def test_shade_kernel_matches_plain(scene, nee_type):
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    o, d, rid = _rays()
    n = o.x.shape[0]
    pa, pb, t = trace_plain(arrays, o, d, auto_events(*arrays.grid.shape))
    g = torch.Generator(device="cpu").manual_seed(1)
    tp = V3(*(torch.rand(n, generator=g).cuda() for _ in range(3)))
    rad = V3(*(torch.rand(n, generator=g).cuda() for _ in range(3)))
    args = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid, 5, 1,
            arrays.lights.num_prims)
    got = shade_pass(*args, nee_type=nee_type)
    want = shade_plain(*args, nee_type=nee_type)
    torch.cuda.synchronize()
    for gv, wv in zip(got, want):
        for gc, wc in zip(gv, wv):
            assert bool(torch.isfinite(gc).all())
            diff = (gc - wc).abs()
            assert float(diff.max()) < 1e-3
            assert float(diff.pow(2).mean().sqrt()) < 1e-5


@pytest.fixture(scope="module")
def cube_scene():
    """Config 1 with a 4x3x4 cuboid entity over the lamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    reg = BlockRegistry.load("assets")
    s = VoxelScene(reg, config1_grid(reg), (0, 0, 0), max_light_prims=256,
                   device="cuda")
    s.add_object("box", *meshes.cuboid((8.0, 9.5, 8.0), (4.0, 3.0, 4.0)))
    return s


@pytest.mark.parametrize("nee_type", [0, 1])
def test_shade_kernel_with_tri_attrs_matches_plain(cube_scene, nee_type):
    arrays = cube_scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    o, d, rid = _rays()
    n = o.x.shape[0]
    pa, pb, t = trace_plain(arrays, o, d, auto_events(*arrays.grid.shape))
    t, tri_attrs = entity_attrs(arrays, o, d, pa, t)
    assert int(((tri_attrs[11] >> 16) & 1).sum()) > n // 100
    g = torch.Generator(device="cpu").manual_seed(1)
    tp = V3(*(torch.rand(n, generator=g).cuda() for _ in range(3)))
    rad = V3(*(torch.rand(n, generator=g).cuda() for _ in range(3)))
    args = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid, 5, 0,
            arrays.lights.num_prims)
    before = shade_pass.launches
    got = shade_pass(*args, nee_type=nee_type, tri_attrs=tri_attrs)
    assert shade_pass.launches == before + 1
    want = shade_plain(*args, nee_type=nee_type, tri_attrs=tri_attrs)
    torch.cuda.synchronize()
    for gv, wv in zip(got, want):
        for gc, wc in zip(gv, wv):
            assert bool(torch.isfinite(gc).all())
            diff = (gc - wc).abs()
            assert float(diff.max()) < 1e-3
            assert float(diff.pow(2).mean().sqrt()) < 1e-5
    with pytest.raises(ValueError):
        shade_pass(*args, nee_type=nee_type, tri_attrs=tri_attrs[:11])
    with pytest.raises(ValueError):
        shade_pass(*args, nee_type=nee_type,
                   tri_attrs=tri_attrs[:11] + (tri_attrs[11].float(),))


# one channel, the shade's eight, all twelve in order and by name,
# unordered, and with a repeat
TEXEL_CHANNELS = [None, (0, 1, 2, 3, 4, 5, 6, 8), (11,), tuple(range(12)),
                  (8, 3, 11, 0, 5), (2, 2, 7, 2)]


@pytest.mark.parametrize("channels", TEXEL_CHANNELS)
def test_texel_kernel_matches_plain(scene, channels):
    """Bit-exact on in-range lanes, lanes past both edges, out-of-range
    slots and non-finite coordinates; an unaligned ray count."""
    atlas = scene.get_arrays().atlas_packed
    n = 100_003
    g = torch.Generator(device="cpu").manual_seed(2)
    tex = torch.randint(-40, atlas.shape[0] + 40, (n,), generator=g,
                        dtype=torch.int32).cuda()
    uv = torch.rand((2, n), generator=g) * 1.2 - 0.1
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), 3e38,
                        -3e38, 1e10, -1e10])
    uv[0, ::13] = odd.repeat(n // (13 * 7) + 1)[:uv[0, ::13].shape[0]]
    uv[1, ::17] = odd.repeat(n // (17 * 7) + 1)[:uv[1, ::17].shape[0]]
    u, v = uv[0].cuda().contiguous(), uv[1].cuda().contiguous()
    before = texel_fetch.launches
    got = texel_fetch(atlas, tex, u, v, channels=channels)
    torch.cuda.synchronize()
    assert texel_fetch.launches == before + 1
    want = texel_plain(atlas, tex, u, v, channels=channels)
    assert got.shape == (12 if channels is None else len(channels), n)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), texel_plain(atlas.cpu(), tex.cpu(),
                                               u.cpu(), v.cpu(),
                                               channels=channels))


@pytest.mark.parametrize("n", [1, 37, 2085])
@pytest.mark.parametrize("channels", TEXEL_CHANNELS[1:])
def test_texel_kernel_small_ray_counts(scene, n, channels):
    """Ray counts below, at and past a block's: every lane written, none
    past N."""
    atlas = scene.get_arrays().atlas_packed
    g = torch.Generator(device="cpu").manual_seed(n)
    tex = torch.randint(-3, atlas.shape[0] + 3, (n,), generator=g,
                        dtype=torch.int32).cuda()
    uv = (torch.rand((2, n), generator=g) * 1.2 - 0.1).cuda()
    out = texel_fetch(atlas, tex, uv[0], uv[1], channels=channels)
    assert torch.equal(out, texel_plain(atlas, tex, uv[0], uv[1],
                                        channels=channels))


def test_texel_kernel_reads_a_misaligned_atlas(scene):
    """The kernel reads texel rows a float at a time, so an atlas that
    starts 4 bytes past a 16-byte boundary (a contiguous view at a storage
    offset) reads as the aligned one does."""
    atlas = scene.get_arrays().atlas_packed
    buf = torch.zeros(atlas.numel() + 1, device="cuda")
    moved = buf[1:].view(atlas.shape)
    moved.copy_(atlas)
    assert moved.is_contiguous() and moved.data_ptr() % 16 == 4
    g = torch.Generator(device="cpu").manual_seed(7)
    tex = torch.randint(0, atlas.shape[0], (999,), generator=g,
                        dtype=torch.int32).cuda()
    uv = torch.rand((2, 999), generator=g).cuda()
    for channels in TEXEL_CHANNELS:
        assert torch.equal(
            texel_fetch(moved, tex, uv[0], uv[1], channels=channels),
            texel_plain(atlas, tex, uv[0], uv[1], channels=channels))


def test_kernels_launch_on_the_current_stream(scene):
    """K7, K3 and K1 launched under `torch.cuda.stream(s)` read inputs
    that s writes after a delay: a launch on any other stream would read
    them before they are written (zeros)."""
    arrays = scene.get_arrays()
    atlas = arrays.atlas_packed
    rng = np.random.default_rng(3)
    table = _i32(rng.integers(0, 100, (512, 128)))
    idx_src = _i32(rng.integers(0, 512, (512, 128)))
    n = 4099
    tex_src = _i32(rng.integers(1, atlas.shape[0], n))
    uv_src = torch.as_tensor(rng.random((2, n), np.float32), device="cuda")
    o_src, d_src, _ = _rays(32)
    srcs = (idx_src, tex_src, uv_src, *o_src, *d_src)
    dsts = tuple(torch.zeros_like(x) for x in srcs)
    idx, tex, uv = dsts[:3]
    o, d = V3(*dsts[3:6]), V3(*dsts[6:9])
    events = auto_events(*arrays.grid.shape)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(20_000_000)
        for dst, src in zip(dsts, srcs):
            dst.copy_(src)
        got = (device_probe.row_gather_sum(table, idx, 3),
               texel_fetch(atlas, tex, uv[0], uv[1],
                           channels=(0, 1, 2, 3, 4, 5, 6, 8)),
               window_trace(arrays, o, d, events))
    s.synchronize()
    assert torch.equal(got[0], device_probe.row_gather_sum_plain(
        table, idx_src, 3))
    assert torch.equal(got[1], texel_plain(
        atlas, tex_src, uv_src[0], uv_src[1],
        channels=(0, 1, 2, 3, 4, 5, 6, 8)))
    want = trace_plain(arrays, o_src, d_src, events)
    for g, w in zip(got[2], want):
        assert int((g != w).sum()) <= 1e-5 * o.x.shape[0]


def test_texel_wrapper_checks_its_inputs(scene):
    atlas = scene.get_arrays().atlas_packed
    z = torch.zeros(8, device="cuda")
    zi = z.to(torch.int32)
    for bad in ((atlas, z, z, z), (atlas, zi, z.double(), z),
                (atlas, zi, z[::2], z[::2]), (atlas.cpu(), zi, z, z),
                (atlas[:, :, :8], zi, z, z)):
        with pytest.raises(ValueError):
            texel_fetch(*bad)
    with pytest.raises(ValueError):
        texel_fetch(atlas, zi, z, z, channels=(12,))


def test_general_frame_kernels_match_plain(cube_scene):
    """The general path on a sparse light set with an entity: the tracer
    and the texel fetch launch once per bounce and the fused shade never;
    the frame equals the plain versions' under the golden gate."""
    arrays = cube_scene.get_arrays()
    reg = cube_scene.registry
    p0, e1, e2, power = lights_mod.extract_voxel_lights(
        cube_scene.grid, np.zeros(3), reg)[:4]
    sparse = lights_mod.build_light_set(
        p0, e1, e2, power, np.zeros(len(p0), bool), 256, dense_threshold=8)
    arrays = arrays._replace(lights=light_arrays(sparse, "cuda"))
    assert not arrays.lights.dense
    settings = RenderSettings(width=64, height=64, num_bounces=3,
                              compaction=True, trace_audit=True)
    prefs = RenderingPreferences(nee_type=1)
    basis = config1_pose()
    wrappers = (window_trace, shade_pass, texel_fetch)
    before = [f.launches for f in wrappers]
    with pytest.warns(UserWarning, match="falling back"):
        got, aux = Renderer(settings).render(arrays, basis, prefs,
                                             frame_count=2, with_aux=True)
    assert [f.launches - b for f, b in zip(wrappers, before)] == [3, 0, 3]
    assert aux == {"truncated": 0, "nee_overflow": 0}
    want, _ = render_frame(
        arrays, basis.eye, basis.front, basis.right, basis.up, 2,
        settings=settings.replace(shade_fused=False), nee_type=1,
        sort_type=0, trace=trace_plain, shade=shade_plain, texel=texel_plain)
    golden_gate(got, want)


def test_frame_kernels_match_plain(scene):
    settings = RenderSettings(width=64, height=64, num_bounces=3,
                              compaction=True, trace_audit=True)
    prefs = RenderingPreferences(nee_type=1)
    basis = config1_pose()
    before = (window_trace.launches, shade_pass.launches)
    got, aux = Renderer(settings).render(scene, basis, prefs, frame_count=2,
                                         with_aux=True)
    assert (window_trace.launches, shade_pass.launches) == (
        before[0] + 3, before[1] + 3)
    assert aux["truncated"] == 0
    want, _ = render_frame(
        scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up, 2,
        settings=settings, nee_type=1, sort_type=0, trace=trace_plain,
        shade=shade_plain)
    golden_gate(got, want)


def test_wrappers_check_their_inputs(scene):
    arrays = scene.get_arrays()
    o, d, _ = _rays(8)
    bad = V3(o.x.double(), o.y, o.z)
    with pytest.raises(ValueError):
        window_trace(arrays, bad, d, 64)
    strided = V3(o.x[::2], o.y[::2], o.z[::2])
    with pytest.raises(ValueError):
        window_trace(arrays, strided, V3(d.x[::2], d.y[::2], d.z[::2]), 64)


# ---- the histogram and the probe kernels ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return np.random.default_rng(11)


def _i32(a):
    return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32),
                           device="cuda")


# K4 launches one block per 4096 keys (1024 threads, one 16-byte load
# each), up to the blocks the card holds at once: two a SM for one digit,
# one for four (RADIX_EDGES names those counts, resolved on the card)
RADIX_BLOCK_KEYS = 4 * 1024
RADIX_EDGES = {"block-1": (0, -1), "block+1": (0, 1),
               "cap1-1": (2, -1), "cap1+1": (2, 1),
               "cap4-1": (1, -1), "cap4+1": (1, 1)}


def _radix_n(n):
    if isinstance(n, int):
        return n
    per_sm, off = RADIX_EDGES[n]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return RADIX_BLOCK_KEYS * (per_sm * sms or 1) + off


def _radix_agrees(k):
    """Every form of K4 on keys k equals its plain version."""
    before = rh.digit_histogram.launches
    for shift in (0, 8, 16, 24, 3):
        got = rh.digit_histogram(k, shift)
        assert torch.equal(got, rh.hist_plain(k, shift))
        assert int(got.sum()) == k.shape[0]
    assert rh.digit_histogram.launches == before + 5
    four = rh.digit_histograms4(k)
    assert torch.equal(four, torch.stack(
        [rh.hist_plain(k, 8 * d) for d in range(4)]))
    want = rh.radix_hist_plain(k)
    assert torch.equal(rh.radix_hist(k), want)
    assert torch.equal(rh.radix_hist(k, one_read=True), want)
    assert torch.equal(rh.radix_hist(k).cpu(), rh.radix_hist(k.cpu()))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 1000, "block-1", "block+1",
                               "cap4-1", "cap4+1", "cap1-1", "cap1+1",
                               100_003])
def test_radix_hist_kernel_matches_plain(card, n):
    n = _radix_n(n)
    keys = torch.as_tensor(
        card.integers(0, 2 ** 32, n + 3, dtype=np.uint32).view(np.int32),
        device="cuda")
    # coherence-key-like: few distinct low digits, so warps contend
    skew = (keys & 0x7FC000E0).contiguous()
    # misaligned by one, two and three keys: a head before the first
    # 16-byte boundary
    for k in (keys[:n], skew[:n], keys[1:n + 1].clone(), keys[1:n + 1],
              keys[2:n + 2], keys[3:n + 3]):
        _radix_agrees(k)
    with pytest.raises(ValueError):
        rh.digit_histogram(keys.to(torch.int64), 0)
    with pytest.raises(ValueError):
        rh.digit_histogram(keys, 25)


def test_radix_hist_kernel_one_digit_value(card):
    """Every key with the same digits: one bin holds every count, and the
    lanes of a warp all count into one bin."""
    for n in (5, 4096 * 300 + 7):
        k = torch.full((n,), -0x3F2E1D0C, dtype=torch.int32, device="cuda")
        _radix_agrees(k)
        assert int(rh.digit_histogram(k, 0).max()) == n


def test_radix_hist_workspace_across_calls_and_streams(card):
    """64 calls back to back with no sync between them, and calls on two
    streams at once: each stream's kept workspace (accumulator and
    ticket) is left zero by every launch and shared by no other stream,
    so every result equals its plain version."""
    keys = [torch.as_tensor(card.integers(0, 2 ** 32, n, dtype=np.uint32)
                            .view(np.int32), device="cuda")
            for n in (1, 4097, 300_001, 2_073_600)]
    got = []
    for i in range(64):
        k = keys[i % len(keys)]
        got.append((k, i % 4, rh.digit_histogram(k, 8 * (i % 4)),
                    rh.radix_hist(k, one_read=bool(i & 1))))
    for k, p, hist, spine in got:
        assert torch.equal(hist, rh.hist_plain(k, 8 * p))
        assert torch.equal(spine, rh.radix_hist_plain(k))

    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = ([], [])
    for rep in range(8):
        for s, out in zip(streams, outs):
            with torch.cuda.stream(s):
                torch.cuda._sleep(1_000_000)
                for k in keys:
                    out.append((k, rh.radix_hist(k, one_read=True),
                                rh.radix_hist(k)))
    for s in streams:
        s.synchronize()
    for out in outs:
        for k, one, four in out:
            want = rh.radix_hist_plain(k)
            assert torch.equal(one, want) and torch.equal(four, want)
    dev = keys[0].get_device()
    assert all((dev, s.cuda_stream) in rh._work for s in streams)
    # left zero but for the flag (word 2), which holds the stream's last
    # generation
    for w, _, gen in rh._work.values():
        assert int(w[2]) == gen
        assert int(w[:2].abs().sum()) == int(w[3:].abs().sum()) == 0


def test_device_probe_kernels_match_plain(card):
    x = torch.as_tensor(card.random((512, 128), np.float32), device="cuda")
    assert torch.equal(device_probe.loop_add(x, 100),
                       device_probe.loop_add_plain(x, 100))
    ones = torch.ones((512, 128), device="cuda")
    assert torch.equal(device_probe.loop_add(ones, 4096), ones * 4096)
    for rows in (8, 512, 4096):
        t = _i32(card.integers(0, 100, (rows, 128)))
        i = _i32(card.integers(-rows, 2 * rows, (rows, 128)))
        before = device_probe.row_gather_sum.launches
        got = device_probe.row_gather_sum(t, i, 64)
        assert device_probe.row_gather_sum.launches == before + 1
        assert torch.equal(got, device_probe.row_gather_sum_plain(t, i, 64))
    cap = device_probe.smem_capacity()
    assert cap["max_bytes"] >= 48 * 1024
    assert (cap["refused_bytes"] is None) == (cap["refused_error"] is None)
    # the refusal left no error behind: the next launch goes through
    assert torch.equal(device_probe.loop_add(ones, 2), ones * 2)


@pytest.mark.parametrize("groups,rows", [(1, 1), (1, 8), (3, 16), (140, 32)])
def test_extract_probe_kernels_match_plain(card, groups, rows):
    nc, nwx, nwz = 7, 3, 2
    table = torch.as_tensor(
        card.integers(0, 255, (nc, nwz * 32, nwx * 32)).astype(np.uint8),
        device="cuda")
    tw = extract_probe.tile_windows(table, nwx, nwz)
    shape = (groups, rows, 128)
    # most lanes in window (1, 0), some elsewhere, a few outside the table
    cx = card.integers(32, 64, shape)
    cz = card.integers(0, 32, shape)
    stray = card.random(shape) < 0.1
    cx = np.where(stray, card.integers(-3, nwx * 32 + 3, shape), cx)
    cz = np.where(stray, card.integers(-3, nwz * 32 + 3, shape), cz)
    cx, cz = _i32(cx), _i32(cz)
    for iters in (1, 8, 40):
        got = extract_probe.extract_cur(table, cx, cz, iters)
        assert torch.equal(got, extract_probe.extract_cur_plain(
            table, cx, cz, iters))
        got = extract_probe.extract_win(tw, cx, cz, iters, nwx, nwz)
        want = extract_probe.extract_win_plain(tw, cx, cz, iters, nwx, nwz)
        assert torch.equal(got, want)
        assert int(want.abs().sum()) > 0
    # lanes that stay inside one window read the same voxels both ways
    cx = _i32(card.integers(32, 56, shape))
    cz = _i32(card.integers(32, 64, shape))
    assert torch.equal(extract_probe.extract_cur(table, cx, cz, 8),
                       extract_probe.extract_win(tw, cx, cz, 8, nwx, nwz))


@pytest.mark.parametrize("variant", loop_probe.VARIANTS)
def test_loop_probe_kernel_matches_plain(card, variant):
    body = variant.split("_")[0]
    for groups, rows in ((1, 1), (1, 8), (2, 16), (140, 32)):
        shape = (groups, rows, 128)
        state = (_i32(card.integers(-5, 133, shape)),)
        if body != "issue":
            state += (_i32(card.integers(0, 100, shape)),)
        extras = {"issue": [None],
                  "onehot": [torch.as_tensor(card.integers(
                      0, 255, (nr, 128)).astype(np.uint8), device="cuda")
                      for nr in (64, 8)],
                  "zsel": [torch.zeros((8, 8), dtype=torch.int32,
                                       device="cuda"),
                           _i32(card.integers(0, 255, (8, 8)))]}[body]
        for extra in extras:
            before = loop_probe.loop_probe.launches
            got = loop_probe.loop_probe(variant, state, extra, 37)
            assert loop_probe.loop_probe.launches == before + 1
            want = loop_probe.loop_probe_plain(variant, state, extra, 37)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["one_code", "bank_group", "outside",
                                  "high_bytes"])
@pytest.mark.parametrize("nr", [64, 8])
@pytest.mark.parametrize("variant", ["onehot_smem", "onehot_ldg",
                                     "onehot_const"])
def test_loop_probe_onehot_edges(card, variant, nr, case):
    """The column reads at their edges: every lane on one code (one
    address for the whole warp), codes equal mod 16 (one bank group of a
    single column-major copy), codes outside [0, 128) (an empty one-hot,
    no read), table bytes >= 128 (unsigned sums); one row and 16 rows a
    group, 1 and 5 iterations."""
    for groups, rows in ((1, 1), (3, 16)):
        shape = (groups, rows, 128)
        code = {"one_code": np.full(shape, 77),
                "bank_group": 16 * card.integers(0, 8, shape) + 5,
                "outside": card.choice([-1, -128, 128, 1000, 3], shape),
                "high_bytes": card.integers(0, 128, shape)}[case]
        lo = 128 if case == "high_bytes" else 0
        table = torch.as_tensor(card.integers(lo, 256, (nr, 128)).astype(
            np.uint8), device="cuda")
        state = (_i32(code), _i32(card.integers(0, 100, shape)))
        for iters in (1, 5):
            got = loop_probe.loop_probe(variant, state, table, iters)
            want = loop_probe.loop_probe_plain(variant, state, table, iters)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    if case == "outside":
        # one iteration of codes outside the table adds nothing
        out = loop_probe.loop_probe(variant, state, table, 1)[1]
        off = (state[0] < 0) | (state[0] >= 128)
        assert torch.equal(out[off], state[1][off])


@pytest.mark.parametrize("nc", [1, 7, 8, 16])
def test_extract_probe_edges(card, nc):
    """The unrolled channel loop at nc 1 to 16 and the division-free wrap:
    lanes that start 3 before the table and 2 past its width (some also
    2 past its depth),
    iteration counts 1, 8 and 40 (the window kernel rounds up to 16 and
    40), groups of one row (128 threads) and of 8 and 32 rows."""
    nwx, nwz = 3, 2
    table = torch.as_tensor(
        card.integers(0, 255, (nc, nwz * 32, nwx * 32)).astype(np.uint8),
        device="cuda")
    tw = extract_probe.tile_windows(table, nwx, nwz)
    for groups, rows in ((1, 1), (3, 8), (2, 32)):
        shape = (groups, rows, 128)
        edge = card.random(shape)
        cx = _i32(np.where(edge < 0.2, -3, np.where(
            edge > 0.8, nwx * 32 + 2, card.integers(0, nwx * 32, shape))))
        cz = _i32(np.where(edge > 0.9, nwz * 32 + 2,
                           card.integers(0, nwz * 32, shape)))
        for iters in (1, 8, 40):
            assert torch.equal(
                extract_probe.extract_cur(table, cx, cz, iters),
                extract_probe.extract_cur_plain(table, cx, cz, iters))
            want = extract_probe.extract_win_plain(tw, cx, cz, iters, nwx,
                                                   nwz)
            assert torch.equal(
                extract_probe.extract_win(tw, cx, cz, iters, nwx, nwz), want)
            assert int(want.abs().sum()) > 0


def test_kernels_launch_on_their_tensors_device(scene):
    """K1, K3 and K7 on cuda:1 while cuda:0 is current equal their plain
    versions, and cuda:0 stays current.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda:1")
    reg = BlockRegistry.load("assets")
    arrays = VoxelScene(reg, config1_grid(reg), (0, 0, 0),
                        max_light_prims=256, device=dev).get_arrays()
    rng = np.random.default_rng(4)
    table = torch.as_tensor(rng.integers(0, 100, (512, 128)).astype(
        np.int32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 512, (512, 128)).astype(np.int32),
                          device=dev)
    n = 4099
    atlas = arrays.atlas_packed
    tex = torch.as_tensor(rng.integers(1, atlas.shape[0], n).astype(
        np.int32), device=dev)
    uv = torch.as_tensor(rng.random((2, n), np.float32), device=dev)
    o, d, _ = _rays(32)
    o, d = (V3(*(c.to(dev) for c in v)) for v in (o, d))
    events = auto_events(*arrays.grid.shape)
    torch.cuda.set_device(0)
    got = (device_probe.row_gather_sum(table, idx, 3),
           texel_fetch(atlas, tex, uv[0], uv[1],
                       channels=(0, 1, 2, 3, 4, 5, 6, 8)),
           window_trace(arrays, o, d, events))
    assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], device_probe.row_gather_sum_plain(
        table, idx, 3))
    assert torch.equal(got[1], texel_plain(
        atlas, tex, uv[0], uv[1], channels=(0, 1, 2, 3, 4, 5, 6, 8)))
    want = trace_plain(arrays, o, d, events)
    for g, w in zip(got[2], want):
        assert g.device == dev
        assert int((g != w).sum()) <= 1e-5 * o.x.shape[0]


def test_loop_probe_primitives_match_plain(card):
    a = _i32(card.integers(-40000, 40000, (128, 128)))
    row = torch.arange(128, dtype=torch.int32, device="cuda")[:, None]
    a[:, ::7] = row
    a[:, 1::7] = row + 65536     # equal to the row after narrowing
    a[:, 2::7] = row + 256       # equal as int8 only
    for name in ("i16_cmp", "i8_cmp", "bf16_mul"):
        # the bf16 square has to stay inside int32
        x = a.clamp(-30000, 30000) if name == "bf16_mul" else a
        got = loop_probe.primitive(name, x)
        assert torch.equal(got, loop_probe.primitive_plain(name, x))
        assert int(got.sum()) > 0
    f = torch.as_tensor((card.random((8, 128)) * 1000 - 500).astype(
        np.float32), device="cuda")
    idx = _i32(card.integers(-20, 20, (8, 128)))
    assert torch.equal(loop_probe.primitive("row_pick", f, idx),
                       loop_probe.primitive_plain("row_pick", f, idx))
    assert torch.equal(loop_probe.primitive("lane_roll", f),
                       loop_probe.primitive_plain("lane_roll", f))


# ---- batched frames ----


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "general"])
def test_bf16_frames_on_the_card(cube_scene, fused):
    """shade_bf16 on the card: the frame through the kernels against the
    plain versions' under the golden gate (the fused path launches K2's
    bf16 build once a bounce, the general path K3 and never K2), and
    batched frames with the primary cache equal single frames bit for
    bit."""
    settings = RenderSettings(width=96, height=64, num_bounces=3,
                              compaction=True, trace_audit=True,
                              shade_fused=fused, shade_bf16=True,
                              cache_primary=True)
    prefs = RenderingPreferences(nee_type=1, sort_type=1)
    basis = config1_pose()
    before = (shade_pass.launches, texel_fetch.launches)
    got, aux = Renderer(settings).render(cube_scene, basis, prefs,
                                         frame_count=2, with_aux=True)
    launched = (shade_pass.launches - before[0],
                texel_fetch.launches - before[1])
    assert launched == ((3, 0) if fused is None else (0, 3))
    assert aux["truncated"] == 0 and aux["nee_overflow"] == 0
    want, _ = render_frame(
        cube_scene.get_arrays(), basis.eye, basis.front, basis.right,
        basis.up, 2, settings=settings, nee_type=1, sort_type=1,
        trace=trace_plain, shade=shade_plain, texel=texel_plain)
    golden_gate(got, want)
    single = Renderer(settings)
    singles = torch.stack([single.render(cube_scene, basis, prefs,
                                         frame_count=f, as_numpy=False)
                           for f in range(3)])
    stack = Renderer(settings).render_batch(cube_scene, basis, prefs,
                                            frame_count=0, k=3,
                                            as_numpy=False)
    assert torch.equal(stack, singles)


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "general"])
def test_batch_matches_singles_on_the_card(cube_scene, fused):
    """k batched frames equal k single frames bit for bit, with the
    primary cache and with sort and compaction on; the frame that fills
    the cache launches the tracer on every bounce, a cached frame once
    less; a cached frame equals the uncached frame of its seed."""
    settings = RenderSettings(width=96, height=64, num_bounces=3,
                              compaction=True, trace_audit=True,
                              shade_fused=fused, cache_primary=True)
    prefs = RenderingPreferences(nee_type=1, sort_type=1)
    basis = config1_pose()
    single = Renderer(settings)
    singles = []
    for f in range(3):
        before = window_trace.launches
        singles.append(single.render(cube_scene, basis, prefs, frame_count=f,
                                     as_numpy=False))
        assert window_trace.launches - before == (3 if f == 0 else 2)
    r = Renderer(settings)
    stack, aux = r.render_batch(cube_scene, basis, prefs, frame_count=0, k=3,
                                as_numpy=False, with_aux=True)
    assert torch.equal(stack, torch.stack(singles))
    assert aux["truncated"] == 0 and aux["nee_overflow"] == 0
    mean = r.render_batch(cube_scene, basis, prefs, frame_count=0, k=3,
                          accumulate=True, as_numpy=False)
    assert float((mean - stack.mean(dim=0)).abs().max()) <= 2e-6
    uncached = Renderer(settings.replace(cache_primary=False)).render(
        cube_scene, basis, prefs, frame_count=1, as_numpy=False)
    diff = (singles[1] - uncached).abs()
    assert float(diff.max()) < 1e-3
    assert float(diff.pow(2).mean().sqrt()) < 1e-5


@pytest.fixture
def edited(scene):
    """The golden scene on the card after three edits on live arrays: a
    glass block, a lamp (the light set is built again) and a lamp voxel
    broken; its device grid and aux equal its host ones after each."""
    reg = scene.registry
    s = VoxelScene(reg, config1_grid(reg), (0, 0, 0), max_light_prims=256,
                   device="cuda")
    s.get_arrays()
    for pos, name in (((10, 5, 8), "glass"), ((4, 5, 10), "lamp"),
                      ((8, 7, 8), "air")):
        s.set_block(pos, reg.block_idx(name))
        a = s.get_arrays()
        assert a.grid.is_cuda and a.aux_grid.is_cuda
        np.testing.assert_array_equal(a.grid.cpu().numpy(), s.grid)
        np.testing.assert_array_equal(a.aux_grid.cpu().numpy(), s._aux)
        np.testing.assert_array_equal(
            s._aux, make_aux_grid(s.grid, s._transparent, s._translucent))
    return s


def test_update_grid_keeps_the_device_grid(edited):
    """A window of a larger grid moved three times by update_grid (the
    device roll and the refreshed boxes): the device grid and aux equal
    the host ones and make_aux_grid of the window."""
    reg = edited.registry
    rs = np.random.RandomState(0)
    world = np.full((112, 40, 112), reg.air, np.uint8)
    ids = [reg.block_idx(n) for n in ("stone", "glass")]
    solid = rs.rand(*world.shape) < 0.04
    world[solid] = rs.choice(ids, int(solid.sum()))
    world[50:53, 12:14, 50:53] = reg.block_idx("lamp")

    def window(o):
        return world[o[0]:o[0] + 48, o[1]:o[1] + 24, o[2]:o[2] + 48]

    s = VoxelScene(reg, window((32, 8, 32)), (32, 8, 32),
                   max_light_prims=1024, device="cuda")
    s.get_arrays()
    for o in ((40, 8, 27), (27, 16, 45), (60, 0, 60)):
        s.update_grid(window(o).copy(), o)
        a = s.get_arrays()
        assert a.grid_origin == o
        np.testing.assert_array_equal(a.grid.cpu().numpy(), window(o))
        np.testing.assert_array_equal(a.aux_grid.cpu().numpy(), s._aux)
        np.testing.assert_array_equal(
            s._aux, make_aux_grid(window(o), s._transparent,
                                  s._translucent))


def test_edited_frame_kernels_match_plain(edited):
    """A frame of the edited scene through the tracer and the fused shade
    against the plain versions' under the golden gate."""
    settings = RenderSettings(width=64, height=64, num_bounces=3,
                              compaction=True, trace_audit=True)
    prefs = RenderingPreferences(nee_type=1)
    basis = config1_pose()
    before = (window_trace.launches, shade_pass.launches)
    got, aux = Renderer(settings).render(edited, basis, prefs, frame_count=2,
                                         with_aux=True)
    assert (window_trace.launches, shade_pass.launches) == (
        before[0] + 3, before[1] + 3)
    assert aux["truncated"] == 0 and aux["nee_overflow"] == 0
    want, _ = render_frame(
        edited.get_arrays(), basis.eye, basis.front, basis.right, basis.up,
        2, settings=settings, nee_type=1, sort_type=0, trace=trace_plain,
        shade=shade_plain)
    golden_gate(got, want)


# ---- pixel ranges and the NaN checks ----


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "general"])
def test_distributed_frames_equal_single_on_the_card(cube_scene, fused):
    """DistributedRenderer over 1, 2 and 3 ranges on cuda:0 renders the
    single renderer's frame bit for bit, launching the tracer once a
    bounce for every range; its batches equal its single frames.  (Two
    ranges on one card exercise the ranges, not a second card's device
    guard.)"""
    from wavefront_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh

    settings = RenderSettings(width=96, height=64, num_bounces=3,
                              compaction=True, shade_fused=fused)
    prefs = RenderingPreferences(nee_type=1, sort_type=1)
    basis = config1_pose()
    want = Renderer(settings).render(cube_scene, basis, prefs, frame_count=4)
    assert set(make_mesh()) == {torch.device("cuda", i) for i in
                                range(torch.cuda.device_count())}
    for k in (1, 2, 3):
        dr = DistributedRenderer(settings, make_mesh(devices=["cuda:0"] * k))
        before = window_trace.launches
        got = dr.render(cube_scene, basis, prefs, frame_count=4)
        assert window_trace.launches - before == 3 * k
        np.testing.assert_array_equal(got, want, err_msg=f"{k} ranges")
    stack = dr.render_batch(cube_scene, basis, prefs, frame_count=4, k=2)
    np.testing.assert_array_equal(stack[0], want)
    np.testing.assert_array_equal(
        stack[1], dr.render(cube_scene, basis, prefs, frame_count=5))


def test_nan_checks_on_the_kernels(scene, monkeypatch):
    """Under validation_layer the wrappers check their kernels' outputs:
    a NaN texel fetched by K3 and a NaN radiance carried through K2 raise
    naming the kernel; K1 turns NaN rays into misses (t 3e38, as its
    plain version does), and its check runs and passes."""
    from wavefront_tpu_torch.kernels import _build
    from wavefront_tpu_torch.utils.validation import validation_layer

    arrays = scene.get_arrays()
    o, d, rid = _rays(16)
    n = o.x.shape[0]
    o = V3(torch.where(torch.arange(n, device="cuda") % 5 == 0,
                       float("nan"), o.x).contiguous(), o.y, o.z)
    checked = []
    check = _build.check_outputs
    monkeypatch.setattr(_build, "check_outputs",
                        lambda what, out: (checked.append(what),
                                           check(what, out)))
    with validation_layer():
        pa, pb, t = window_trace(arrays, o, d, 256)
    assert checked == ["window_trace"] and bool(torch.isfinite(t).all())
    atlas = arrays.atlas_packed.clone()
    atlas[3, 4, 5, :] = float("nan")
    tex = torch.full((64,), 3, dtype=torch.int32, device="cuda")
    u = torch.full((64,), 5.5 / atlas.shape[1], device="cuda")
    v = torch.full((64,), 4.5 / atlas.shape[1], device="cuda")
    with pytest.raises(FloatingPointError, match="texel_fetch"):
        with validation_layer():
            texel_fetch(atlas, tex, u, v)
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    pa, pb, t = window_trace(arrays, *_rays(16)[:2], 256)
    o, d, rid = _rays(16)
    ones = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    rad = V3(torch.where(torch.arange(n, device="cuda") == 7, float("nan"),
                         rad.x).contiguous(), rad.y, rad.z)
    with pytest.raises(FloatingPointError, match="shade_pass"):
        with validation_layer():
            shade_pass(tables, arrays.grid_origin, o, d, pa, pb, t, ones, rad,
                       rid, 3, 0, arrays.lights.num_prims, nee_type=1)


def test_device_trace_keeps_the_region_kernels_after_a_large_session(
        tmp_path):
    """Each profiler session of tens of thousands of device events whose
    events are read (`events()`, as `key_averages()` reads them) makes torch.profiler
    drop one more of the first kernel records of every later session in
    the process; `device_trace` opens with empty launches that take that
    loss, so each of the region's launches has its kernel event, and its
    check of the K1-K3 launches against the trace's records (here 20 K3
    launches) finds none lost and does not warn."""
    import json
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from wavefront_tpu_torch.utils.profiling import device_trace

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trace's kernel events")
    x = torch.zeros(1, device="cuda")
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(100000):
                x.add_(1.0)
            torch.cuda.synchronize()
        prof.events()
    y = torch.ones(4096, device="cuda")
    atlas = torch.rand(4, 8, 8, 12, device="cuda")
    tex = torch.arange(256, device="cuda", dtype=torch.int32) % 4
    u = torch.rand(256, device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with device_trace(str(tmp_path)):
            for _ in range(20):
                y.mul_(1.0)
                texel_fetch(atlas, tex, u, u)
    assert [str(w.message) for w in caught
            if "device_trace" in str(w.message)] == []
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    muls = [e for e in kernels if "mul" in e["name"].lower()]
    assert len(muls) == 20
    assert sum("texel_kernel" in e["name"] for e in kernels) == 20


# ---- the bounce sort's key and permute ----


def _key_rays(n, seed=0):
    """n rays on the card for the key: origins in and around a window
    of the streamed shape (world space, at STREAMED_ORIGIN), unit
    directions, a tenth dead (with signed zeros), and a share on the
    quantisers' edges (window and cell edges, axis-aligned and signed-zero
    directions, `angq` and `dyq` bin edges)."""
    rng = np.random.default_rng(seed)
    g = np.asarray(STREAMED_SHAPE, np.float32)
    o = (rng.random((n, 3)) * (g + 40) - 20).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    edge = rng.random(n) < 0.25
    o[edge] = (np.round(o[edge] / 4) * 4).astype(np.float32)
    o[edge] = np.nextafter(o[edge], rng.choice(
        [-np.inf, 0, np.inf], o[edge].shape).astype(np.float32))
    ang = (rng.integers(0, 64, n) / np.float32(10.14)
           - np.float32(3.1416)).astype(np.float32)
    on_bin = rng.random(n) < 0.1
    d[on_bin] = np.stack([np.cos(ang), np.zeros(n, np.float32),
                          np.sin(ang)], 1)[on_bin]
    axis = rng.random(n) < 0.05
    d[axis] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)][axis] * \
        rng.choice([-1.0, 1.0], (n, 1)).astype(np.float32)[axis]
    dead = rng.random(n) < 0.1
    d[dead] = rng.choice([0.0, -0.0], (int(dead.sum()), 3)).astype(
        np.float32)
    o += np.asarray(STREAMED_ORIGIN, np.float32)

    def v3(a):
        return V3(*(torch.as_tensor(np.ascontiguousarray(c), device="cuda")
                    for c in a.T))

    return v3(o), v3(d)


STREAMED_SHAPE = (416, 96, 416)
STREAMED_ORIGIN = (-192, 0, -192)
SORT_NS = [1, 255, 257, 2073600]
KEY_FIELDS = {"dead": (26, 1), "window": (17, 511), "dyq": (14, 7),
              "angq": (8, 63), "cell": (0, 255)}


@pytest.mark.parametrize("n", SORT_NS)
def test_ray_key_kernel_matches_plain(card, n):
    """The key kernel equals its plain version (PyTorch's ops on the
    card) on every ray; a mismatch is reported by key field."""
    o, d = _key_rays(n, seed=n)
    before = ray_key.launches
    got = ray_key(o, d, STREAMED_ORIGIN, STREAMED_SHAPE)
    assert ray_key.launches == before + 1
    want = ray_key_plain(o, d, STREAMED_ORIGIN, STREAMED_SHAPE)
    assert got.dtype == want.dtype == torch.int32
    off = got != want
    fields = {k: int((((got >> s) & m) != ((want >> s) & m))[off].sum())
              for k, (s, m) in KEY_FIELDS.items()}
    assert not bool(off.any()), f"{int(off.sum())} of {n} keys differ: {fields}"


def _sort_state(n, bf16, debug, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ctp = torch.bfloat16 if bf16 else torch.float32

    def v3(dtype=torch.float32):
        return V3(*(torch.randn(n, device="cuda", generator=g).to(dtype)
                    for _ in range(3)))

    rid = torch.randperm(n, device="cuda", generator=g).to(torch.int32)
    return [*v3(), *v3(), *v3(ctp), *v3(), rid] + ([*v3()] if debug else [])


@pytest.mark.parametrize("debug", [False, True], ids=["13", "16"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", SORT_NS)
def test_ray_permute_kernel_matches_plain(card, n, bf16, debug):
    """The permute kernel equals one gather a column, bit for bit, for
    the frame's 13 columns and with the debug rider's 3, tp in float32
    or bfloat16, under a sorted key's permutation."""
    cols = _sort_state(n, bf16, debug, seed=n)
    o, d = _key_rays(n, seed=n + 1)
    key = ray_key(o, d, STREAMED_ORIGIN, STREAMED_SHAPE)
    perm = torch.sort(key, stable=True).indices
    before = ray_permute.launches
    got = ray_permute(perm, cols)
    assert ray_permute.launches == before + 1
    want = ray_permute_plain(perm, cols)
    assert len(got) == len(cols) == (16 if debug else 13)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype
        assert torch.equal(g, w), f"column {k} ({w.dtype}) differs"


def test_ray_sort_wrappers_check_their_inputs(card):
    o, d = _key_rays(64)
    perm = torch.arange(64, device="cuda")
    f = torch.zeros(64, device="cuda")
    for bad_o in (V3(o.x.double(), o.y, o.z), V3(o.x[::2], o.y[::2],
                                                 o.z[::2]),
                  V3(o.x.cpu(), o.y, o.z)):
        with pytest.raises(ValueError):
            ray_key(bad_o, d, STREAMED_ORIGIN, STREAMED_SHAPE)
    for p, cols in ((perm.to(torch.int32), [f]), (perm, [f.double()]),
                    (perm, [torch.zeros(128, device="cuda")[::2]]),
                    (perm, [f.cpu()]), (perm.cpu(), [f]),
                    (perm[::2], [f[::2]]), (perm, [f] * 17)):
        with pytest.raises(ValueError):
            ray_permute(p, cols)


@pytest.fixture(scope="module")
def streamed():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from wavefront_tpu_torch.headline import streamed_setup

    scene, _, settings, basis, prefs = streamed_setup(1920, 1080, 4,
                                                      device="cuda")
    return scene, settings, basis, prefs


def _parent_key(scene, settings, sort_type, o, d):
    """The 64-bit coherence key the renderer sorted on before the int32
    key (the morton key without the presort, as now)."""
    if not settings.trace_presort:
        return bounce_sort_key(scene, settings, sort_type, o, d)
    go = scene.grid_origin
    return coherence_key(o.x - float(go[0]), o.y - float(go[1]),
                         o.z - float(go[2]), d.x, d.y, d.z, *scene.grid.shape)


def _parent_sort(scene, o, d, tp, rad, rid, *riders, key=None):
    """The bounce sort as one gather a column."""
    perm = torch.sort(key, stable=True).indices

    def take(v):
        return v.map(lambda c: c[perm])

    return (take(o), take(d), take(tp), take(rad), rid[perm],
            *(take(v) for v in riders))


def test_ray_sort_on_streamed_bounce_one(streamed):
    """On the streamed window's bounce-1 rays (raygen, sorted, traced by
    K1 and shaded by K2 as the renderer does), the int32 key's kernel
    path gives the 64-bit key's permutation, and the permute moves every
    column as the gathers do."""
    scene, settings, basis, prefs = streamed
    arrays = scene.get_arrays()
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    o, d, tp, rad, rid = _parent_sort(
        arrays, o, d, tp, rad, rid,
        key=_parent_key(arrays, settings, 0, o, d))
    pa, pb, t = window_trace(arrays, o, d, auto_events(*arrays.grid.shape))
    o, d, tp, rad = shade_pass(tables, arrays.grid_origin, o, d, pa, pb, t,
                               tp, rad, rid, 4, 0, arrays.lights.num_prims,
                               nee_type=prefs.nee_type)
    alive = int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())
    assert 0 < alive < n
    key = ray_key(o, d, arrays.grid_origin, arrays.grid.shape)
    assert torch.equal(key, ray_key_plain(o, d, arrays.grid_origin,
                                          arrays.grid.shape))
    perm = torch.sort(key, stable=True).indices
    wide = _parent_key(arrays, settings, 0, o, d)
    assert torch.equal(perm, torch.sort(wide, stable=True).indices)
    got = coherence_sort(arrays, o, d, tp, rad, rid, key=key)
    ref = _parent_sort(arrays, o, d, tp, rad, rid, key=wide)
    for g, r in zip(got, ref):
        for gc, rc in zip(g if isinstance(g, V3) else (g,),
                          r if isinstance(r, V3) else (r,)):
            assert torch.equal(gc, rc)


def test_streamed_frame_equals_the_gathers_frame(streamed, monkeypatch):
    """A streamed 1920x1080x4 frame sorts on every bounce with one key
    and one permute launch a bounce, and equals bit for bit the frame
    whose sort keys on the 64-bit key and gathers each column."""
    from wavefront_tpu_torch.render import renderer as rr
    from wavefront_tpu_torch.utils.profiling import counters

    scene, settings, basis, prefs = streamed
    renderer = Renderer(settings)
    before = counters()
    got = renderer.render(scene, basis, prefs, frame_count=3)
    after = counters()
    b = settings.num_bounces
    assert after["launches.ray_key_kernel"] - before[
        "launches.ray_key_kernel"] == b
    assert after["launches.ray_permute_kernel"] - before[
        "launches.ray_permute_kernel"] == b
    monkeypatch.setattr(rr, "bounce_sort_key", _parent_key)
    monkeypatch.setattr(rr, "coherence_sort", _parent_sort)
    keys, perms = ray_key.launches, ray_permute.launches
    want = Renderer(settings).render(scene, basis, prefs, frame_count=3)
    assert (ray_key.launches, ray_permute.launches) == (keys, perms)
    assert np.array_equal(got, want)


def test_cached_batch_sorts_three_bounces_a_frame(streamed):
    """With the primary cache, bounce 0 skips its sort: a cached frame of
    4 bounces launches the key and the permute 3 times each."""
    scene, settings, basis, prefs = streamed
    renderer = Renderer(settings.replace(cache_primary=True))
    renderer.render(scene, basis, prefs, frame_count=1)     # fills it
    keys, perms = ray_key.launches, ray_permute.launches
    renderer.render_batch(scene, basis, prefs, frame_count=2, k=4,
                          accumulate=True)
    assert ray_key.launches - keys == 3 * 4
    assert ray_permute.launches - perms == 3 * 4
