"""The port's host-side world modules against the JAX package's: the
mesher (`world/mesher.py`, tests/test_mesher.py), the scalar NumPy
oracle renderer (`render/oracle.py`) and the native chunk generator
(`csrc/worldgen.cpp` through `world/worldgen.py`, tests/test_native.py).

All three are host numpy (or C++) in both packages, so each output is
held exactly: the mesher's faces, triangles and hitboxes on the cases of
tests/test_mesher.py and on a worldgen chunk, the oracle's 8x8 images
with 2 bounces, and the native generator's chunks against the NumPy
version and the JAX package's generator.
"""

import numpy as np
import pytest

import wavefront_tpu.render.lights as jax_lights
import wavefront_tpu.world.mesher as jax_mesher
import wavefront_tpu.world.worldgen as jax_worldgen
import wavefront_tpu_torch.render.lights as port_lights
import wavefront_tpu_torch.world.mesher as port_mesher
import wavefront_tpu_torch.world.worldgen as port_worldgen
from wavefront_tpu.core.camera import SphericalCamera as JaxCamera
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.core.config import WorldSettings as JaxWorld
from wavefront_tpu.render.oracle import OracleRenderer as JaxOracle
from wavefront_tpu.world.blocks import BlockRegistry as JaxRegistry
from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import RenderSettings, WorldSettings
from wavefront_tpu_torch.render.oracle import OracleRenderer
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"


@pytest.fixture(scope="module")
def regs():
    return BlockRegistry.load(ASSETS), JaxRegistry.load(ASSETS)


def mesher_cases(reg):
    """The grids of tests/test_mesher.py, a random 8^3 one and a worldgen
    chunk."""
    air, stone = reg.air, reg.block_idx("stone")
    one = np.full((4, 4, 4), air, np.uint8)
    one[1, 1, 1] = stone
    full = np.full((4, 4, 4), stone, np.uint8)
    glass = np.full((3, 1, 1), air, np.uint8)
    glass[0], glass[1] = stone, reg.block_idx("glass")
    rs = np.random.RandomState(3)
    rand = np.full((8, 8, 8), air, np.uint8)
    rand[rs.rand(8, 8, 8) < 0.1] = stone
    chunk = port_worldgen.WorldGenerator(
        WorldSettings(chunk_size=16), reg).generate_chunk((0, 0, 0))
    return {"one": one, "full": full, "glass": glass, "random": rand,
            "chunk": chunk}


def test_mesher_matches_jax(regs):
    reg, jreg = regs
    for name, grid in mesher_cases(reg).items():
        for got, want in zip(port_mesher.visible_faces(grid, reg),
                             jax_mesher.visible_faces(grid, jreg)):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        for got, want in zip(port_mesher.gen_mesh(grid, reg, origin=(1, 2, 3)),
                             jax_mesher.gen_mesh(grid, jreg, origin=(1, 2, 3))):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        got = port_mesher.gen_hitbox(grid, reg)
        want = jax_mesher.gen_hitbox(grid, jreg)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_mesher_neighbors_and_cases(regs):
    """Cross-chunk culling against neighbour grids equals the JAX
    mesher's, and the port keeps tests/test_mesher.py's assertions."""
    reg, jreg = regs
    cases = mesher_cases(reg)
    grid = cases["random"]
    nbrs = {f: np.roll(cases["random"], f + 1, axis=f // 2) for f in range(6)}
    for got, want in zip(port_mesher.visible_faces(grid, reg, nbrs),
                         jax_mesher.visible_faces(grid, jreg, nbrs)):
        np.testing.assert_array_equal(got, want)
    _, faces, _ = port_mesher.visible_faces(cases["one"], reg)
    assert sorted(faces.tolist()) == [0, 1, 2, 3, 4, 5]
    assert len(port_mesher.visible_faces(cases["full"], reg)[1]) == 6 * 16
    _, _, blocks = port_mesher.visible_faces(cases["glass"], reg)
    assert (blocks == reg.block_idx("stone")).sum() == 6
    verts, _, _ = port_mesher.gen_mesh(cases["one"], reg)
    normals = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    outward = verts.mean(axis=1) - 1.5
    assert np.all((normals * outward).sum(-1) > 0)
    assert port_mesher.gen_hitbox(np.full((2, 2, 2), reg.air, np.uint8),
                                  reg) is None


def oracle_grid(reg):
    """tests/test_golden.py's 16^3 scene: slab, lamp, mirror, glass."""
    grid = np.full((16, 16, 16), reg.air, np.uint8)
    grid[:, :4, :] = reg.block_idx("stone")
    grid[:, 4, :] = reg.block_idx("grass")
    grid[6:9, 5:8, 6:9] = reg.block_idx("lamp")
    grid[2, 5:7, 3] = reg.block_idx("mirror")
    grid[12, 5:7, 12] = reg.block_idx("glass")
    return grid


def pose(camera_cls):
    cam = camera_cls()
    cam.set_root_position([8.0, 8.0, 8.0])
    cam.offset = 14.0
    cam.yaw = 0.7
    cam.pitch = -0.45
    return cam.eye_front_right_up()


@pytest.mark.parametrize("nee_type,entity", [(0, False), (1, True),
                                             (2, False)])
def test_oracle_matches_jax(regs, nee_type, entity):
    """The port's oracle renders the JAX oracle's 8x8 image exactly, with
    its own light set (equal to the JAX one) and, once, a cube entity."""
    reg, jreg = regs
    grid = oracle_grid(reg)
    tris = {}
    if entity:
        verts, uv, tex = meshes.unitcube()
        tris = dict(tri_verts=verts + np.array([8.0, 6.5, 8.0], np.float32),
                    tri_uv=uv, tri_tex=tex)
    ls = port_lights.build_from_grid(grid, np.zeros(3), reg, 256)
    jls = jax_lights.build_from_grid(grid, np.zeros(3), jreg, 256)
    for field in ("p0", "e1", "e2", "power", "node_left", "node_right",
                  "node_parent", "leaf_node"):
        np.testing.assert_array_equal(getattr(ls, field), getattr(jls, field))
    kw = dict(width=8, height=8, num_bounces=2, max_trace_steps=96)
    b, jb = pose(SphericalCamera), pose(JaxCamera)
    got = OracleRenderer(RenderSettings(**kw), reg, grid, (0, 0, 0), ls,
                         **tris).render(b.eye, b.front, b.right, b.up,
                                        frame_count=3, nee_type=nee_type)
    want = JaxOracle(JaxSettings(**kw), jreg, grid, (0, 0, 0), jls,
                     **tris).render(jb.eye, jb.front, jb.right, jb.up,
                                    frame_count=3, nee_type=nee_type)
    assert got.shape == (8, 8, 3) and got.mean() > 1e-3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [(0, 0, 0), (1, -1, 2), (-3, 0, 5),
                                   (2, 1, -2)])
def test_native_worldgen_matches_numpy_and_jax(regs, chunk):
    """The native generator (built from csrc/worldgen.cpp with the host
    compiler) makes the NumPy version's chunk and the JAX package's."""
    reg, jreg = regs
    before = port_worldgen.native_chunk.launches
    for cs in (16, 32):
        gen = port_worldgen.WorldGenerator(WorldSettings(chunk_size=cs), reg)
        got = gen.generate_chunk(chunk)
        assert got.dtype == np.uint8 and got.shape == (cs, cs, cs)
        np.testing.assert_array_equal(got, gen._generate_chunk_numpy(chunk))
        jgen = jax_worldgen.WorldGenerator(JaxWorld(chunk_size=cs), jreg)
        np.testing.assert_array_equal(got, jgen.generate_chunk(chunk))
    assert port_worldgen.native_chunk.launches == before + 2
