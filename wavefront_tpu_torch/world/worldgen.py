"""Procedural terrain generation.

Reference: src/game_system/chunk.rs:55-110.  The reference samples OpenSimplex
noise (the Rust `noise` crate) at world-block coordinates / 20, subtracts a
wy/50000 depth gradient, and thresholds at 0.2; a voxel whose column neighbor
above is also solid becomes stone, otherwise grass; every voxel with
|wx|,|wy|,|wz| < 3 is overwritten with a lamp (the hard-coded central light).

A copy of `wavefront_tpu.world.worldgen`, so both packages generate the
same chunks.  The noise function here is an original, fully-vectorized seeded 3-D gradient
(Perlin-style) noise with a quintic fade — same contract as the reference's
OpenSimplex (deterministic in the seed, smooth, zero-mean, ~[-1,1] range),
not a bit-level port.  Terrain shape parity with the Rust crate is not a
goal; the CPU oracle and the device renderer consume the same generator.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from wavefront_tpu_torch.core.config import WorldSettings
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.world.blocks import BlockRegistry


@functools.cache
def _load_native():
    """The native generator `csrc/worldgen.cpp`, built with the host C++
    compiler on the first generated chunk (`kernels/_build.load_host`)
    and typed once.  A missing compiler or a failed build raises.

    The reference runs worldgen on a 15-thread host pool (chunk_manager.rs:
    202-253) — this is the host-side hot path, so a C++ implementation is
    provided, with the NumPy version as its plain version and oracle.
    """
    lib = _build.load_host("worldgen")
    lib.generate_chunk.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint8,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.generate_chunk.restype = None
    return lib


# 12 gradient directions (edge midpoints of a cube), the classic choice.
_GRADS = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float64,
)


class GradientNoise3:
    """Seeded lattice gradient noise over f64 coordinates."""

    def __init__(self, seed: int = 0):
        rs = np.random.RandomState(np.uint32(seed ^ 0x9E3779B9))
        perm = rs.permutation(256).astype(np.int32)
        self._perm = np.concatenate([perm, perm])

    def _grad_index(self, xi, yi, zi):
        p = self._perm
        return p[p[p[xi & 255] + (yi & 255)] + (zi & 255)] % 12

    def sample(self, x, y, z):
        """Noise at (x, y, z); inputs broadcastable float64 arrays."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        z = np.asarray(z, np.float64)
        xi = np.floor(x).astype(np.int64)
        yi = np.floor(y).astype(np.int64)
        zi = np.floor(z).astype(np.int64)
        xf, yf, zf = x - xi, y - yi, z - zi

        def fade(t):
            return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

        u, v, w = fade(xf), fade(yf), fade(zf)

        def dotgrad(dx, dy, dz):
            gi = self._grad_index(
                (xi + dx).astype(np.int32),
                (yi + dy).astype(np.int32),
                (zi + dz).astype(np.int32),
            )
            g = _GRADS[gi]
            return (
                g[..., 0] * (xf - dx) + g[..., 1] * (yf - dy) + g[..., 2] * (zf - dz)
            )

        def lerp(a, b, t):
            return a + t * (b - a)

        c000 = dotgrad(0, 0, 0)
        c100 = dotgrad(1, 0, 0)
        c010 = dotgrad(0, 1, 0)
        c110 = dotgrad(1, 1, 0)
        c001 = dotgrad(0, 0, 1)
        c101 = dotgrad(1, 0, 1)
        c011 = dotgrad(0, 1, 1)
        c111 = dotgrad(1, 1, 1)

        x00 = lerp(c000, c100, u)
        x10 = lerp(c010, c110, u)
        x01 = lerp(c001, c101, u)
        x11 = lerp(c011, c111, u)
        y0 = lerp(x00, x10, v)
        y1 = lerp(x01, x11, v)
        return lerp(y0, y1, w)


class WorldGenerator:
    """Chunk-granularity terrain generator (reference chunk.rs:55-110)."""

    def __init__(self, settings: WorldSettings, registry: BlockRegistry):
        self.settings = settings
        self.registry = registry
        self.noise = GradientNoise3(settings.worldgen_seed)
        self._air = registry.air
        self._grass = registry.block_idx("grass")
        self._stone = registry.block_idx("stone")
        self._lamp = registry.block_idx("lamp")

    def generate_chunk(self, chunk_pos) -> np.ndarray:
        """Generate one chunk at integer chunk coordinates.

        Returns (S, S, S) uint8 block ids indexed [x, y, z], from the C++
        generator (`native_chunk`); `_generate_chunk_numpy` is its plain
        version, and both produce identical chunks, as do the JAX
        package's (tests/test_torch_mesher.py)."""
        return native_chunk(self.settings, self.noise._perm[:256], chunk_pos,
                            (self._air, self._grass, self._stone, self._lamp))

    def _generate_chunk_numpy(self, chunk_pos) -> np.ndarray:
        s = self.settings
        cs = s.chunk_size
        ox, oy, oz = (int(c) * cs for c in chunk_pos)

        wx = np.arange(ox, ox + cs, dtype=np.float64)[:, None, None]
        wy = np.arange(oy, oy + cs, dtype=np.float64)[None, :, None]
        wz = np.arange(oz, oz + cs, dtype=np.float64)[None, None, :]

        # density here and one block above (reference chunk.rs:79-85)
        def density(yy):
            return (
                self.noise.sample(wx / s.noise_scale, yy / s.noise_scale, wz / s.noise_scale)
                - yy / s.depth_gradient
            )

        val_here = density(wy)
        val_above = density(wy + 1.0)

        solid_here = val_here > s.noise_threshold
        solid_above = val_above > s.noise_threshold

        blocks = np.full((cs, cs, cs), self._air, dtype=np.uint8)
        blocks[solid_here & solid_above] = self._stone
        blocks[solid_here & ~solid_above] = self._grass

        if s.central_lamp:
            # |wx|,|wy|,|wz| < 3 -> lamp (reference chunk.rs:102-104)
            inx = (wx > -3.0) & (wx < 3.0)
            iny = (wy > -3.0) & (wy < 3.0)
            inz = (wz > -3.0) & (wz < 3.0)
            blocks[np.broadcast_to(inx & iny & inz, blocks.shape)] = self._lamp

        return blocks


def native_chunk(settings: WorldSettings, perm256, chunk_pos,
                 ids) -> np.ndarray:
    """One chunk from the C++ generator (`csrc/worldgen.cpp`, the port's
    copy of the JAX package's `native/worldgen.cpp`): `perm256` the
    noise's permutation, `ids` the (air, grass, stone, lamp) block ids.
    Counts its calls in `native_chunk.launches`, as a kernel's wrapper
    counts its launches."""
    s = settings
    cs = s.chunk_size
    out = np.empty(cs * cs * cs, np.uint8)
    perm = np.ascontiguousarray(perm256, np.int32)
    _load_native().generate_chunk(
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cs,
        int(chunk_pos[0]), int(chunk_pos[1]), int(chunk_pos[2]),
        float(s.noise_scale), float(s.noise_threshold),
        float(s.depth_gradient),
        *(int(i) for i in ids),
        1 if s.central_lamp else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    native_chunk.launches += 1
    return out.reshape(cs, cs, cs)


native_chunk.launches = 0
