"""The bounce sort's key and permute (`kernels/ray_sort.py`): their plain
versions, which the CUDA kernels are held to on the card
(tests/test_torch_cuda.py), against the 64-bit coherence key and the JAX
package's key, and the renderer's sort built on them.

The int32 key is the 64-bit key shifted right by 5, exactly, on rays
placed where the key's quantisers change: 32-voxel window edges and
4-voxel cell edges with the floats either side, the grid's faces, outside
and negative origins, axis-aligned and signed-zero directions, and
directions at the edges of the `dyq` and `angq` bins.  Against the JAX
key it is exact wherever the two `atan2`s return the same float; where
PyTorch's vectorised CPU `atan2` rounds an ulp apart from XLA's, the keys
may differ in the `angq` field alone, by one bin.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.kernels.window_trace import (
    _coherence_key as jax_coherence_key,
)
from wavefront_tpu_torch.core.config import RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.ray_sort import (
    KEY_SHIFT,
    ray_key,
    ray_key_plain,
    ray_permute,
    ray_permute_plain,
)
from wavefront_tpu_torch.kernels.window_trace import coherence_key
from wavefront_tpu_torch.render import renderer as rr

F32 = np.float32
SHAPES = [(160, 32, 160), (416, 96, 416), (48, 70, 40)]
GRID_ORIGIN = (-208, 0, 16)
ANGQ = (13, 63)          # the 64-bit key's angle field: shift, mask


def _both_sides(v):
    v = np.asarray(v, F32)
    return np.concatenate([v, np.nextafter(v, F32(np.inf)),
                           np.nextafter(v, F32(-np.inf))])


def adversarial_rays(shape, m=6144, seed=7):
    """(m, 3) grid-local origins and (m, 3) directions drawn from the
    quantisers' edges (module note)."""
    rng = np.random.default_rng(seed)
    axes = []
    for g in shape:
        axes.append(_both_sides(np.concatenate([
            np.arange(0, g + 1, 32), np.arange(0, 40, 4),
            [g, g + 5, -3.0, -0.0, 1e30, -1e30]])))
    o = np.stack([rng.choice(a, m) for a in axes], 1)
    # (ang + 3.1416) * 10.14 and (dy + 1) * 3.99 at each bin's edge
    ang = _both_sides(np.arange(64) / F32(10.14) - F32(3.1416))
    dyk = _both_sides(np.arange(8) / F32(3.99) - F32(1.0))
    z, nz = F32(0.0), F32(-0.0)
    signed = [(a, b, c) for a in (z, nz) for b in (z, nz, 1, -1)
              for c in (z, nz)]
    axis = [(s * (k == 0), s * (k == 1), s * (k == 2))
            for k in range(3) for s in (1, -1)]
    dirs = np.concatenate([
        np.stack([np.cos(ang), np.zeros_like(ang), np.sin(ang)], 1),
        np.stack([np.full_like(dyk, 0.3), dyk, np.full_like(dyk, 0.2)], 1),
        np.asarray(signed + axis, F32)]).astype(F32)
    d = dirs[rng.integers(0, len(dirs), m)]
    return o.astype(F32), d


def _v3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(c)) for c in a.T))


def _world(o):
    return (o + np.asarray(GRID_ORIGIN, F32)).astype(F32)


@pytest.mark.parametrize("shape", SHAPES)
def test_key_is_the_coherence_key_shifted(shape):
    o, d = adversarial_rays(shape)
    key = ray_key(_v3(_world(o)), _v3(d), GRID_ORIGIN, shape)
    # the origin shift as the renderer made it for the 64-bit key
    local = _world(o) - np.asarray(GRID_ORIGIN, F32)
    want = coherence_key(*_v3(local), *_v3(d), *shape)
    assert key.dtype == torch.int32
    assert int(key.min()) >= 0 and int(key.max()) < 2 ** 27
    assert not bool((want & ((1 << KEY_SHIFT) - 1)).any())
    assert torch.equal(key.to(torch.int64) << KEY_SHIFT, want)
    dead = (d == 0).all(1)
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(key.numpy() >> 26, dead)


@pytest.mark.parametrize("shape", SHAPES)
def test_key_matches_jax(shape):
    o, d = adversarial_rays(shape)
    key = ray_key(_v3(_world(o)), _v3(d), GRID_ORIGIN, shape).numpy()
    local = _world(o) - np.asarray(GRID_ORIGIN, F32)
    pack = types.SimpleNamespace(
        nwx=-(-shape[0] // 32), nky=-(-shape[1] // 32), nwz=-(-shape[2] // 32))
    want = np.asarray(jax_coherence_key(
        pack, *(jnp.asarray(np.ascontiguousarray(c))
                for c in (*local.T, *d.T)))) >> KEY_SHIFT
    got = key.astype(np.uint32)
    # the two atan2s, on the same contiguous components the keys read
    dz, dx = (np.ascontiguousarray(d[:, k]) for k in (2, 0))
    same = (torch.atan2(torch.as_tensor(dz), torch.as_tensor(dx)).numpy()
            .view(np.int32) == np.asarray(jnp.arctan2(dz, dx)).view(np.int32))
    np.testing.assert_array_equal(got[same], want[same])
    shift, mask = ANGQ[0] - KEY_SHIFT, ANGQ[1]
    rest = ~np.uint32(mask << shift)
    np.testing.assert_array_equal(got[~same] & rest, want[~same] & rest)
    step = (got[~same] >> shift & mask).astype(np.int64) - (
        want[~same] >> shift & mask)
    assert np.all(np.abs(step) <= 1)


def _tied_keys(seed):
    """64-bit coherence keys with many ties: adversarial rays repeated."""
    o, d = adversarial_rays(SHAPES[0], m=2048, seed=seed)
    idx = np.random.default_rng(seed).integers(0, 64, 8192)
    return _v3(_world(o[idx])), _v3(d[idx])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_int32_key_sorts_as_the_int64_key(seed):
    o, d = _tied_keys(seed)
    key = ray_key(o, d, GRID_ORIGIN, SHAPES[0])
    wide = key.to(torch.int64) << KEY_SHIFT
    assert torch.unique(key).numel() < key.numel() // 16
    p32 = torch.sort(key, stable=True).indices
    p64 = torch.sort(wide, stable=True).indices
    assert torch.equal(p32, p64)


def _state(n, bf16, seed=0):
    g = torch.Generator().manual_seed(seed)
    ctp = torch.bfloat16 if bf16 else torch.float32

    def v3(dtype=torch.float32):
        return V3(*(torch.randn(n, generator=g).to(dtype) for _ in range(3)))

    return (v3(), v3(), v3(ctp), v3(),
            torch.randperm(n, generator=g).to(torch.int32), v3())


@pytest.mark.parametrize("riders", [0, 1], ids=["plain", "debug_rider"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_permute_matches_gathers(bf16, riders):
    """`ray_permute` and `coherence_sort` equal one gather a column, dtypes
    kept: float32 o, d and rad, tp in float32 or bfloat16, int32 rid and
    the float32 debug rider."""
    n = 4099
    o, d, tp, rad, rid, dbg = _state(n, bf16)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    cols = [*o, *d, *tp, *rad, rid] + ([*dbg] if riders else [])
    got = ray_permute(perm, cols)
    assert len(got) == len(cols)
    for g, c in zip(got, cols):
        assert g.dtype == c.dtype
        assert torch.equal(g, c[perm])
    assert all(torch.equal(a, b)
               for a, b in zip(got, ray_permute_plain(perm, cols)))
    key = torch.as_tensor(np.random.default_rng(3).integers(
        0, 50, n).astype(np.int32))
    p = torch.sort(key, stable=True).indices
    scene = types.SimpleNamespace()
    out = rr.coherence_sort(scene, o, d, tp, rad, rid,
                            *([dbg] if riders else []), key=key)
    want = (o, d, tp, rad, rid, *([dbg] if riders else []))
    assert len(out) == len(want)
    for g, w in zip(out, want):
        for gc, wc in zip(g if isinstance(g, V3) else (g,),
                          w if isinstance(w, V3) else (w,)):
            assert gc.dtype == wc.dtype
            assert torch.equal(gc, wc[p])


def test_permute_checks_its_inputs():
    n = 16
    perm = torch.randperm(n)
    f = torch.zeros(n)
    bad = [
        (perm.to(torch.int32), [f]),                 # perm dtype
        (perm, []),                                  # no column
        (perm, [f] * 17),                            # too many columns
        (perm, [f.to(torch.float64)]),               # 8-byte column
        (perm, [f.to(torch.uint8)]),                 # 1-byte column
        (perm, [f.to(torch.float16)]),               # not a ray column
        (perm, [torch.zeros(n + 1)]),                # length
        (perm, [torch.zeros(2 * n)[::2]]),           # not contiguous
        (perm, [torch.zeros(n, device="meta")]),     # another device
    ]
    for p, cols in bad:
        with pytest.raises(ValueError):
            ray_permute(p, cols)


def test_key_checks_its_inputs():
    n = 16
    f = torch.zeros(n)
    good = [f] * 3
    for o in ([f, f, f.to(torch.float64)], [f, f, torch.zeros(n + 1)],
              [f, f, torch.zeros(2 * n)[::2]],
              [f, f, torch.zeros(n, device="meta")]):
        with pytest.raises(ValueError):
            ray_key(V3(*o), V3(*good), GRID_ORIGIN, SHAPES[0])


def test_default_sort_key_is_the_int32_key():
    """`bounce_sort_key` hands the sort the int32 key on the default path
    and the int64 morton key without the presort; `coherence_sort` with no
    key sorts as with the int32 key."""
    o, d = _tied_keys(4)
    scene = types.SimpleNamespace(grid=torch.zeros(SHAPES[0], dtype=torch.uint8),
                                  grid_origin=GRID_ORIGIN)
    key = rr.bounce_sort_key(scene, RenderSettings(), 0, o, d)
    assert torch.equal(key, ray_key_plain(o, d, GRID_ORIGIN, SHAPES[0]))
    off = rr.bounce_sort_key(scene, RenderSettings(trace_presort=False), 1,
                             o, d)
    assert off.dtype == torch.int64
    n = o.x.shape[0]
    tp, rad = V3(*(torch.ones(n),) * 3), V3(*(torch.zeros(n),) * 3)
    rid = torch.arange(n, dtype=torch.int32)
    p = torch.sort(key, stable=True).indices
    out = rr.coherence_sort(scene, o, d, tp, rad, rid)
    assert torch.equal(out[4], rid[p])
    assert torch.equal(out[0].x, o.x[p]) and torch.equal(out[1].z, d.z[p])
