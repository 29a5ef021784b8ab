"""The golden scene on the card, taken apart: program arms, tracer
fields, the primary cache, and the card against the CPU.

Counterpart of `tools/parity_probe.py`, with its subcommands on the
config-1 golden scene (`gpu_parity.golden_scene`).  Where the JAX tool
spawns a process for each platform, one process computes both here: the
"card" side runs on `--device`, the "cpu" side on CPU tensors, where
every kernel's wrapper runs its plain version.

  arms     the fused shade (K2), the general shade with the texel kernel
           (K3), and the general shade with the gather
           (shade_texel_kernel=False): each against the stored golden and
           against each other
  trace    K1 against the plain march (`trace_plain`, 512 steps), field
           by field on the primary fan: hit, face, owner, entered, the
           voxel on lanes where both hit, and the largest t difference
           there
  cache    cache_primary frames 0 and 1 against uncached frames
  split    the same program on the card and on the CPU, nee_type 1 and 0
           (and nee 1 on each against the golden)
  nee      the dense NEE pick and pdf intermediates (node and prim
           importance, prim probabilities, the sample), and the fused
           shade of rays onto the same points, card against CPU on
           identical inputs
  scatter  bounce 0 of the golden frame, traced and shaded by K1 and K2,
           and the next bounce's trace fields, card against CPU

An image row is the JAX tool's `_cmp`: pixels whose max-channel |diff|
reaches 1e-3 * max(1, |b|) (`divergent`), max |diff| and max relative
diff; `split` adds the golden gate of `gpu_parity.compare`.  A field row
counts mismatching elements.  The vs-golden rows run only at the
golden's own size.

    python -m wavefront_tpu_torch.tools.parity_probe \
        [arms|trace|cache|split|nee|scatter] [--width 256 --height 256] \
        [--device cuda]

One JSON line a row, with the card's name and power limit.  Without a
card it exits unless given `--device cpu`, which then compares the CPU
with itself.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.core.config import EPSILON_BLOCK
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.shade import prep_shade_tables, shade_pass
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.render.intersect import trace_plain, unpack_hits
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.wavefront import (
    dense_node_importance,
    dense_prim_importance,
    dense_prim_probs,
    dense_sample_light,
    raygen_soa,
)
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit
from wavefront_tpu_torch.tools.gpu_parity import (
    REFERENCE_STEPS,
    compare,
    golden_scene,
)

CMDS = ("arms", "trace", "cache", "split", "nee", "scatter")
# the tracer's budget on the primary fan (the JAX tool's max_events)
TRACE_EVENTS = 384
CPU = torch.device("cpu")


def _cmp(tag: str, a, b) -> dict:
    """The JAX tool's `_cmp` row of images a against b."""
    a, b = np.asarray(a), np.asarray(b)
    diff = np.abs(a - b).max(axis=-1)
    # relative for bright pixels (HDR radiance; see gpu_parity.compare)
    scale = np.maximum(1.0, np.abs(b).max(axis=-1))
    return {"check": tag,
            "divergent": int((diff >= 1e-3 * scale).sum()),
            "max_abs": float(diff.max()),
            "max_rel": float((diff / scale).max())}


def _fields(tag: str, a: dict, b: dict) -> list:
    """A row per field: elements of a[k] that differ from b[k], and the
    largest |diff| of a float field that differs."""
    rows = []
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        neq = x != y
        rec = {"check": tag, "field": k, "mismatch": int(neq.sum()),
               "of": int(x.numel())}
        if neq.any() and x.is_floating_point():
            rec["max_abs"] = float((x.double() - y.double()).abs().max())
        rows.append(rec)
    return rows


def _golden_size(settings, gold) -> bool:
    return gold.shape[:2] == (settings.height, settings.width)


def arms(dev, width=None, height=None) -> list:
    scene, settings, basis, prefs, gold, frame = golden_scene(dev, width,
                                                              height)

    def render(**kw):
        return Renderer(settings.replace(**kw), device=dev).render(
            scene, basis, prefs, frame_count=frame)

    imgs = {"fused": render(shade_fused=True),
            "general+texel": render(shade_fused=False,
                                    shade_texel_kernel=True),
            "general+gather": render(shade_fused=False,
                                     shade_texel_kernel=False)}
    rows = []
    if _golden_size(settings, gold):
        rows += [_cmp(f"{k} vs_golden", v, gold) for k, v in imgs.items()]
    rows.append(_cmp("general+texel vs general+gather",
                     imgs["general+texel"], imgs["general+gather"]))
    rows.append(_cmp("fused vs general+texel", imgs["fused"],
                     imgs["general+texel"]))
    return rows


def _primary(scene, settings, basis, dev):
    return raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                      settings.width, settings.height, device=dev)[:2]


def trace(dev, width=None, height=None) -> list:
    scene, settings, basis = golden_scene(dev, width, height)[:3]
    arrays = scene.get_arrays()
    o, d = _primary(scene, settings, basis, dev)
    k1 = unpack_hits(*window_trace(arrays, o, d, TRACE_EVENTS))
    plain = unpack_hits(*trace_plain(arrays, o, d, REFERENCE_STEPS))
    out = {"check": "trace"}
    for f in ("hit", "face", "owner", "entered"):
        out[f] = int((getattr(k1, f) != getattr(plain, f)).sum())
    # a voxel means something only where both hit (a miss lane holds the
    # -2 sentinel, which no consumer reads)
    both = k1.hit & plain.hit
    for f in ("vx", "vy", "vz"):
        out[f + "_hitlanes"] = int(
            ((getattr(k1, f) != getattr(plain, f)) & both).sum())
    out["t_maxdiff_bothhit"] = float(
        (k1.t - plain.t).abs()[both].max()) if bool(both.any()) else 0.0
    out["n"] = int(o.x.shape[0])
    return [out]


def cache(dev, width=None, height=None) -> list:
    scene, settings, basis, prefs = golden_scene(dev, width, height)[:4]
    base = Renderer(settings, device=dev)
    plain = [base.render(scene, basis, prefs, frame_count=f) for f in (0, 1)]
    rc = Renderer(settings.replace(cache_primary=True), device=dev)
    cached = [rc.render(scene, basis, prefs, frame_count=f) for f in (0, 1)]
    return [_cmp("cache frame0 vs plain frame0", cached[0], plain[0]),
            _cmp("cache frame1(cached) vs plain frame1", cached[1],
                 plain[1])]


def split(dev, width=None, height=None) -> list:
    rows = []
    for nee in (1, 0):
        img = {}
        for side in (dev, CPU):
            scene, settings, basis, prefs, gold, _ = golden_scene(
                side, width, height)
            img[side.type] = Renderer(settings, device=side).render(
                scene, basis, prefs.replace(nee_type=nee), frame_count=0)
        if nee == 1 and _golden_size(settings, gold):
            rows.append(_cmp("nee1 cpu vs golden", img["cpu"], gold))
            rows.append(_cmp(f"nee1 {dev.type} vs golden", img[dev.type],
                             gold))
        rows.append({**_cmp(f"nee{nee} {dev.type} vs cpu", img[dev.type],
                            img["cpu"]),
                     "golden_gate": compare(img[dev.type], img["cpu"])})
    return rows


def _grass_points(dev, n_side: int = 96):
    """The JAX tool's NEE inputs: a 96 x 96 lattice of grass-top points
    (y = 5 exactly), normals up, seeds i * 2654435761."""
    xs, zs = np.meshgrid(np.linspace(0.25, 15.75, n_side, dtype=np.float32),
                         np.linspace(0.25, 15.75, n_side, dtype=np.float32))
    n = n_side * n_side

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    point = V3(col(xs.ravel()), col(np.full(n, 5.0)), col(zs.ravel()))
    normal = V3(col(np.zeros(n)), col(np.ones(n)), col(np.zeros(n)))
    seed = (torch.arange(n, dtype=torch.int64, device=dev) * 2654435761
            ) & 0xFFFFFFFF
    return point, normal, seed


def _nee_dump(dev, width=None, height=None) -> dict:
    """Every intermediate of the dense NEE pick on the grass-top points,
    and the fused shade (K2 on the card) of rays that fall straight onto
    them, on `dev`."""
    scene = golden_scene(dev, width, height)[0]
    arrays = scene.get_arrays()
    lights = arrays.lights
    point, normal, seed = _grass_points(dev)
    active = torch.ones(point.x.shape[0], dtype=torch.bool, device=dev)
    samp, _ = dense_sample_light(lights, point, normal, seed, active)
    out = {"nimp": dense_node_importance(lights, point, normal,
                                         EPSILON_BLOCK),
           "pimp": dense_prim_importance(lights, point, normal,
                                         EPSILON_BLOCK),
           "probs": dense_prim_probs(lights, point, normal),
           "prim": samp.prim, "prob": samp.probability,
           "importance": samp.importance, "success": samp.success}
    # rays from one voxel above each point, straight down: traced on the
    # CPU so both sides shade identical hit words
    n = point.x.shape[0]
    o = V3(point.x, point.y + 1.0, point.z)
    d = V3(torch.zeros_like(point.x), -torch.ones_like(point.x),
           torch.zeros_like(point.x))
    cpu_arrays = golden_scene(CPU, width, height)[0].get_arrays()
    hits = trace_plain(cpu_arrays, o.map(lambda c: c.cpu()),
                       d.map(lambda c: c.cpu()), REFERENCE_STEPS)
    pa, pb, t = (x.to(dev) for x in hits)
    ones = V3(*(torch.ones(n, device=dev) for _ in range(3)))
    zeros = V3(*(torch.zeros(n, device=dev) for _ in range(3)))
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    tables = prep_shade_tables(arrays.atlas_packed, lights)
    no, nd, ntp, nrad = shade_pass(tables, arrays.grid_origin, o, d, pa, pb,
                                   t, ones, zeros, rid, 0, 0,
                                   lights.num_prims, nee_type=1)
    for k, v in (("shade_o", no), ("shade_d", nd), ("shade_tp", ntp),
                 ("shade_rad", nrad)):
        for c, x in zip("xyz", v):
            out[f"{k}{c}"] = x
    return out


def nee(dev, width=None, height=None) -> list:
    return _fields("nee", _nee_dump(dev, width, height),
                   _nee_dump(CPU, width, height))


def _scatter_dump(dev, width=None, height=None) -> dict:
    """Bounce 0 of the golden frame on `dev` (pixel order, no sort):
    K1's hit fields, K2's scattered rays, throughput and radiance, and
    K1's hit fields of the scattered rays."""
    scene, settings, basis, prefs, _, frame = golden_scene(dev, width,
                                                           height)
    arrays = scene.get_arrays()
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           settings.width, settings.height, device=dev)
    n = o.x.shape[0]
    pa, pb, t = window_trace(arrays, o, d, TRACE_EVENTS)
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    ones = V3(*(torch.ones(n, device=dev) for _ in range(3)))
    zeros = V3(*(torch.zeros(n, device=dev) for _ in range(3)))
    inv_seed = frame * settings.num_bounces
    no, nd, ntp, nrad = shade_pass(tables, arrays.grid_origin, o, d, pa, pb,
                                   t, ones, zeros, rid, inv_seed, 0,
                                   arrays.lights.num_prims,
                                   nee_type=prefs.nee_type)
    h1 = unpack_hits(pa, pb, t)
    h2 = unpack_hits(*window_trace(arrays, no, nd, TRACE_EVENTS))
    out = {}
    for k, v in (("no", no), ("nd", nd), ("tp", ntp), ("rad", nrad)):
        for c, x in zip("xyz", v):
            out[k + c] = x
    for tag, h in (("h1", h1), ("h2", h2)):
        for f in ("hit", "face", "owner", "vx", "vy", "vz", "t"):
            out[f"{tag}_{f}"] = getattr(h, f)
    return out


def scatter(dev, width=None, height=None) -> list:
    a = _scatter_dump(dev, width, height)
    b = _scatter_dump(CPU, width, height)
    rows = _fields("scatter", a, b)
    for r in rows:
        if r["mismatch"]:
            x, y = a[r["field"]].cpu(), b[r["field"]].cpu()
            idx = torch.nonzero(x != y).flatten()[:4]
            r["examples"] = [[int(i), float(x[i]), float(y[i])] for i in idx]
    return rows


COMMANDS = {"arms": arms, "trace": trace, "cache": cache, "split": split,
            "nee": nee, "scatter": scatter}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cmd", nargs="?", default="arms", choices=CMDS)
    p.add_argument("--width", type=int, default=None,
                   help="frame width (default: the golden's)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu to compare the CPU with itself")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    return emit(COMMANDS[args.cmd](dev, args.width, args.height), dev)


if __name__ == "__main__":
    main()
