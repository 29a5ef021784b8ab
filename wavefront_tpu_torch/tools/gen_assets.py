"""Generate the block asset pack (blocks.json and the 16x16 PNG
textures), and hold it to the repository's `assets/`.

Counterpart of `tools/gen_assets.py`: the same seeded procedural
textures (numpy.random.RandomState(2026), drawn in the same order), the
same `blocks.json` schema and text, written through `PIL.Image` as the
JAX tool writes them.  The root defaults to `build/assets/`; the
repository's `assets/` is the record the pack is held to and is never a
root here.  After writing, each file is compared with the file of the
same name under `assets/`: `blocks.json` byte for byte, every texture's
decoded RGBA exactly, and the textures that are equal byte for byte are
counted.

    python -m wavefront_tpu_torch.tools.gen_assets [--root build/assets] \
        [--device cuda]

One JSON line, with the card's name and power limit (the pack is made on
the host; the line says which machine made it) and the versions of PIL
and of the zlib it encodes with; exits 1 when the pack differs.  Without a card it exits unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from wavefront_tpu_torch.headline import ASSETS, REPO
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit

S = 16
FACES = ["left", "right", "down", "up", "back", "front"]
DEFAULT_ROOT = os.path.join(REPO, "build", "assets")


def save(path: str, rgba: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(np.clip(rgba * 255.0, 0, 255).astype(np.uint8),
                          "RGBA")
    img.save(path)


def flat(rgb, alpha=1.0) -> np.ndarray:
    a = np.empty((S, S, 4), np.float32)
    a[..., :3] = rgb
    a[..., 3] = alpha
    return a


def speckle(rs, base, amount=0.08, alpha=1.0) -> np.ndarray:
    n = rs.uniform(-amount, amount, size=(S, S, 1))
    a = flat(base, alpha)
    a[..., :3] = np.clip(a[..., :3] + n, 0.0, 1.0)
    return a


def bordered(inner, border, alpha_inner=1.0, alpha_border=1.0) -> np.ndarray:
    a = flat(inner, alpha_inner)
    for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        a[edge][..., :3] = border
        a[edge][..., 3] = alpha_border
    return a


def _refuse(root: str) -> None:
    assets = os.path.realpath(ASSETS)
    path = os.path.realpath(root)
    if os.path.commonpath([path, assets]) == assets:
        raise SystemExit(f"gen_assets: {root} lies in the repository's "
                         "assets/, the record the pack is held to; write "
                         "it elsewhere")


def generate(root: str) -> list:
    """Write the pack under `root`; returns the files written, relative
    to it."""
    _refuse(root)
    rs = np.random.RandomState(2026)
    written = []

    def put(rel, img):
        save(os.path.join(root, rel), img)
        written.append(rel)

    put("black.png", flat([0.0, 0.0, 0.0]))
    put("white.png", flat([1.0, 1.0, 1.0]))

    grass_top = speckle(rs, [0.13, 0.55, 0.13])
    grass_side = speckle(rs, [0.45, 0.33, 0.18])
    grass_side[:5, :, :3] = grass_top[:5, :, :3]  # grassy fringe on top rows
    soil = speckle(rs, [0.42, 0.30, 0.17])
    stone = speckle(rs, [0.48, 0.48, 0.50], amount=0.06)
    lamp_reflect = flat([0.85, 0.82, 0.70])
    lamp_emit = flat([1.0, 0.95, 0.80])
    glass = bordered([0.85, 0.93, 0.95], [0.75, 0.85, 0.88],
                     alpha_inner=0.1, alpha_border=1.0)
    # texturetest: a distinct hue per face, to debug orientation
    hues = {"left": [1.0, 0.2, 0.2], "right": [0.2, 1.0, 0.2],
            "down": [0.2, 0.2, 1.0], "up": [1.0, 1.0, 0.2],
            "back": [1.0, 0.2, 1.0], "front": [0.2, 1.0, 1.0]}

    def block(name, solid, translucent, luminescent, face_imgs):
        d = {"solid": solid, "translucent": translucent,
             "luminescent": luminescent}
        for face in FACES:
            entry = {}
            for kind, img in zip(("reflectivity", "emissivity",
                                  "metallicity"), face_imgs(face)):
                if isinstance(img, np.ndarray):
                    rel = f"blocks/{name}/{face}.{kind}.png"
                    put(rel, img)
                    img = "./" + rel
                entry[kind] = img
            d[face] = entry
        return d

    black, white = "./black.png", "./white.png"
    blocks = {
        "texturetest": block("texturetest", True, True, False,
                             lambda f: (flat(hues[f]), black, black)),
        "grass": block("grass", True, False, False, lambda f: (
            grass_top if f == "up" else (soil if f == "down"
                                         else grass_side), black, black)),
        "soil": block("soil", True, False, False,
                      lambda f: (soil, black, black)),
        "stone": block("stone", True, False, False,
                       lambda f: (stone, black, black)),
        "lamp": block("lamp", True, False, True,
                      lambda f: (lamp_reflect, lamp_emit, black)),
        "glass": block("glass", True, True, False,
                       lambda f: (glass, black, black)),
        "mirror": block("mirror", True, False, False,
                        lambda f: (white, black, white)),
    }
    with open(os.path.join(root, "blocks.json"), "w") as f:
        json.dump({"blocks": blocks}, f, indent=4)
    return sorted(set(written)) + ["blocks.json"]


def versions() -> dict:
    """The PIL that writes the pack and the zlib its PNG encoder links."""
    import PIL
    from PIL import features

    return {"pil": PIL.__version__, "zlib": features.version("zlib")}


def _rgba(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def compare(root: str, files: list) -> dict:
    """`files` under `root` against the same names under `assets/`, and
    the textures `assets/` holds that `root` lacks."""
    def read(path):
        with open(path, "rb") as f:
            return f.read()

    textures = [f for f in files if f.endswith(".png")]
    theirs = sorted(
        os.path.relpath(os.path.join(d, f), ASSETS)
        for d, _, names in os.walk(ASSETS) for f in names
        if f.endswith(".png"))
    byte_equal = sum(read(os.path.join(root, f)) == read(
        os.path.join(ASSETS, f)) for f in textures if f in theirs)
    rgba_equal = sum(
        f in theirs and np.array_equal(_rgba(os.path.join(root, f)),
                                       _rgba(os.path.join(ASSETS, f)))
        for f in textures)
    json_equal = read(os.path.join(root, "blocks.json")) == read(
        os.path.join(ASSETS, "blocks.json"))
    missing = sorted(set(theirs) - set(textures))
    return {"textures": len(textures), "reference_textures": len(theirs),
            "missing": missing, "blocks_json_byte_equal": json_equal,
            "rgba_equal_textures": rgba_equal,
            "byte_equal_textures": byte_equal,
            "pass": bool(json_equal and not missing
                         and rgba_equal == len(textures))}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=DEFAULT_ROOT,
                   help="directory to write (never the repository's "
                        "assets/)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card's host), or cpu")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    files = generate(args.root)
    rec = {"tool": "gen_assets", "root": os.path.relpath(args.root, REPO),
           **versions(), **compare(args.root, files)}
    rows = emit([rec], dev)
    if not rec["pass"]:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
