"""Seeded sparse light sets, built as the port builds them, for the card
tests of the kernels that read a light BVH (the NEE sweep S3, the light
walk S4):

    from _light_sets import lamp_room, quads_and_tris
"""

import numpy as np

from wavefront_tpu_torch.render import lights as lights_mod


def lamp_room(registry, side: int, lamps: int, seed: int):
    """A side x 12 x side room: a stone floor and `lamps` isolated lamp
    voxels (six face prims each) at seeded positions above it."""
    g = np.random.default_rng(seed)
    grid = np.full((side, 12, side), registry.air, np.uint8)
    grid[:, :2, :] = registry.block_idx("stone")
    cells = set()
    while len(cells) < lamps:
        x, z = (int(c) for c in g.integers(1, side - 1, 2))
        y = int(g.integers(4, 11))
        if not any(abs(x - a) <= 1 and abs(y - b) <= 1 and abs(z - c) <= 1
                   for a, b, c in cells):
            cells.add((x, y, z))
    for c in cells:
        grid[c] = registry.block_idx("lamp")
    p0, e1, e2, power = lights_mod.extract_voxel_lights(
        grid, np.zeros(3), registry)[:4]
    return lights_mod.build_light_set(p0, e1, e2, power,
                                      np.zeros(len(p0), bool), 1024,
                                      dense_threshold=8)


def quads_and_tris(count: int, seed: int):
    """`count` seeded quads and triangles (two in five) of sides 0.3-2
    in a 30 x 10 x 30 box, facing every way."""
    g = np.random.default_rng(seed)
    p0 = g.uniform([0, 2, 0], [30, 12, 30], (count, 3)).astype(np.float32)
    e1 = g.normal(0, 1, (count, 3))
    e2 = np.cross(e1, g.normal(0, 1, (count, 3)))
    e1 *= g.uniform(0.3, 2, (count, 1)) / np.linalg.norm(e1, axis=1,
                                                         keepdims=True)
    e2 *= g.uniform(0.3, 2, (count, 1)) / np.linalg.norm(e2, axis=1,
                                                         keepdims=True)
    return lights_mod.build_light_set(
        p0, e1.astype(np.float32), e2.astype(np.float32),
        g.uniform(1, 5, count).astype(np.float32), g.random(count) < 0.4,
        max(count, 512), dense_threshold=8)
