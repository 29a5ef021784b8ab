"""The reference of the lamp-lit window: its lamps and the light pick of a
sparse light set.

The lamps are the rule the configuration states (one lamp resting on the
ground of each chunk column), written again here from the rule alone.

Upstream picks a light by a stochastic descent of the light BVH
(`raytrace.rs:230-293`): from the root, at each level one fresh murmur3
uniform goes left when it falls below the left child's importance over
the sum of both children's, until a leaf.  The dense pick of `Reference`
draws the same distribution from one uniform, which chooses other prims
from the same seed; the program draws it so only for a light set of at
most `DENSE_PRIMS` prims, and walks above that.  `LampReference`
overrides the pick alone and keeps the NEE pdf exact (`Reference.nee_pdf`,
over every prim the direction crosses).  Plain NumPy and PyTorch, float64.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.lights import SENTINEL, Lights
from benchmark.reference.render import (DENSE_PRIMS, EPS, Reference,
                                        combine, rand)

CHUNK = 32


def lamp_cells(grid: np.ndarray, air: int) -> list:
    """(x, y, z) grid cells of the window's lamps: on each chunk column
    (i, j), at x = 32 i + 16 + (5 j + i^2) mod 7 - 3 and
    z = 32 j + 16 + (3 i + j^2) mod 7 - 3, one cell above the column's
    highest non-air cell, kept where that cell lies below the top row."""
    out = []
    top = grid.shape[1] - 1
    for i in range(grid.shape[0] // CHUNK):
        for j in range(grid.shape[2] // CHUNK):
            x = CHUNK * i + 16 + (5 * j + i * i) % 7 - 3
            z = CHUNK * j + 16 + (3 * i + j * j) % 7 - 3
            solid = np.nonzero(grid[x, :, z] != air)[0]
            if len(solid) and solid.max() + 1 <= top - 1:
                out.append((x, int(solid.max()) + 1, z))
    return out


class LampReference(Reference):
    """`Reference` with the stochastic light walk for sparse light sets
    (more than DENSE_PRIMS prims); a dense set keeps the dense pick."""

    def __init__(self, grid, origin, blocks, lights: Lights, tris=None,
                 device="cpu"):
        # no float32 product may round through TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if lights.count <= DENSE_PRIMS:
            super().__init__(grid, origin, blocks, lights, tris, device)
            return
        # the base class takes dense sets only: built on none, then given
        # the set as it would hold it
        none = Lights(*([np.zeros((0, 3), np.float32)] * 3),
                      np.zeros(0, bool), np.zeros(0, np.float32),
                      np.zeros(0, np.int64), *([np.array([SENTINEL])] * 3),
                      *([np.zeros((1, 3), np.float32)] * 2),
                      np.zeros(1, np.float32))
        super().__init__(grid, origin, blocks, none, tris, device)
        dev = self.dev
        f64 = dict(dtype=torch.float64, device=dev)
        self.lights = lights
        self.p0 = torch.as_tensor(lights.p0, **f64)
        self.e1 = torch.as_tensor(lights.e1, **f64)
        self.e2 = torch.as_tensor(lights.e2, **f64)
        self.l_tri = torch.as_tensor(lights.is_tri, device=dev)
        self.l_area = torch.as_tensor(lights.area, **f64)
        self.n_min = torch.as_tensor(lights.node_min, **f64)
        self.n_max = torch.as_tensor(lights.node_max, **f64)
        self.n_pow = torch.as_tensor(lights.node_power, **f64)
        self.prim_paths = []
        for q in range(lights.count):
            path = [int(lights.leaf[q])]
            while lights.parent[path[-1]] != SENTINEL:
                path.append(int(lights.parent[path[-1]]))
            path.reverse()
            self.prim_paths.append(list(zip(path[:-1], path[1:])))
        leaf = lights.left == SENTINEL
        # -1 on a leaf, whose `right` holds its prim
        self.n_left = torch.as_tensor(np.where(leaf, -1, lights.left),
                                      device=dev)
        self.n_right = torch.as_tensor(lights.right, device=dev)

    def light_pick(self, point, normal, seed):
        """The walk: (the leaf's prim, its importance > 0).  A split whose
        children both have importance 0 goes right with importance 0,
        which the caller rejects."""
        if self.lights.count <= DENSE_PRIMS:
            return super().light_pick(point, normal, seed)
        n = point.shape[0]
        imp = self._importance(point, normal, EPS)

        def at(node):
            return imp.gather(1, node[:, None]).squeeze(1)

        node = torch.zeros(n, dtype=torch.int64, device=self.dev)
        # the dummy-root rule: a root that is a leaf is the pick
        got = at(node) if int(self.n_left[0]) < 0 else torch.zeros(
            n, dtype=torch.float64, device=self.dev)
        s = seed
        while True:
            step = self.n_left[node] >= 0
            if not bool(step.any()):
                break
            li = self.n_left[node].clamp(min=0)
            ri = torch.where(step, self.n_right[node], li)
            il, ir = at(li), at(ri)
            tot = il + ir
            share = torch.where(tot > 0, il / torch.where(
                tot > 0, tot, torch.ones_like(tot)), torch.zeros_like(tot))
            left = rand(s) < share
            node = torch.where(step, torch.where(left, li, ri), node)
            got = torch.where(step, torch.where(left, il, ir), got)
            s = combine(s, 0)
        return self.n_right[node], got > 0
