"""Physics manager.

The counterpart of `wavefront_tpu.world.physics`, host numpy as there.

Reference: src/game_system/physics_manager.rs, which runs a full rapier3d
pipeline.  Rapier parity is out of scope (SURVEY.md section 7 phase 4); this
manager reproduces the *observable movement semantics* against voxel
terrain:

  * gravity -9.81 on dynamic bodies (physics_manager.rs:192),
  * rotation locked to the y axis (physics_manager.rs:102),
  * the hover-above-ground hack: a downward shape cast measures ground
    distance; if the body penetrates (<0.025) or nearly touches (<0.05) the
    ground and is falling, vertical velocity is reset so the body floats
    just above the surface (physics_manager.rs:163-251),
  * PhysicsSetVelocity / PhysicsApplyImpulse application
    (physics_manager.rs:298-311),
  * rigid-body state diffed back into GlobalEntityUpdate* world changes
    (physics_manager.rs:320-361),
  * entity-entity contact resolution: rapier steps every entity collider
    through its contact solver (physics_manager.rs:41-122), so dynamic
    bodies collide with each other and with kinematic bodies.  Here that
    is a few Gauss-Seidel passes of AABB min-penetration-axis separation
    (rotation is y-locked and hitboxes are AABBs) with inelastic
    momentum-conserving velocity correction (rapier default restitution
    is 0), so dropped boxes stack and come to rest.

Terrain collision uses the voxel grid directly (AABB vs solid voxels) in
place of rapier's compound colliders (chunk.rs:112-147).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import (
    GlobalEntityAdd,
    GlobalEntityRemove,
    GlobalEntityUpdateGroundedness,
    GlobalEntityUpdateIsometry,
    GlobalEntityUpdateVelocity,
    Manager,
    PhysicsApplyImpulse,
    PhysicsSetVelocity,
    UpdateData,
    isometry_yaw,
)

GRAVITY_Y = -9.81


@dataclass
class _Body:
    kind: str              # "dynamic" | "kinematic" | "fixed"
    pos: np.ndarray        # (3,)
    yaw: float
    linvel: np.ndarray
    angvel_y: float
    half: np.ndarray       # AABB half extents
    mass: float
    controlled: bool
    grounded: bool = False


class PhysicsManager(Manager):
    def __init__(self, chunk_querier, registry: BlockRegistry):
        self.querier = chunk_querier
        self.registry = registry
        self.bodies: Dict[int, _Body] = {}

    # ---- voxel collision helpers ----

    def _solid_at(self, p) -> bool:
        b = self.querier.get_block(np.floor(p).astype(np.int64))
        if b is None:
            return False
        solid = self.registry.solid
        return b < len(solid) and bool(solid[b])

    def _solid_batch(self, coords) -> np.ndarray:
        """(N,3) int voxel coords -> (N,) bool, vectorized through the
        chunk manager's batched block query (one dict lookup per distinct
        chunk, not a Python walk per voxel)."""
        ids = self.querier.get_blocks(coords)
        solid = np.asarray(self.registry.solid, bool)
        ok = (ids >= 0) & (ids < len(solid))
        out = np.zeros(ids.shape[0], bool)
        out[ok] = solid[ids[ok]]
        return out

    def _aabb_overlaps_solid(self, pos, half) -> bool:
        lo = pos - half
        hi = pos + half
        xs = np.arange(math.floor(lo[0]), math.floor(hi[0] - 1e-6) + 1)
        ys = np.arange(math.floor(lo[1]), math.floor(hi[1] - 1e-6) + 1)
        zs = np.arange(math.floor(lo[2]), math.floor(hi[2] - 1e-6) + 1)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        coords = np.stack(
            [gx.ravel(), gy.ravel(), gz.ravel()], 1
        ).astype(np.int64)
        return bool(self._solid_batch(coords).any())

    def _cast_down(self, body: _Body, max_distance: float):
        """Distance from the AABB's bottom face to the terrain below
        (reference cast_down, physics_manager.rs:163-188).  One batched
        block query over the (columns x depth) probe grid; per-column
        first-solid via argmax on the boolean grid."""
        lo = body.pos - body.half
        hi = body.pos + body.half
        bottom = float(lo[1])
        xs = np.arange(math.floor(lo[0]), math.floor(hi[0] - 1e-6) + 1)
        zs = np.arange(math.floor(lo[2]), math.floor(hi[2] - 1e-6) + 1)
        y0 = math.floor(bottom)
        depth = int(math.ceil(max_distance)) + 1   # y0 .. y0-depth+1
        ys = y0 - np.arange(depth)
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        coords = np.stack(
            [gx.ravel(), gy.ravel(), gz.ravel()], 1
        ).astype(np.int64)
        sol = self._solid_batch(coords).reshape(len(xs), depth, len(zs))
        # first solid DOWNWARD per column (depth axis is descending y)
        any_hit = sol.any(axis=1)                       # (X, Z)
        first = np.argmax(sol, axis=1)                  # (X, Z) depth idx
        if not any_hit.any():
            return max_distance, False
        y_hit = y0 - first                              # voxel y of hit
        d = bottom - (y_hit + 1.0)                      # face distance
        d = np.where(any_hit, np.maximum(d, 0.0), max_distance)
        best = float(d.min())
        if best >= max_distance:
            return max_distance, False
        return best, True

    def _resolve_entity_contacts(self, passes: int) -> None:
        """AABB-vs-AABB contact resolution between entity bodies.

        Each overlapping pair with at least one dynamic member is separated
        along its minimum-penetration axis, split by inverse mass (dynamic
        vs kinematic/fixed: the dynamic body absorbs the whole correction),
        and the approaching relative velocity along that axis is removed
        inelastically with momentum conservation.  A body resting on top of
        another is marked grounded (rapier's ground cast sees entity
        colliders too, physics_manager.rs:163-188).
        """
        # fixed entity boxes participate as immovable obstacles.
        # Broad phase: sweep-and-prune on x (vectorized argsort over AABB
        # mins) yields only x-overlapping candidate pairs — O(n log n + c)
        # instead of an all-pairs Python loop (terrain needs NO per-chunk
        # hitboxes here: the voxel grid IS
        # the collider via the per-axis sweep, so n is the real entity
        # count, not the reference's one-Fixed-box-per-chunk,
        # chunk_manager.rs:215-253).  Candidates are re-sorted by (i, j)
        # so the Gauss-Seidel resolution order is that of an all-pairs
        # loop (non-overlapping pairs are no-ops).
        items = sorted(self.bodies.items())
        bodies = [b for _, b in items]
        n = len(bodies)
        if n < 2 or not any(b.kind == "dynamic" for b in bodies):
            return
        dyn = np.array([b.kind == "dynamic" for b in bodies])
        for _ in range(passes):
            pos = np.array([b.pos for b in bodies])       # (n, 3)
            half = np.array([b.half for b in bodies])
            lo, hi = pos - half, pos + half
            order = np.argsort(lo[:, 0], kind="stable")
            pairs = []
            active: list = []
            for oi in order:
                x0 = lo[oi, 0]
                active = [a for a in active if hi[a, 0] > x0]
                for a in active:
                    i, j = (a, oi) if a < oi else (oi, a)
                    if dyn[i] or dyn[j]:
                        pairs.append((i, j))
                active.append(oi)
            any_contact = False
            for i, j in sorted(pairs):
                    bi, bj = bodies[i], bodies[j]
                    dyn_i = bi.kind == "dynamic"
                    dyn_j = bj.kind == "dynamic"
                    delta = bi.pos - bj.pos
                    overlap = (bi.half + bj.half) - np.abs(delta)
                    if np.any(overlap <= 0.0):
                        continue
                    any_contact = True
                    ax = int(np.argmin(overlap))
                    direction = 1.0 if delta[ax] >= 0.0 else -1.0
                    w_i = (1.0 / bi.mass) if dyn_i else 0.0
                    w_j = (1.0 / bj.mass) if dyn_j else 0.0
                    wsum = w_i + w_j
                    if wsum <= 0.0:
                        continue
                    push = overlap[ax] * direction

                    # positional separation, rejected against terrain
                    corr_i = push * (w_i / wsum)
                    corr_j = -push * (w_j / wsum)
                    trial_i = bi.pos.copy()
                    trial_i[ax] += corr_i
                    trial_j = bj.pos.copy()
                    trial_j[ax] += corr_j
                    ok_i = not (
                        dyn_i and self._aabb_overlaps_solid(trial_i, bi.half)
                    )
                    ok_j = not (
                        dyn_j and self._aabb_overlaps_solid(trial_j, bj.half)
                    )
                    if ok_i and ok_j:
                        if dyn_i:
                            bi.pos = trial_i
                        if dyn_j:
                            bj.pos = trial_j
                    elif ok_i and dyn_i:
                        bi.pos[ax] += push  # j is blocked; i absorbs all
                    elif ok_j and dyn_j:
                        bj.pos[ax] -= push

                    # inelastic normal-velocity correction (restitution 0)
                    vrel = bi.linvel[ax] - bj.linvel[ax]
                    if vrel * direction < 0.0:  # approaching
                        if dyn_i and dyn_j:
                            p = (
                                bi.mass * bi.linvel[ax]
                                + bj.mass * bj.linvel[ax]
                            ) / (bi.mass + bj.mass)
                            bi.linvel[ax] = p
                            bj.linvel[ax] = p
                        elif dyn_i:
                            bi.linvel[ax] = bj.linvel[ax]
                        else:
                            bj.linvel[ax] = bi.linvel[ax]

                    # resting on top of the other body => grounded
                    if ax == 1:
                        if dyn_i and delta[1] > 0:
                            bi.grounded = True
                        if dyn_j and delta[1] < 0:
                            bj.grounded = True
            if not any_contact:
                break

    # ---- manager interface ----

    def _add_entity(self, eid: int, data) -> None:
        if data.physics is None:
            return
        p = data.physics
        pos = np.array(data.isometry[:, 3], np.float64)
        yaw = float(math.atan2(data.isometry[0, 2], data.isometry[0, 0]))
        self.bodies[eid] = _Body(
            kind=p.rigid_body_type,
            pos=pos,
            yaw=yaw,
            linvel=np.array(p.linvel, np.float64),
            angvel_y=float(p.angvel[1]),
            half=np.array(p.half_extents, np.float64),
            mass=p.mass,
            controlled=p.controlled,
            grounded=p.grounded,
        )

    def update(self, data: UpdateData) -> list:
        # apply last step's structural + impulse changes
        # (reference physics_manager.rs:287-316)
        for ch in data.world_changes:
            if isinstance(ch, GlobalEntityAdd):
                self._add_entity(ch.id, ch.data)
            elif isinstance(ch, GlobalEntityRemove):
                self.bodies.pop(ch.id, None)
            elif isinstance(ch, PhysicsSetVelocity):
                b = self.bodies.get(ch.id)
                if b:
                    b.linvel = np.array(ch.linvel, np.float64)
                    b.angvel_y = float(ch.angvel[1])
            elif isinstance(ch, PhysicsApplyImpulse):
                b = self.bodies.get(ch.id)
                if b and b.kind == "dynamic":
                    b.linvel = b.linvel + np.array(ch.impulse) / b.mass
                    # torque about y with a crude inertia of a box
                    inertia = b.mass * (b.half[0] ** 2 + b.half[2] ** 2) / 3.0
                    b.angvel_y += float(ch.torque_impulse[1]) / max(inertia, 1e-6)

        dt = data.dt

        # ground hover hack for controlled dynamic bodies
        # (reference physics_manager.rs:192-251)
        for b in self.bodies.values():
            if not (b.controlled and b.kind == "dynamic"):
                continue
            dist, _found = self._cast_down(b, 1.0)
            ground_just_below = dist < 0.05
            intersecting = dist < 0.025
            b.grounded = ground_just_below
            if intersecting:
                if b.linvel[1] < 0.05:
                    b.linvel[1] = -dt * GRAVITY_Y + (0.025 - dist)
            elif ground_just_below:
                if b.linvel[1] < 0.0:
                    b.linvel[1] = -dt * GRAVITY_Y

        # integrate
        for b in self.bodies.values():
            if b.kind == "fixed":
                continue
            if b.kind == "dynamic":
                b.linvel = b.linvel + np.array([0.0, GRAVITY_Y * dt, 0.0])
            new_pos = b.pos + b.linvel * dt
            if b.kind == "dynamic":
                # per-axis sweep against solid voxels (replaces rapier's
                # contact solver for box-vs-terrain)
                pos = b.pos.copy()
                for ax in range(3):
                    trial = pos.copy()
                    trial[ax] = new_pos[ax]
                    if self._aabb_overlaps_solid(trial, b.half):
                        b.linvel[ax] = 0.0
                    else:
                        pos = trial
                b.pos = pos
            else:  # kinematic: no terrain collision (rapier semantics)
                b.pos = new_pos
            b.yaw += b.angvel_y * dt

        # entity-entity contact resolution (reference: rapier contact
        # solver over entity colliders, physics_manager.rs:41-54).
        # Solid-terrain contacts were already resolved by the sweep above;
        # a positional correction is rejected if it would push a body into
        # terrain (the other body then absorbs the full correction).
        self._resolve_entity_contacts(passes=4)

        # diff state back into world changes (physics_manager.rs:320-361)
        changes = []
        for eid, b in self.bodies.items():
            if b.kind == "fixed":
                continue
            changes.append(
                GlobalEntityUpdateIsometry(eid, isometry_yaw(b.pos, b.yaw))
            )
            changes.append(
                GlobalEntityUpdateVelocity(
                    eid,
                    b.linvel.astype(np.float32),
                    np.array([0.0, b.angvel_y, 0.0], np.float32),
                )
            )
            changes.append(GlobalEntityUpdateGroundedness(eid, b.grounded))
        return changes
