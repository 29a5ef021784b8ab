"""Ego controls manager.

The counterpart of `wavefront_tpu.world.ego_controls`, host code as there.

Reference: src/game_system/ego_controls_manager.rs.  WASD movement in
kinematic (velocity-set) and dynamic (impulse) modes, Tab toggles the body
type, digit keys select the block to place (default id 3,
ego_controls_manager.rs:42), runtime render toggles N (nee_type 0->1->2->0),
B (debug_view), O (sort_type), print_screen (screenshot)
(ego_controls_manager.rs:97-132), and mouse-ray block break/place with a
300 ms debounce through trace_to_solid (ego_controls_manager.rs:250-296).
"""

from __future__ import annotations

import time
from dataclasses import replace

import numpy as np

from wavefront_tpu_torch.core.camera import screen_to_uv
from wavefront_tpu_torch.world.blocks import FACE_AXIS, FACE_SIGN, BlockRegistry
from wavefront_tpu_torch.world.game_world import (
    EntityCreationData,
    GlobalEntityAdd,
    GlobalEntityRemove,
    Manager,
    PhysicsApplyImpulse,
    PhysicsSetVelocity,
    UpdateData,
    WorldSetBlock,
)
from wavefront_tpu_torch.world.input import UserInputState

_DIGITS = [str(i) for i in range(1, 10)]


class EgoControlsManager(Manager):
    def __init__(self, camera, chunk_querier, registry: BlockRegistry,
                 clock=time.monotonic):
        self.camera = camera
        self.querier = chunk_querier
        self.registry = registry
        self.input = UserInputState()
        self.selected_block_id = 3  # reference ego_controls_manager.rs:42
        self._clock = clock
        self.last_broke = clock()
        self.last_placed = clock()

    def update(self, data: UpdateData) -> list:
        events = data.window_events
        ego = data.entities.get(data.ego_entity_id)
        if ego is None or ego.physics_data is None:
            return []
        phys = ego.physics_data.copy()

        self.input.handle_input(events)
        sel = UserInputState.last_key_pressed(events, _DIGITS)
        if sel is not None:
            self.selected_block_id = int(sel) - 1

        cam = self.camera
        cam.set_root_position(ego.isometry[:, 3])
        # camera root follows the ego's yaw (ego_controls_manager.rs:94-95)
        import math as _math

        rot = ego.isometry[:, :3]
        cam.set_root_rotation(float(_math.atan2(rot[0, 2], rot[0, 0])))

        # render toggles (ego_controls_manager.rs:97-132)
        if UserInputState.key_pressed(events, "n"):
            p = cam.rendering_preferences()
            cam.set_rendering_preferences(
                replace(p, nee_type={0: 1, 1: 2}.get(p.nee_type, 0))
            )
        if UserInputState.key_pressed(events, "b"):
            p = cam.rendering_preferences()
            cam.set_rendering_preferences(
                replace(p, debug_view=0 if p.debug_view else 1)
            )
        if UserInputState.key_pressed(events, "o"):
            p = cam.rendering_preferences()
            cam.set_rendering_preferences(
                replace(p, sort_type=0 if p.sort_type else 1)
            )
        if UserInputState.key_pressed(events, "print_screen"):
            p = cam.rendering_preferences()
            cam.set_rendering_preferences(replace(p, should_screenshot=True))

        basis = cam.eye_front_right_up()
        changes = []

        # body-type toggle re-creates the entity (ego_controls_manager.rs:138-154)
        if UserInputState.key_pressed(events, "tab"):
            phys.rigid_body_type = (
                "kinematic" if phys.rigid_body_type == "dynamic" else "dynamic"
            )
            changes.append(GlobalEntityRemove(data.ego_entity_id))
            changes.append(
                GlobalEntityAdd(
                    data.ego_entity_id,
                    EntityCreationData(
                        mesh=ego.mesh, isometry=ego.isometry, physics=phys
                    ),
                )
            )

        cur = self.input.current
        rot = ego.isometry[:, :3]

        if phys.rigid_body_type == "kinematic":
            # (ego_controls_manager.rs:158-194)
            move, rotate, jump = 10.0, 2.0, 10.0
            linvel = np.zeros(3)
            angvel = np.zeros(3)
            if cur.w:
                linvel += move * np.array([1.0, 0.0, 0.0])
            if cur.s:
                linvel -= move * np.array([1.0, 0.0, 0.0])
            if cur.space:
                linvel += jump * np.array([0.0, 1.0, 0.0])
            if cur.shift:
                linvel -= jump * np.array([0.0, 1.0, 0.0])
            if cur.a:
                angvel += rotate * np.array([0.0, -1.0, 0.0])
            if cur.d:
                angvel += rotate * np.array([0.0, 1.0, 0.0])
            changes.append(
                PhysicsSetVelocity(
                    data.ego_entity_id, (rot @ linvel).astype(np.float32), angvel
                )
            )
        elif phys.rigid_body_type == "dynamic":
            # (ego_controls_manager.rs:195-246)
            move, rotate, jump = 5.0, 2.0, 7.0
            tx = move * (int(cur.w) - int(cur.s))
            ty = jump * (int(cur.space) - int(cur.shift))
            ta = rotate * (int(cur.d) - int(cur.a))
            current_local = rot.T @ np.asarray(phys.linvel, np.float64)
            impulse = (
                (np.array([tx, ty, 0.0]) - current_local) * phys.mass * 0.3
            )
            if ty == 0.0 or not phys.grounded:
                impulse[1] = 0.0
            inertia = phys.mass * float(
                phys.half_extents[0] ** 2 + phys.half_extents[2] ** 2
            ) / 3.0
            torque = (ta - float(phys.angvel[1])) * inertia * 0.1
            changes.append(
                PhysicsApplyImpulse(
                    data.ego_entity_id,
                    (rot @ impulse).astype(np.float32),
                    np.array([0.0, torque, 0.0], np.float32),
                )
            )

        # block manipulation via the mouse ray (ego_controls_manager.rs:250-296)
        uv = screen_to_uv(cur.pos[0], cur.pos[1], data.extent)
        aspect = data.extent[0] / data.extent[1]
        d = uv[0] * basis.right * aspect + uv[1] * basis.up + basis.front
        d = d / np.linalg.norm(d)
        hit = self.querier.trace_to_solid(basis.eye, d, 10.0)
        if hit is not None:
            coords, face = hit
            now = self._clock()
            if cur.mouse_left_down and (now - self.last_broke) > 0.3:
                changes.append(
                    WorldSetBlock(np.asarray(coords), self.registry.air)
                )
                self.last_broke = now
            elif cur.mouse_right_down and (now - self.last_placed) > 0.3:
                off = np.array(
                    [FACE_AXIS[face] == a for a in range(3)], np.int64
                ) * FACE_SIGN[face]
                changes.append(
                    WorldSetBlock(
                        np.asarray(coords) + off, self.selected_block_id
                    )
                )
                self.last_placed = now
        return changes
