"""GameWorld orchestrator, Manager protocol, WorldChange event bus.

Reference: src/game_system/game_world.rs and manager.rs.  All world mutation
flows through `WorldChange` events produced by managers; each step runs the
manager pipeline in order [chunk, physics, ego, scene] (game_world.rs:197-202),
applies changes to the entity table, renders, handles the screenshot request,
and hands last step's changes to next step's managers.  The step names its
manager loop `world.managers`, each manager in it `world.chunk`,
`world.physics`, `world.ego` and `world.scene`, and the entity table's
update `world.entity_table` (`utils/spans.py`).

The counterpart of `wavefront_tpu.world.game_world`.  The world, its chunks,
physics and input stay numpy on the host; the scene and the renderer live
on `device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional

import numpy as np

from wavefront_tpu_torch.core.camera import Camera, SphericalCamera
from wavefront_tpu_torch.core.config import RenderSettings, WorldSettings
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.utils.spans import span
from wavefront_tpu_torch.world.blocks import BlockRegistry


@dataclass
class EntityPhysicsData:
    """reference game_world.rs:40-47."""

    rigid_body_type: str  # "dynamic" | "kinematic" | "fixed"
    half_extents: np.ndarray  # AABB hitbox half extents
    linvel: np.ndarray
    angvel: np.ndarray
    controlled: bool = False
    grounded: bool = False
    mass: float = 1.0

    def copy(self) -> "EntityPhysicsData":
        return EntityPhysicsData(
            self.rigid_body_type,
            np.array(self.half_extents),
            np.array(self.linvel),
            np.array(self.angvel),
            self.controlled,
            self.grounded,
            self.mass,
        )


@dataclass
class Mesh:
    verts: np.ndarray  # (T,3,3) object space
    uv: np.ndarray     # (T,3,2)
    tex: np.ndarray    # (T,)


@dataclass
class EntityCreationData:
    """reference game_world.rs:49-57."""

    mesh: Optional[Mesh]
    isometry: np.ndarray  # (3,4) [R|t] affine, rotation about y only
    physics: Optional[EntityPhysicsData] = None


@dataclass
class Entity:
    mesh: Optional[Mesh]
    isometry: np.ndarray
    physics_data: Optional[EntityPhysicsData]


def translation(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)[:3]
    m[:, 3] = (x, y, z)
    return m


def isometry_yaw(pos, yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.array(
        [[c, 0, s, pos[0]], [0, 1, 0, pos[1]], [-s, 0, c, pos[2]]], np.float32
    )
    return m


# ---- WorldChange event bus (reference game_world.rs:68-92) ----


@dataclass
class GlobalEntityAdd:
    id: int
    data: EntityCreationData


@dataclass
class GlobalEntityRemove:
    id: int


@dataclass
class GlobalEntityUpdateIsometry:
    id: int
    isometry: np.ndarray


@dataclass
class GlobalEntityUpdateVelocity:
    id: int
    linvel: np.ndarray
    angvel: np.ndarray


@dataclass
class GlobalEntityUpdateGroundedness:
    id: int
    grounded: bool


@dataclass
class PhysicsSetVelocity:
    id: int
    linvel: np.ndarray
    angvel: np.ndarray


@dataclass
class PhysicsApplyImpulse:
    id: int
    impulse: np.ndarray
    torque_impulse: np.ndarray


@dataclass
class WorldSetBlock:
    global_coords: np.ndarray
    block_id: int


@dataclass
class UpdateData:
    """reference manager.rs:5-13."""

    entities: Dict[int, Entity]
    window_events: list
    world_changes: list
    ego_entity_id: int
    extent: tuple
    reserve_entity_id: Callable[[], int]
    dt: float


class Manager:
    """reference manager.rs:15-20."""

    def update(self, data: UpdateData) -> list:
        raise NotImplementedError


class GameWorld:
    """reference game_world.rs:94-380."""

    def __init__(
        self,
        registry: BlockRegistry,
        settings: RenderSettings = None,
        world_settings: WorldSettings = None,
        camera: Camera = None,
        ego_entity_id: int = 0,
        renderer: Renderer = None,
        # device-window half-extent in chunks: int (cubic), per-axis tuple,
        # or None to derive the reference-scale window from
        # WorldSettings.load_radius (chunk_manager.rs:29-37)
        window_chunks=2,
        screenshot_dir: str = "screenshots",
        headless: bool = False,
        device="cuda",
    ):
        from wavefront_tpu_torch.world.chunk_manager import ChunkManager
        from wavefront_tpu_torch.world.ego_controls import EgoControlsManager
        from wavefront_tpu_torch.world.physics import PhysicsManager
        from wavefront_tpu_torch.world.scene_manager import SceneManager

        self.registry = registry
        self.settings = settings or RenderSettings()
        self.world_settings = world_settings or WorldSettings()
        self.camera = camera or SphericalCamera()
        self.ego_entity_id = ego_entity_id
        self.screenshot_dir = screenshot_dir
        self.headless = headless
        self.frame_count = 0
        self.dt = 1.0 / 60.0

        self.entities: Dict[int, Entity] = {}
        self.events_since_last_step: list = []
        self.changes_since_last_step: list = []

        # the voxel window scene + renderer
        cs = self.world_settings.chunk_size
        if window_chunks is None:
            ws = self.world_settings
            window_chunks = (ws.load_radius, 1, ws.load_radius)
        if isinstance(window_chunks, int):
            window_chunks = (window_chunks,) * 3
        wx, wy, wz = window_chunks
        empty = np.full(
            ((2 * wx + 1) * cs, (2 * wy + 1) * cs, (2 * wz + 1) * cs),
            registry.air,
            np.uint8,
        )
        self.scene = VoxelScene(
            registry, empty, (-wx * cs, -wy * cs, -wz * cs), device=device
        )
        self.renderer = renderer or (
            None if headless else Renderer(self.settings, device=device))
        self.last_image: Optional[np.ndarray] = None
        # the last frame's audit ("truncated", "nee_overflow"), kept when
        # a Renderer's settings ask for it (trace_audit)
        self.last_aux: Optional[dict] = None

        chunk_manager = ChunkManager(
            self.world_settings, registry, self.scene, window_chunks=window_chunks
        )
        self.chunk_querier = chunk_manager.querier
        physics_manager = PhysicsManager(self.chunk_querier, registry)
        ego_manager = EgoControlsManager(self.camera, self.chunk_querier, registry)
        scene_manager = SceneManager(self.scene)
        # pipeline order: reference game_world.rs:197-202
        self.managers: List[Manager] = [
            chunk_manager,
            physics_manager,
            ego_manager,
            scene_manager,
        ]

        self._rng = np.random.RandomState(0xC0FFEE)

    # ---- entity API (reference game_world.rs:350-371) ----

    def add_entity(self, entity_id: int, data: EntityCreationData) -> None:
        self.entities[entity_id] = Entity(
            mesh=data.mesh, isometry=data.isometry, physics_data=data.physics
        )
        self.changes_since_last_step.append(GlobalEntityAdd(entity_id, data))

    def remove_entity(self, entity_id: int) -> None:
        self.entities.pop(entity_id, None)
        self.changes_since_last_step.append(GlobalEntityRemove(entity_id))

    def handle_window_event(self, event) -> None:
        self.events_since_last_step.append(event)

    def _reserve_entity_id(self) -> int:
        while True:
            i = int(self._rng.randint(1, 2**31))
            if i not in self.entities:
                return i

    def update_entity_table(self, changes: list) -> None:
        """reference game_world.rs:216-255."""
        for ch in changes:
            if isinstance(ch, GlobalEntityAdd):
                self.entities[ch.id] = Entity(
                    mesh=ch.data.mesh,
                    isometry=ch.data.isometry,
                    physics_data=ch.data.physics,
                )
            elif isinstance(ch, GlobalEntityRemove):
                self.entities.pop(ch.id, None)
            elif isinstance(ch, GlobalEntityUpdateIsometry):
                if ch.id in self.entities:
                    self.entities[ch.id].isometry = ch.isometry
            elif isinstance(ch, GlobalEntityUpdateVelocity):
                e = self.entities.get(ch.id)
                if e and e.physics_data:
                    e.physics_data.linvel = np.array(ch.linvel)
                    e.physics_data.angvel = np.array(ch.angvel)
            elif isinstance(ch, GlobalEntityUpdateGroundedness):
                e = self.entities.get(ch.id)
                if e and e.physics_data:
                    e.physics_data.grounded = ch.grounded

    # ---- the frame step (reference game_world.rs:257-347) ----

    def _update(self, manager: Manager, extent) -> list:
        """One manager's update on this step's data."""
        return manager.update(UpdateData(
            entities=self.entities,
            window_events=self.events_since_last_step,
            world_changes=self.changes_since_last_step,
            ego_entity_id=self.ego_entity_id,
            extent=extent,
            reserve_entity_id=self._reserve_entity_id,
            dt=self.dt,
        ))

    def step(self) -> None:
        extent = (self.settings.width, self.settings.height)
        # route mouse events to the interactive camera (the reference's
        # winit loop hands window events to the InteractiveCamera before
        # the managers run: middle-drag orbit + wheel zoom,
        # camera.rs:144-203)
        cam = self.camera
        if hasattr(cam, "on_mouse_move"):
            from wavefront_tpu_torch.core.camera import normalized_mouse_coords

            for e in self.events_since_last_step:
                if e.kind == "mouse_move":
                    cam.on_mouse_move(
                        *normalized_mouse_coords(e.x, e.y, extent)
                    )
                elif e.kind == "mouse_down" and e.button == "middle":
                    cam.on_mouse_down()
                elif e.kind == "mouse_up" and e.button == "middle":
                    cam.on_mouse_up()
                elif e.kind == "wheel":
                    cam.on_scroll(e.dy)
        new_changes = []
        chunk, physics, ego, scene = self.managers
        with span("world.managers"):
            with span("world.chunk"):
                new_changes.extend(self._update(chunk, extent))
            with span("world.physics"):
                new_changes.extend(self._update(physics, extent))
            with span("world.ego"):
                new_changes.extend(self._update(ego, extent))
            with span("world.scene"):
                new_changes.extend(self._update(scene, extent))

        self.events_since_last_step = []
        with span("world.entity_table"):
            self.update_entity_table(new_changes)
        self.changes_since_last_step = new_changes

        basis = self.camera.eye_front_right_up()
        prefs = self.camera.rendering_preferences()

        if not self.headless and self.renderer is not None:
            if isinstance(self.renderer, Renderer) \
                    and self.renderer.settings.trace_audit:
                self.last_image, self.last_aux = self.renderer.render(
                    self.scene, basis, prefs, frame_count=self.frame_count,
                    with_aux=True,
                )
            else:
                self.last_image = self.renderer.render(
                    self.scene, basis, prefs, frame_count=self.frame_count
                )
            if prefs.should_screenshot:
                self._save_screenshot(self.last_image)
                self.camera.set_rendering_preferences(
                    replace(prefs, should_screenshot=False)
                )
        self.frame_count += 1

    def _save_screenshot(self, image: np.ndarray) -> None:
        """Auto-numbered PNG (reference game_world.rs:303-339)."""
        from wavefront_tpu_torch.render.screenshot import save_png, next_screenshot_path

        path = next_screenshot_path(self.screenshot_dir)
        save_png(path, image)
