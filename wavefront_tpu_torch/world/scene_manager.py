"""Scene manager: mirrors entity world changes into the render scene
(reference src/game_system/scene_manager.rs:22-44); the counterpart of
`wavefront_tpu.world.scene_manager`."""

from __future__ import annotations

from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world.game_world import (
    GlobalEntityAdd,
    GlobalEntityRemove,
    GlobalEntityUpdateIsometry,
    Manager,
    UpdateData,
)


class SceneManager(Manager):
    def __init__(self, scene: VoxelScene):
        self.scene = scene

    def update(self, data: UpdateData) -> list:
        for ch in data.world_changes:
            if isinstance(ch, GlobalEntityAdd):
                if ch.data.mesh is not None:
                    self.scene.add_object(
                        ch.id,
                        ch.data.mesh.verts,
                        ch.data.mesh.uv,
                        ch.data.mesh.tex,
                        transform=ch.data.isometry,
                    )
            elif isinstance(ch, GlobalEntityRemove):
                self.scene.remove_object(ch.id)
            elif isinstance(ch, GlobalEntityUpdateIsometry):
                if ch.id in self.scene._entities:
                    self.scene.update_object(ch.id, ch.isometry)
        return []
