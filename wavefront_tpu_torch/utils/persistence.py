"""World checkpoint / resume.

The reference has no persistence: world state regenerates from the noise
seed and edits are lost on exit (SURVEY.md section 5).  Here the full
mutable state — edited chunks, entity table, camera pose, frame counter —
round-trips through one .npz file, because the state is just arrays.

The counterpart of `wavefront_tpu.utils.persistence`, with the same file
format key for key and dtype for dtype (`__meta__` JSON bytes, edited
chunks as `chunk_x_y_z` uint8, entity meshes as `mesh_<id>_verts|uv|tex`),
so a save made by either package loads in the other.  The world's device
window is rebuilt from the restored chunks on the next step
(`_window_dirty`).
"""

from __future__ import annotations

import json

import numpy as np

from wavefront_tpu_torch.core.config import RenderingPreferences
from wavefront_tpu_torch.world.game_world import (
    Entity,
    EntityCreationData,
    EntityPhysicsData,
    GameWorld,
    GlobalEntityAdd,
    Mesh,
)


def save_world(world: GameWorld, path: str) -> None:
    chunk_mgr = world.managers[0]
    arrays = {}
    meta = {
        "frame_count": world.frame_count,
        "camera": {
            "root_pos": [float(x) for x in world.camera.root_pos],
            "yaw": float(world.camera.yaw),
            "pitch": float(world.camera.pitch),
            "offset": float(world.camera.offset),
        },
        "center_chunk": list(chunk_mgr.center_chunk),
        "edited_chunks": [],
        "entities": [],
    }
    for key in getattr(chunk_mgr, "edited", set()):
        name = f"chunk_{key[0]}_{key[1]}_{key[2]}"
        if key in chunk_mgr.chunks:
            arrays[name] = chunk_mgr.chunks[key]
            meta["edited_chunks"].append(list(key))

    for eid, ent in world.entities.items():
        rec = {"id": int(eid), "isometry": ent.isometry.tolist()}
        if ent.physics_data is not None:
            p = ent.physics_data
            rec["physics"] = {
                "rigid_body_type": p.rigid_body_type,
                "half_extents": [float(x) for x in p.half_extents],
                "linvel": [float(x) for x in p.linvel],
                "angvel": [float(x) for x in p.angvel],
                "controlled": bool(p.controlled),
                "grounded": bool(p.grounded),
                "mass": float(p.mass),
            }
        if ent.mesh is not None:
            arrays[f"mesh_{eid}_verts"] = ent.mesh.verts
            arrays[f"mesh_{eid}_uv"] = ent.mesh.uv
            arrays[f"mesh_{eid}_tex"] = ent.mesh.tex
            rec["has_mesh"] = True
        meta["entities"].append(rec)

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_world(world: GameWorld, path: str) -> None:
    """Restore a checkpoint into a freshly constructed GameWorld."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())

    world.frame_count = meta["frame_count"]
    cam = meta["camera"]
    world.camera.set_root_position(cam["root_pos"])
    world.camera.yaw = cam["yaw"]
    world.camera.pitch = cam["pitch"]
    world.camera.offset = cam["offset"]

    chunk_mgr = world.managers[0]
    chunk_mgr.center_chunk = tuple(meta["center_chunk"])
    for key in meta["edited_chunks"]:
        key = tuple(key)
        chunk_mgr.chunks[key] = data[f"chunk_{key[0]}_{key[1]}_{key[2]}"]
        chunk_mgr.edited.add(key)
    chunk_mgr._window_dirty = True

    world.entities.clear()
    for rec in meta["entities"]:
        phys = None
        if "physics" in rec:
            p = rec["physics"]
            phys = EntityPhysicsData(
                rigid_body_type=p["rigid_body_type"],
                half_extents=np.array(p["half_extents"], np.float32),
                linvel=np.array(p["linvel"], np.float32),
                angvel=np.array(p["angvel"], np.float32),
                controlled=p["controlled"],
                grounded=p["grounded"],
                mass=p["mass"],
            )
        mesh = None
        if rec.get("has_mesh"):
            eid = rec["id"]
            mesh = Mesh(
                verts=data[f"mesh_{eid}_verts"],
                uv=data[f"mesh_{eid}_uv"],
                tex=data[f"mesh_{eid}_tex"],
            )
        iso = np.array(rec["isometry"], np.float32)
        cdata = EntityCreationData(mesh=mesh, isometry=iso, physics=phys)
        world.entities[rec["id"]] = Entity(
            mesh=mesh, isometry=iso, physics_data=phys
        )
        world.changes_since_last_step.append(GlobalEntityAdd(rec["id"], cdata))
