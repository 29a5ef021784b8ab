"""Cameras (reference src/camera.rs), in numpy: the counterpart of
`wavefront_tpu.core.camera`.

`Camera` yields the (eye, front, right, up) basis
consumed by raygen (reference raygen.rs:103-114); `SphericalCamera` orbits a
root point with middle-drag yaw/pitch (clamped to +/-89 deg) and wheel zoom
(reference camera.rs:74-204).  World-up is (0,-1,0) (camera.rs:103), so
screen-down maps to world +y, matching the reference's y-down convention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from wavefront_tpu_torch.core.config import RenderingPreferences


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def dir_vecs(worldup: np.ndarray, pitch: float, yaw: float):
    """Front/right/up basis from yaw+pitch (reference camera.rs:22-34)."""
    front = _normalize(
        np.array(
            [
                math.cos(yaw) * math.cos(pitch),
                math.sin(pitch),
                math.sin(yaw) * math.cos(pitch),
            ],
            dtype=np.float32,
        )
    )
    right = _normalize(np.cross(front, worldup))
    up = _normalize(np.cross(right, front))
    return front, right, up


@dataclass
class CameraBasis:
    eye: np.ndarray
    front: np.ndarray
    right: np.ndarray
    up: np.ndarray


class Camera:
    """Camera protocol (reference camera.rs:60-71)."""

    def eye_front_right_up(self) -> CameraBasis:
        raise NotImplementedError

    def rendering_preferences(self) -> RenderingPreferences:
        raise NotImplementedError

    def set_rendering_preferences(self, prefs: RenderingPreferences) -> None:
        raise NotImplementedError

    def set_root_position(self, pos) -> None:
        raise NotImplementedError

    def set_root_rotation(self, yaw: float) -> None:
        """Rotation of the camera's root point about +y (the reference takes
        a full quaternion, camera.rs:139-141; bodies here are y-locked)."""
        raise NotImplementedError


@dataclass
class SphericalCamera(Camera):
    """Orbit camera (reference camera.rs:74-204)."""

    root_pos: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    worldup: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], dtype=np.float32)
    )
    offset: float = 5.0
    pitch: float = 0.0
    yaw: float = 0.0
    root_yaw: float = 0.0
    prefs: RenderingPreferences = field(default_factory=RenderingPreferences)

    # drag state (reference camera.rs:91-95)
    _mouse_down: bool = False
    _mouse_prev: tuple = (0.0, 0.0)

    def eye_front_right_up(self) -> CameraBasis:
        front, right, up = dir_vecs(self.worldup, self.pitch, self.yaw)
        if self.root_yaw != 0.0:
            # compose the root rotation (reference camera.rs:118-125)
            c, s = math.cos(self.root_yaw), math.sin(self.root_yaw)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            front, right, up = rot @ front, rot @ right, rot @ up
        eye = self.root_pos - self.offset * front
        return CameraBasis(eye=eye.astype(np.float32), front=front, right=right, up=up)

    def rendering_preferences(self) -> RenderingPreferences:
        return self.prefs

    def set_rendering_preferences(self, prefs: RenderingPreferences) -> None:
        self.prefs = prefs

    def set_root_position(self, pos) -> None:
        self.root_pos = np.asarray(pos, dtype=np.float32)

    def set_root_rotation(self, yaw: float) -> None:
        self.root_yaw = float(yaw)

    # --- interactive handlers (reference camera.rs:144-203) ---

    def on_mouse_down(self) -> None:
        self._mouse_down = True

    def on_mouse_up(self) -> None:
        self._mouse_down = False

    def on_mouse_move(self, norm_x: float, norm_y: float) -> None:
        """norm_* are trackball-normalized coords (reference utils.rs:211-215)."""
        px, py = self._mouse_prev
        self._mouse_prev = (norm_x, norm_y)
        if self._mouse_down:
            self.yaw -= (norm_x - px) * 2.0
            self.pitch -= (norm_y - py) * 2.0
            limit = math.radians(89.0)
            self.pitch = max(-limit, min(limit, self.pitch))

    def on_scroll(self, dy: float) -> None:
        self.offset -= dy


def normalized_mouse_coords(x: float, y: float, extent) -> tuple:
    """Trackball normalization (reference utils.rs:211-215)."""
    w, h = extent
    radius = float(min(w, h))
    return ((x - w / 2.0) / radius, (y - h / 2.0) / radius)


def screen_to_uv(x: float, y: float, extent) -> tuple:
    """Screen pixel -> NDC uv in [-1,1] (reference utils.rs:217-221)."""
    w, h = extent
    return (2.0 * x / w - 1.0, 2.0 * y / h - 1.0)
