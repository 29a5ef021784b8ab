"""Cameras (reference src/camera.rs), in numpy.

`SphericalCamera` orbits a root point; `eye_front_right_up` yields the
(eye, front, right, up) basis consumed by raygen.  World-up is (0,-1,0)
(camera.rs:103), so screen-down maps to world +y.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


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


@dataclass
class SphericalCamera:
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

    def eye_front_right_up(self) -> CameraBasis:
        front, right, up = dir_vecs(self.worldup, self.pitch, self.yaw)
        if self.root_yaw != 0.0:
            # compose the root rotation (reference camera.rs:118-125)
            c, s = math.cos(self.root_yaw), math.sin(self.root_yaw)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            front, right, up = rot @ front, rot @ right, rot @ up
        eye = self.root_pos - self.offset * front
        return CameraBasis(
            eye=eye.astype(np.float32), front=front, right=right, up=up
        )

    def set_root_position(self, pos) -> None:
        self.root_pos = np.asarray(pos, dtype=np.float32)
