"""Chunk coordinate helpers (reference src/game_system/chunk.rs:13-47); the
counterpart of `wavefront_tpu.world.chunk`."""

from __future__ import annotations

import numpy as np

CHUNK_SIZE = 32  # reference chunk.rs:13-15 (X = Y = Z = 32)


def floor_coords(p) -> np.ndarray:
    """Float world position -> integer block coords (reference chunk.rs:25-31)."""
    return np.floor(np.asarray(p, np.float64)).astype(np.int64)


def global_to_chunk_coords(g, chunk_size: int = CHUNK_SIZE):
    """Block coords -> (chunk coords, in-chunk coords) (reference chunk.rs:33-47)."""
    g = np.asarray(g, np.int64)
    c = np.floor_divide(g, chunk_size)
    b = g - c * chunk_size
    return c, b
