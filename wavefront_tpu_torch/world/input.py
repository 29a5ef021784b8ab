"""Polled user-input state (reference src/handle_user_input.rs).

The counterpart of `wavefront_tpu.world.input`, host code as there.

Framework-agnostic: the interactive app feeds `Event` records (key up/down,
mouse move/button/wheel); managers poll `current` state and edge-triggered
helpers, mirroring `UserInputState::key_pressed/last_key_pressed`
(handle_user_input.rs:57-135).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Event:
    kind: str                 # "key_down" | "key_up" | "mouse_move" |
                              # "mouse_down" | "mouse_up" | "wheel"
    key: Optional[str] = None  # e.g. "w", "space", "shift", "tab", "1".."9",
                               # "n", "b", "o", "print_screen"
    x: float = 0.0
    y: float = 0.0
    button: Optional[str] = None  # "left" | "right" | "middle"
    dy: float = 0.0


@dataclass
class CurrentState:
    w: bool = False
    a: bool = False
    s: bool = False
    d: bool = False
    space: bool = False
    shift: bool = False
    mouse_left_down: bool = False
    mouse_right_down: bool = False
    mouse_middle_down: bool = False
    pos: tuple = (0.0, 0.0)


class UserInputState:
    def __init__(self):
        self.current = CurrentState()

    def handle_input(self, events: List[Event]) -> None:
        c = self.current
        for e in events:
            if e.kind == "key_down":
                if hasattr(c, e.key or ""):
                    setattr(c, e.key, True)
            elif e.kind == "key_up":
                if hasattr(c, e.key or ""):
                    setattr(c, e.key, False)
            elif e.kind == "mouse_move":
                c.pos = (e.x, e.y)
            elif e.kind == "mouse_down":
                if e.button == "left":
                    c.mouse_left_down = True
                elif e.button == "right":
                    c.mouse_right_down = True
                elif e.button == "middle":
                    c.mouse_middle_down = True
            elif e.kind == "mouse_up":
                if e.button == "left":
                    c.mouse_left_down = False
                elif e.button == "right":
                    c.mouse_right_down = False
                elif e.button == "middle":
                    c.mouse_middle_down = False

    @staticmethod
    def key_pressed(events: List[Event], key: str) -> bool:
        """Edge trigger: was `key` pressed in this batch
        (reference handle_user_input.rs:95-107)."""
        return any(e.kind == "key_down" and e.key == key for e in events)

    @staticmethod
    def last_key_pressed(events: List[Event], keys: List[str]) -> Optional[str]:
        """Last of `keys` pressed in this batch (handle_user_input.rs:109-135)."""
        last = None
        for e in events:
            if e.kind == "key_down" and e.key in keys:
                last = e.key
        return last
