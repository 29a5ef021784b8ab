"""The measured window: one host-clock reading at each image's end.

An image ends when the call returns with it on the host; the harness
adds no synchronize.  An image is one frame, or the mean of k frames
(`frames_per_image` in the traffic), and every time is given a frame:
the rate is all the time of the window over all the frames rendered in
it, and the tail is over every image interval, each over its k frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class Window:
    t_open: float      # perf_counter at the window's start
    ends: list         # perf_counter at each image's end, in order
    setup_s: float     # process start to window open
    k: int = 1         # frames an image

    @property
    def images(self) -> int:
        return len(self.ends)

    @property
    def frames(self) -> int:
        return self.k * len(self.ends)

    @property
    def seconds(self) -> float:
        return self.ends[-1] - self.t_open if self.ends else 0.0

    def intervals(self) -> list:
        prev, out = self.t_open, []
        for t in self.ends:
            out.append(t - prev)
            prev = t
        return out

    def mean_ms(self) -> float:
        """Window seconds over frames rendered, in ms."""
        return 1e3 * self.seconds / self.frames

    def quantile_ms(self, q: float) -> float:
        """The q-quantile of every image interval (nearest rank), over
        its k frames, in ms."""
        iv = sorted(self.intervals())
        return 1e3 * iv[max(0, math.ceil(q * len(iv)) - 1)] / self.k
