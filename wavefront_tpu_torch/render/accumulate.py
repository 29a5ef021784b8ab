"""Temporal accumulation (ladder config 5).

Counterpart of `wavefront_tpu.render.accumulate.TemporalAccumulator`: a
running-mean buffer over successive frames.  A frame's random numbers are
seeded by its frame count, so while the camera holds still the mean of
frames with different counts converges on the image; a change of camera
or scene (a new `key`) starts the history over.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class TemporalAccumulator:
    def __init__(self):
        self._accum: Optional[torch.Tensor] = None
        self._samples = 0
        self._key = None

    @property
    def samples(self) -> int:
        return self._samples

    def add(self, img, key=None) -> torch.Tensor:
        """Fold a new frame in (a tensor, or anything `torch.as_tensor`
        takes); `key` is any hashable fingerprint of the state (camera
        pose, prefs): a change resets the history.  Returns the running
        mean, on the frame's device."""
        if key is not None and key != self._key:
            self._key = key
            self._accum = None
            self._samples = 0
        img = torch.as_tensor(img)
        if self._accum is None or self._accum.shape != img.shape:
            self._accum = img
            self._samples = 1
        else:
            self._accum = self._accum + (img - self._accum) / (
                float(self._samples) + 1.0)
            self._samples += 1
        return self._accum

    def image(self) -> Optional[np.ndarray]:
        if self._accum is None:
            return None
        return self._accum.cpu().numpy()
