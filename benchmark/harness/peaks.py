"""The card's peaks and the kernels' byte counts.

Published peaks of one NVIDIA H100 SXM at its full 700 W power limit
(NVIDIA's data sheet): 3.35 TB/s of HBM3.  A card set below 700 W runs
slower under load; every run states the card's power limit beside its
numbers.  The counts copy the arithmetic of the repository's
`chip_smoke.py` (`shade_bound_ms`): what one launch's inputs need, each
byte read once and each byte written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# K2 (the fused shade): per ray 16 words in and 12 out (origin,
# direction, hit words, t, throughput, radiance, ray id; the next ray,
# throughput and radiance back); the bf16 build moves the throughput's 3
# components in 2 bytes each way
K2_BYTES_PER_RAY = 112
K2_BF16_BYTES_PER_RAY = 100
# with the entity stream the flag word is read on every ray (the other
# 11 words only on the lanes an entity wins, which only the device knows:
# left out, so the count is a floor)
K2_STREAM_BYTES_PER_RAY = 4


def k2_bytes(rays: int, table_bytes: int, bf16: bool = False,
             stream: bool = False) -> int:
    """Bytes one K2 launch over `rays` rays must move: the rays, the
    entity stream's flag words, and the atlas and light tables once."""
    per = K2_BF16_BYTES_PER_RAY if bf16 else K2_BYTES_PER_RAY
    return rays * (per + (K2_STREAM_BYTES_PER_RAY if stream else 0)) \
        + table_bytes
