"""The tolerances every card test of the port holds a kernel or a frame
to, stated once:

  tracer     at most 1e-5 of the rays differ from the plain version in a
             hit word or t (the coplanar-tie class of docs/PARITY.md), both
             from its skipping march and from its unskipped one (a skip's
             landing may fall a voxel off the exact path beside a grazed
             edge); no ray truncated;
  shade      every output within max |diff| 1e-3 and RMS 1e-5; in the bf16
             color build tp within 1 bfloat16 ulp and radiance within 1
             bfloat16 ulp of its term tp * emission (a float32 value that
             cos, sin, log or exp round an ulp apart in CUDA and PyTorch
             may cross a bfloat16 rounding boundary);
  texel      equal: a fetch copies float32 values;
  NEE sweep  crossings and overflowing rays equal, a ray with one crossing
             (or none) bit for bit, a ray with more within 1e-6 relative
             (its slots summed in slot order, the plain version's by
             PyTorch's reduction); a ray along its surface (cos_theta 0)
             that crosses a lamp, whose pdf is infinite or NaN, the same;
  light walk success and prim equal on every ray, probability and
             importance bit for bit (NaN where the plain walk's is NaN);
  triangle sweep  hit, t and slot bit for bit on every ray, barycentrics
             on every hit ray; its stream form's merged t and flag word on
             every ray and its other 11 words on every ray an entity wins
             (the words K2 reads);
  images     the golden gate: under 0.5% of the pixels diverge (max-channel
             |diff| over 1e-3) and the RMSE over the rest is under 1e-3; a
             sort schedule's image within max |diff| 1e-5 of the
             every-bounce sort's (no per-ray result depends on ray order);
  batches, edits, recentres, checkpoints, sorts: equal bit for bit (no
             per-ray result depends on how the scene arrays were built).

    from _card import bf16_ulp, golden_gate, same_bits
"""

import numpy as np
import torch

# the NEE sweep's relative tolerance on a ray with more than one crossing
NEE_REL = 1e-6


def golden_gate(got, want):
    got, want = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                 for x in (got, want))
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    agree = diff < 1e-3
    assert 1.0 - agree.mean() < 0.005, f"{1 - agree.mean():.4%} diverge"
    assert np.sqrt(np.mean((got[agree] - want[agree]) ** 2)) < 1e-3


def bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


def same_bits(got, want) -> bool:
    """Equal dtypes and values on every element, NaN where the other is
    NaN (the light walk's tolerance)."""
    return got.dtype == want.dtype and bool(
        ((got == want) | ((got != got) & (want != want))).all())
