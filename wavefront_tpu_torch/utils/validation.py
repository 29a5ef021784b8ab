"""Validation-layer analog.

The reference keeps the Khronos validation layer always on as its de facto
correctness/race checker (reference main.rs:216-219; SURVEY.md section 5).
The remaining failure modes of a tensor program are numeric (NaN
propagation) and out-of-bounds gathers; this module is the debug switch
for the first, and `check_image` the check of a finished frame.

The counterpart of `wavefront_tpu.utils.validation`.  `nan_checks` plays
`jax_debug_nans`: a `TorchDispatchMode` looks at the output of every
tensor op run inside the context and raises FloatingPointError, naming
the op, at the first NaN.  The CUDA kernels launch through `ctypes`,
which no dispatch mode sees, so each kernel's wrapper checks its own
outputs after its launch (`kernels._build.check_outputs`) and runs its
plain version as one checked op (`kernels._build.plain`): a kernel is
one op on the CPU as on the card.  Outside the context the mode is off
and the wrappers' checks cost one flag read.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from wavefront_tpu_torch.kernels import _build

_aten = torch.ops.aten
# ops whose output is uninitialized memory, written later by a kernel or
# an indexed store: their bytes are not values yet
_UNINITIALIZED = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                  _aten.new_empty, _aten.new_empty_strided}


class _NanMode(TorchDispatchMode):
    """Raise FloatingPointError at the first op whose floating output
    holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func.overloadpacket not in _UNINITIALIZED
                and not _build.nan_checks_paused()):
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def validation_layer(nan_checks: bool = True, interpret: bool = False):
    """Enable heavy runtime checks for the enclosed code.

    nan_checks: raise FloatingPointError, naming the op or the kernel,
                when an op or a kernel inside the context makes a NaN.
    interpret:  accepted and ignored: the JAX package turns off jit here
                so that Python debugging works inside the render path;
                the port runs eagerly and has no jit to turn off.
    """
    mode = _NanMode() if nan_checks else contextlib.nullcontext()
    if nan_checks:
        _build.set_nan_checks(True)
    try:
        with mode:
            yield
    finally:
        if nan_checks:
            _build.set_nan_checks(False)


def check_image(img, what: str = "image") -> None:
    """Assert a rendered image is finite and plausibly sized."""
    a = np.asarray(img)
    if not np.all(np.isfinite(a)):
        bad = int(np.size(a) - np.isfinite(a).sum())
        raise FloatingPointError(f"{what}: {bad} non-finite values")
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"{what}: unexpected shape {a.shape}")
