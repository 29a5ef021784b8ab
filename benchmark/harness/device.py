"""The card and the host a run stands on, and the modules it may not load."""

from __future__ import annotations

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "wavefront_tpu")


# glibc mallopt parameters
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_MMAP_THRESHOLD_MAX = 32 << 20    # glibc's largest on 64-bit hosts
_TRIM_THRESHOLD = 1 << 30


def steady_allocator() -> bool:
    """Keep the host allocator from returning large blocks to the kernel:
    blocks up to 32 MiB come from the heap, and the heap is not trimmed
    below 1 GiB of free space.  A frame hands back a 25 MB host image;
    with glibc's defaults whether that block is a fresh mapping (page
    faults while the copy fills it, 2-10 ms) or reused memory changes
    from host to host and run to run.  Returns whether glibc took both
    settings (False on another C library)."""
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        return bool(libc.mallopt(_M_MMAP_THRESHOLD, _MMAP_THRESHOLD_MAX)
                    and libc.mallopt(_M_TRIM_THRESHOLD, _TRIM_THRESHOLD))
    except (OSError, AttributeError):
        return False


def forbidden_modules(modules=None) -> set:
    """Top-level names (the part before the first dot, compared whole)
    of loaded modules that belong to JAX or the JAX package."""
    names = sys.modules if modules is None else modules
    return {m.split(".")[0] for m in names} & set(FORBIDDEN)


def require_cards(chips: int) -> None:
    """Exit nonzero, printing no result, without `chips` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {chips}")


def _smi(fields: str) -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [[v.strip() for v in line.split(",")]
            for line in out.strip().splitlines()]


def describe_card() -> dict:
    """The card's name, power limit and draw, clocks and temperature,
    and the host's CPU count and load, for reading a run's noise."""
    keys = ("name", "power.limit", "power.draw", "clocks.sm",
            "clocks.max.sm", "clocks.mem", "temperature.gpu")
    rows = _smi(",".join(keys))
    return {"cards": [dict(zip(keys, r)) for r in rows],
            "host": {"cpus": os.cpu_count(), "loadavg": os.getloadavg()}}


def versions() -> dict:
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def after_window(device: str, chips: int) -> dict:
    """The result's `device`, its memory peak read before the reference
    runs."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    torch.cuda.synchronize()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def free(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
