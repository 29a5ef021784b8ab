"""wavefront_tpu_torch — the wavefront voxel path tracer in PyTorch and CUDA.

The same renderer as `wavefront_tpu` (the JAX package, which stays the
reference), written for one NVIDIA Hopper GPU: plain tensor code is PyTorch,
and each TPU kernel of the JAX package and its tools is a CUDA C++ kernel
written by hand (`csrc/*.cu`), built by `nvcc` at first use and bound with
`ctypes` (`kernels/_build.py`):

  - K1 `kernels.window_trace`: each ray's first voxel-face crossing (the
    DDA over the dense uint8 grid and its aux grid), packed hit words;
  - K2 `kernels.shade`: the whole per-ray shade (texels, 3-way scatter,
    dense light-BVH NEE, the NEE pdf sweep, the throughput/radiance
    fold), with an optional stream of entity-triangle hits and a bf16
    color build;
  - K3 `kernels.texel`: the atlas texel fetch of the general (non-fused)
    shade path, which serves sparse light sets and the stage-isolation
    variants;
  - K4 `kernels.radix_hist`: the 256-bin digit histogram of uint32 keys;
  - K5 `kernels.loop_probe`, K6 `kernels.extract_probe` and K7
    `kernels.device_probe`: the TPU tools' probes (`tools/`).

Every kernel has a plain PyTorch version beside it; a wrapper takes the
plain version only for tensors on the CPU (the tests) and launches the
kernel, or raises, for tensors on the card.  The chunk generator's C++
source (`csrc/worldgen.cpp`) is built with the host compiler.

Layers, entry point first:

  - `app.main` (the frame loop of the game, fps log, screenshots,
    accumulation) and `app.viewer` (frames to a browser, input back);
  - `world.game_world.GameWorld`: chunk streaming, physics, ego
    controls and the scene manager around one render a step;
  - `parallel.mesh.DistributedRenderer`: a frame as pixel ranges over
    several devices;
  - `render.renderer.Renderer`: one frame per `render` call;
  - `render.scene.VoxelScene`: the grid, the block tables, the atlas, the
    light set and the entity triangle pool as tensors on one device;
  - `kernels`: the seven CUDA kernels and their build;
  - `utils`: checkpoints, frame and stage timers, a device trace, and
    the validation layer; `headline` and `tools`: the measured
    workloads and the labs.

The entry points run on the card unless the caller asks for the CPU.
This package imports neither `jax` nor anything of `wavefront_tpu`.
"""

from wavefront_tpu_torch.core.config import (
    RenderSettings,
    RenderingPreferences,
    WorldSettings,
)

__version__ = "0.1.0"

_LAZY = {
    "Renderer": "wavefront_tpu_torch.render.renderer",
    "DistributedRenderer": "wavefront_tpu_torch.parallel.mesh",
    "VoxelScene": "wavefront_tpu_torch.render.scene",
    "GameWorld": "wavefront_tpu_torch.world.game_world",
    "BlockRegistry": "wavefront_tpu_torch.world.blocks",
    "SphericalCamera": "wavefront_tpu_torch.core.camera",
}


def __getattr__(name):
    # lazy re-exports of the heavyweight layers, imported when first
    # touched
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)


__all__ = [
    "RenderSettings",
    "RenderingPreferences",
    "WorldSettings",
    "Renderer",
    "DistributedRenderer",
    "VoxelScene",
    "GameWorld",
    "BlockRegistry",
    "SphericalCamera",
    "__version__",
]
