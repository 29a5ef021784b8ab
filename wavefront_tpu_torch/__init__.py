"""wavefront_tpu_torch — the wavefront voxel path tracer in PyTorch and CUDA.

The same renderer as `wavefront_tpu` (the JAX package, which stays the
reference), written for one NVIDIA Hopper GPU: plain tensor code is PyTorch,
and the two kernels on the frame's hot path are CUDA C++ written by hand
(`csrc/`), built by `nvcc` at first use and bound with `ctypes`:

  - `kernels.window_trace`: each ray's first voxel-face crossing (the DDA
    over the dense uint8 grid), packed into the tracer's hit words;
  - `kernels.shade`: the whole per-ray shade (texels, 3-way scatter, dense
    light-BVH NEE, the NEE pdf sweep, the throughput/radiance fold).

Every kernel has a plain PyTorch version beside it; a wrapper takes the
plain version only for tensors on the CPU (the tests) and launches the
kernel, or raises, for tensors on the card.

Layers, entry point first:

  - `headline`: the headline scene, pose and settings;
  - `render.renderer.Renderer`: one frame per `render` call;
  - `render.scene.VoxelScene`: the grid, the block tables, the atlas and
    the light set as tensors on one device;
  - `kernels`: the two CUDA kernels and their build.

This package imports neither `jax` nor anything of `wavefront_tpu`.
"""

from wavefront_tpu_torch.core.config import (
    RenderSettings,
    RenderingPreferences,
    WorldSettings,
)

__all__ = ["RenderSettings", "RenderingPreferences", "WorldSettings"]
__version__ = "0.1.0"
