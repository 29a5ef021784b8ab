"""wavefront_tpu_torch — the wavefront voxel path tracer in PyTorch and CUDA.

The same renderer as `wavefront_tpu` (the JAX package, which stays the
reference), written for one NVIDIA Hopper GPU: plain tensor code is PyTorch,
and the three kernels of the frame are CUDA C++ written by hand (`csrc/`),
built by `nvcc` at first use and bound with `ctypes`:

  - `kernels.window_trace`: each ray's first voxel-face crossing (the DDA
    over the dense uint8 grid), packed into the tracer's hit words;
  - `kernels.shade`: the whole per-ray shade (texels, 3-way scatter, dense
    light-BVH NEE, the NEE pdf sweep, the throughput/radiance fold), with
    an optional stream of entity-triangle hits;
  - `kernels.texel`: the atlas texel fetch of the general (non-fused)
    shade path, which serves sparse light sets and the stage-isolation
    variants.

Every kernel has a plain PyTorch version beside it; a wrapper takes the
plain version only for tensors on the CPU (the tests) and launches the
kernel, or raises, for tensors on the card.

Layers, entry point first:

  - `headline`: the headline and general scenes, poses and settings;
  - `render.renderer.Renderer`: one frame per `render` call;
  - `render.scene.VoxelScene`: the grid, the block tables, the atlas, the
    light set and the entity triangle pool as tensors on one device;
  - `kernels`: the three CUDA kernels and their build.

This package imports neither `jax` nor anything of `wavefront_tpu`.
"""

from wavefront_tpu_torch.core.config import (
    RenderSettings,
    RenderingPreferences,
    WorldSettings,
)

__all__ = ["RenderSettings", "RenderingPreferences", "WorldSettings"]
__version__ = "0.1.0"
