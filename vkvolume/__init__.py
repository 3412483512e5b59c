"""vkvolume — accelerated volume renderer in JAX.

A ground-up JAX/XLA re-design of the capabilities of LDeakin/VkVolume
(*Accelerated Volume Rendering with Chebyshev Distance Maps*, Deakin &
Knackstedt, SIGGRAPH Asia 2019): ray-casting with empty-space skipping via
occupancy / Chebyshev-distance maps, early ray termination, 2D
intensity×gradient transfer functions, camera-inside-volume and depth-buffer
clipping — with volumes and acceleration structures as device-resident
arrays, the acceleration pipeline as jitted scan/stencil passes, and the
frame as a masked lock-step XLA ray march or plane sweep.
"""

__version__ = "0.1.0"

import jax as _jax

# Every camera projection in the frame path is a tiny (N,4)@(4,4) matmul.
# On an NVIDIA GPU, XLA may run f32 dots at DEFAULT precision on the tensor
# cores in TF32, which keeps ~3 decimal digits: ray directions would bend
# by ~1e-3, moving sample positions by a sizeable fraction of a voxel at
# full-scale extents and breaking pixel parity with the reference on sharp
# (gradient-TF) content. The products are far too small for the tensor
# cores to matter, so force true-f32 matmuls package-wide.
_jax.config.update("jax_default_matmul_precision", "highest")
