"""levelsetfusion_tpu_torch — the PyTorch + CUDA port of ``levelsetfusion_tpu``.

The JAX package beside this one is the reference: every module here has a
twin at the same relative path there, and the tests hold each against its
twin on the same seeded inputs. This package imports ``torch`` and numpy and
never ``jax``.

Layout (same subpackages as the JAX package):

- ``core``          — grid specs, camera models
- ``io``            — synthetic depth data
- ``ops``           — TSDF generation (BASIC and EWA), derivatives,
                      interpolation, energy terms, Sobolev filtering,
                      gradient assembly, pyramids (plain torch), and
                      ``ops.kernels``: the hand-written CUDA kernels of the
                      solve loop with their plain twins
- ``models``        — solver parameters, the single-level warp solve (2D
                      and 3D), the hierarchical solve, rigid SDF-2-SDF and
                      the fusion
- ``utils``         — experiment configs, telemetry and checkpoints
- ``cli``           — the experiment runner

Layouts follow the JAX package: fields are ``(*spatial,)`` float32, warps
``(*spatial, D)`` in voxel units; inside the solve loop the warp is
component-major ``(D, *spatial)``.
"""

import torch

__version__ = "0.1.0"

# Full-f32 matmuls and convolutions everywhere in the port. TF32 keeps ~10
# mantissa bits; the JAX reference measured what reduced-precision matmuls do
# to this pipeline (levelsetfusion_tpu/core/camera.py: bf16 passes shifted
# depth-image sample positions and pushed rigid pose recovery error from 2e-4
# to 0.117). TF32 is the same trap on an NVIDIA card, so it stays off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from levelsetfusion_tpu_torch.core.grid import GridSpec  # noqa: E402,F401
