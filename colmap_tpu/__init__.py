"""colmap_tpu — a Structure-from-Motion / Multi-View Stereo framework in JAX.

A from-scratch re-design of the COLMAP pipeline (reference: COLMAP
3.11.0.dev0) as batched accelerator programs:

- All geometry/estimation math is written as batched, shape-static JAX
  programs that vmap/jit/shard cleanly (dense GEMMs, lax control flow,
  fixed-capacity padding + masks instead of dynamic shapes).
- RANSAC is a *batched* hypothesis sweep (thousands of minimal problems
  solved in one program) instead of the reference's sequential trial loop
  (reference: src/colmap/optim/ransac.h).
- Bundle adjustment is a batched Levenberg-Marquardt with a matrix-free
  Schur-complement CG solver that shards over device meshes with psum
  collectives, replacing ceres (reference:
  src/colmap/estimators/bundle_adjustment.cc).
- The host orchestrates (incremental mapping decisions); the device does
  batched math.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry and estimation code needs true f32 matrix products: on the GPU
# JAX's default lets an f32 matmul run in TF32 (about three decimal
# digits), which destroys the conditioning of DLT/SVD-based minimal solvers
# and of the BA normal equations. Products that are exact in a narrower
# type (the descriptor matcher's centered uint8 operands) state their own
# operand types where they are called.
_jax.config.update("jax_default_matmul_precision", "highest")

from colmap_tpu.util.compile_cache import setup_compile_cache as _setup_cache

_setup_cache()
