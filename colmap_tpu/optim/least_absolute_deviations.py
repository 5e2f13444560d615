"""Least absolute deviations (L1) linear solver via IRLS.

Reference: src/colmap/optim/least_absolute_deviations.h — used by the
coordinate-frame/Manhattan-world estimation. This form is a fixed-
iteration IRLS loop (each iteration one weighted least-squares solve, all
batched linear algebra), fully jittable.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class LADOptions:
    max_num_iterations: int = 30
    eps: float = 1e-6  # IRLS weight floor (|r| clamp)


@functools.partial(jax.jit, static_argnums=(2,))
def solve_lad(A: jax.Array, b: jax.Array,
              options: LADOptions = LADOptions()) -> jax.Array:
    """argmin_x ||A x - b||_1 via iteratively reweighted least squares."""
    m, n = A.shape

    def ls(w):
        Aw = A * w[:, None]
        H = Aw.T @ A + 1e-10 * jnp.eye(n, dtype=A.dtype)
        return jnp.linalg.solve(H, Aw.T @ b)

    x = ls(jnp.ones(m, A.dtype))

    def step(x, _):
        r = A @ x - b
        w = 1.0 / jnp.maximum(jnp.abs(r), options.eps)
        return ls(w), None

    x, _ = jax.lax.scan(step, x, None, length=options.max_num_iterations)
    return x
