"""Shared estimator helpers (batched, f32-safe).

Reference: src/colmap/estimators/utils.h — point centering/normalization for
DLT-style solvers (essential for float32 conditioning).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_points(pts: jax.Array, weights: jax.Array | None = None):
    """Hartley isotropic normalization.

    pts: (..., N, 2). Returns (pts_norm, T (3, 3)) with T mapping original ->
    normalized homogeneous coordinates: centered and scaled to mean distance
    sqrt(2) (weighted variant for LO refits).
    """
    if weights is None:
        w = jnp.ones(pts.shape[:-1], dtype=pts.dtype)
    else:
        w = weights
    wsum = jnp.sum(w, axis=-1, keepdims=True) + 1e-12
    centroid = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / wsum[..., None]
    d = jnp.linalg.norm(pts - centroid, axis=-1)
    mean_dist = jnp.sum(d * w, axis=-1, keepdims=True) / wsum
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_dist, 1e-12)
    pts_norm = (pts - centroid) * scale[..., None]
    s = scale[..., 0]
    cx = centroid[..., 0, 0]
    cy = centroid[..., 0, 1]
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    T = jnp.stack(
        [s, zero, -s * cx, zero, s, -s * cy, zero, zero, one], axis=-1
    ).reshape(pts.shape[:-2] + (3, 3))
    return pts_norm, T


def smallest_eigvec_sym(AtA: jax.Array) -> jax.Array:
    """Eigenvector of the smallest eigenvalue of a symmetric matrix (batched)."""
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0]


def least_singular_vector(A: jax.Array) -> jax.Array:
    """Right singular vector of the smallest singular value of A (..., M, D).

    Preferred over eigh(A^T A) in float32: avoids squaring the condition
    number (measured: 8-point essential residuals improve 1e-3 -> 1e-7).
    """
    full = A.shape[-2] < A.shape[-1]  # static: need full V when underdetermined
    _, _, Vt = jnp.linalg.svd(A, full_matrices=full)
    return Vt[..., -1, :]


def nullspace_from_rows(A: jax.Array, k: int) -> jax.Array:
    """Last-k right singular vectors of A (..., M, D) -> (..., D, k)."""
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return jnp.swapaxes(Vt[..., -k:, :], -1, -2)


def homogeneous(pts: jax.Array) -> jax.Array:
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)
