"""Point triangulation, batched. Reference: src/colmap/geometry/triangulation.h.

All functions operate on *normalized camera-ray* observations (u, v) (i.e.
after cam_from_img) and (3, 4) world->cam projection matrices built from
Rigid3d poses, and broadcast over leading batch axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from colmap_tpu.geometry import rigid3


def triangulate_point(cam1_from_world: jax.Array, cam2_from_world: jax.Array,
                      uv1: jax.Array, uv2: jax.Array) -> jax.Array:
    """Two-view DLT (midpoint-free homogeneous LS), batched over leading axes.

    Returns world points (..., 3). Reference: TriangulatePoint
    (geometry/triangulation.cc) which solves the 4x4 DLT via SVD; here we
    build the 4x4 normal matrix A^T A and take its smallest eigenvector
    (batched eigh; A is 4x4 so this is exact and fast).
    """
    P1 = rigid3.to_matrix(cam1_from_world)  # (..., 3, 4)
    P2 = rigid3.to_matrix(cam2_from_world)

    def rows(P, uv):
        r1 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return jnp.stack([r1, r2], axis=-2)  # (..., 2, 4)

    A = jnp.concatenate([rows(P1, uv1), rows(P2, uv2)], axis=-2)  # (..., 4, 4)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    X = vecs[..., :, 0]  # smallest eigenvalue eigenvector
    w = X[..., 3:4]
    return X[..., :3] / jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)


def triangulate_multi_view(proj_matrices: jax.Array, uvs: jax.Array,
                           mask: jax.Array | None = None) -> jax.Array:
    """N-view LS triangulation with optional per-view mask.

    proj_matrices: (..., N, 3, 4); uvs: (..., N, 2); mask: (..., N) bool.
    Accumulates the 4x4 normal equations over views (masked views weighted 0)
    — fixed-capacity N keeps shapes static for vmap/scan.
    Reference: TriangulateMultiViewPoint (geometry/triangulation.cc), which
    accumulates cost terms per view and takes the smallest eigenvector.
    """
    P = proj_matrices
    r1 = uvs[..., 0:1] * P[..., 2, :] - P[..., 0, :]  # (..., N, 4)
    r2 = uvs[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    # normalize each constraint row pair for conditioning
    A = jnp.concatenate([r1[..., None, :], r2[..., None, :]], axis=-2)  # (..., N, 2, 4)
    A = A / (jnp.linalg.norm(A, axis=-1, keepdims=True) + 1e-12)
    if mask is not None:
        A = A * mask[..., None, None]
    AtA = jnp.einsum("...nki,...nkj->...ij", A, A)
    _, vecs = jnp.linalg.eigh(AtA)
    X = vecs[..., :, 0]
    w = X[..., 3:4]
    return X[..., :3] / jnp.where(jnp.abs(w) > 1e-12, w, 1e-12)


def calculate_triangulation_angle(center1: jax.Array, center2: jax.Array,
                                  point3d: jax.Array) -> jax.Array:
    """Angle (radians) at the 3D point subtended by the two camera centers.

    Reference: CalculateTriangulationAngle (geometry/triangulation.cc) — uses
    the law-of-cosines form and folds angles > pi/2.
    """
    baseline2 = jnp.sum((center1 - center2) ** 2, axis=-1)
    ray1 = jnp.sum((point3d - center1) ** 2, axis=-1)
    ray2 = jnp.sum((point3d - center2) ** 2, axis=-1)
    denom = 2.0 * jnp.sqrt(ray1 * ray2 + 1e-24)
    cos_angle = jnp.clip((ray1 + ray2 - baseline2) / jnp.maximum(denom, 1e-24), -1.0, 1.0)
    angle = jnp.arccos(cos_angle)
    return jnp.minimum(angle, jnp.pi - angle)


def has_point_positive_depth(cam_from_world: jax.Array, point3d: jax.Array) -> jax.Array:
    return rigid3.apply(cam_from_world, point3d)[..., 2] > 0
