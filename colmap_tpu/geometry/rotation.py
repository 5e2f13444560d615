"""Quaternion rotation math, batched over leading axes.

Conventions (matching the COLMAP sparse-model format, reference:
src/colmap/geometry/rigid3.h and doc/format.rst):
  - quaternions are stored (w, x, y, z) in the last axis,
  - a quaternion q rotates world->frame vectors as R(q) @ v,
  - all functions broadcast over leading batch axes and are jit/vmap safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def quat_normalize(q: jax.Array) -> jax.Array:
    """Return the unit quaternion, guarding the zero quaternion to identity."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    safe = jnp.where(n > _EPS, q / jnp.maximum(n, _EPS), 0.0)
    identity = jnp.zeros_like(q).at[..., 0].set(1.0)
    return jnp.where(n > _EPS, safe, identity)


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_multiply(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a*b (apply b first, then a, under quat_rotate)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Branchless Shepperd-style selection of the numerically best of the four
    candidate formulas (needed because any single formula is unstable when
    its pivot term is near zero).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidates, each scaled by 4*component^2 (always >= 0).
    qw2 = jnp.maximum(0.0, 1.0 + tr)
    qx2 = jnp.maximum(0.0, 1.0 + m00 - m11 - m22)
    qy2 = jnp.maximum(0.0, 1.0 - m00 + m11 - m22)
    qz2 = jnp.maximum(0.0, 1.0 - m00 - m11 + m22)

    def build(pivot2, a, b, c, order):
        s = 2.0 * jnp.sqrt(pivot2 + _EPS)
        comps = [None] * 4
        comps[order[0]] = s / 4.0
        comps[order[1]] = a / s
        comps[order[2]] = b / s
        comps[order[3]] = c / s
        return jnp.stack(comps, axis=-1)

    cw = build(qw2, m21 - m12, m02 - m20, m10 - m01, (0, 1, 2, 3))
    cx = build(qx2, m21 - m12, m01 + m10, m02 + m20, (1, 0, 2, 3))
    cy = build(qy2, m02 - m20, m01 + m10, m12 + m21, (2, 0, 1, 3))
    cz = build(qz2, m10 - m01, m02 + m20, m12 + m21, (3, 0, 1, 2))

    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # (..., 4, 4)
    pivots = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)  # (..., 4)
    best = jnp.argmax(pivots, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def quat_from_axis_angle(axis_angle: jax.Array) -> jax.Array:
    """Rotation vector (..., 3) -> quaternion (..., 4).

    Autodiff-safe at zero rotation (the BA/pose-refinement linearization
    point): the norm is computed through a guarded sqrt so d/d(aa) at 0 is
    finite, with a Taylor branch for small angles.
    """
    n2 = jnp.sum(axis_angle * axis_angle, axis=-1, keepdims=True)
    small = n2 < 1e-12
    # guarded sqrt: never differentiates sqrt at 0
    angle = jnp.sqrt(jnp.where(small, 1.0, n2))
    half = 0.5 * angle
    k = jnp.where(small, 0.5 - n2 / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - n2 / 8.0, jnp.cos(half))
    return jnp.concatenate([w, k * axis_angle], axis=-1)


def quat_to_axis_angle(q: jax.Array) -> jax.Array:
    """Quaternion (..., 4) -> rotation vector (..., 3)."""
    q = quat_normalize(q)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-9
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(vn, _EPS))
    return scale * v


def quat_angle_deg(a: jax.Array, b: jax.Array) -> jax.Array:
    """Relative rotation angle between two quaternions, in degrees."""
    d = jnp.abs(jnp.sum(quat_normalize(a) * quat_normalize(b), axis=-1))
    return jnp.degrees(2.0 * jnp.arccos(jnp.clip(d, -1.0, 1.0)))


def quat_slerp(a: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    """Spherical interpolation between unit quaternions (vectorized)."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    d = jnp.sum(a * b, axis=-1, keepdims=True)
    b = jnp.where(d < 0, -b, b)
    d = jnp.abs(d)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-6
    t = jnp.asarray(t)[..., None] if jnp.ndim(t) == a.ndim - 1 else jnp.asarray(t)
    wa = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta) / jnp.maximum(sin_theta, _EPS))
    wb = jnp.where(use_lerp, t, jnp.sin(t * theta) / jnp.maximum(sin_theta, _EPS))
    return quat_normalize(wa * a + wb * b)


def quat_average(qs: jax.Array, weights: jax.Array | None = None) -> jax.Array:
    """Weighted quaternion average via the max-eigenvector of sum(w q q^T).

    Reference behavior: src/colmap/geometry/pose.cc AverageQuaternions.
    qs: (N, 4); weights: (N,) or None.
    """
    if weights is None:
        weights = jnp.ones(qs.shape[0], dtype=qs.dtype)
    qs = quat_normalize(qs)
    A = jnp.einsum("n,ni,nj->ij", weights, qs, qs)
    # symmetric 4x4: batched eigh
    _, vecs = jnp.linalg.eigh(A)
    q = vecs[:, -1]
    return q * jnp.where(q[0] < 0, -1.0, 1.0)


def cross_matrix(v: jax.Array) -> jax.Array:
    """Skew-symmetric cross-product matrix [v]_x, (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))
