"""Absolute (calibrated) camera pose: P3P minimal solver + Gauss-Newton
refinement, batched.

Reference capability: src/colmap/estimators/absolute_pose.h:34 (P3P via
PoseLib), pose refinement estimators/pose.h:156 (ceres). This design uses
Grunert's resultant-based P3P (the quartic coefficients are assembled with
static polynomial convolutions so thousands of P3P problems solve in one
vmapped program), and replaces ceres pose refinement with a fixed-iteration
Levenberg-damped Gauss-Newton on the SE3 tangent (jax.jacfwd autodiff).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from colmap_tpu.geometry import rigid3, rotation as rot
from colmap_tpu.math.polynomial import find_roots_durand_kerner


def _kabsch(src: jax.Array, dst: jax.Array, weights: jax.Array | None = None):
    """Rigid transform (R, t) with dst ~= R src + t (weighted, batched)."""
    if weights is None:
        weights = jnp.ones(src.shape[:-1], dtype=src.dtype)
    wsum = jnp.sum(weights, axis=-1, keepdims=True) + 1e-12
    cs = jnp.sum(src * weights[..., None], axis=-2) / wsum
    cd = jnp.sum(dst * weights[..., None], axis=-2) / wsum
    s = src - cs[..., None, :]
    d = dst - cd[..., None, :]
    H = jnp.einsum("...ni,...nj,...n->...ij", s, d, weights)
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(jnp.swapaxes(Vt, -1, -2) @ jnp.swapaxes(U, -1, -2))
    D = jnp.ones(H.shape[:-2] + (3,), H.dtype).at[..., 2].set(det)
    R = jnp.einsum("...ji,...j,...jk->...ik", Vt, D, jnp.swapaxes(U, -1, -2))
    t = cd - jnp.einsum("...ij,...j->...i", R, cs)
    return R, t


def solve_p3p(points3d: jax.Array, uv: jax.Array):
    """Grunert P3P. points3d (3, 3) world; uv (3, 2) normalized image coords.

    Returns (poses (4, 7) cam_from_world, valid (4,)).
    """
    dtype = points3d.dtype
    f = jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], axis=-1)
    f = f / jnp.linalg.norm(f, axis=-1, keepdims=True)  # unit rays
    P1, P2, P3 = points3d[0], points3d[1], points3d[2]
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    ca = jnp.dot(f[1], f[2])  # cos(alpha)
    cb = jnp.dot(f[0], f[2])
    cg = jnp.dot(f[0], f[1])
    b2_safe = jnp.where(b2 > 1e-12, b2, 1e-12)
    A = a2 / b2_safe
    B = c2 / b2_safe

    # u = N(v) / D(v) with N = (1 - (A-B)) * (-v^2 term...) assembled as
    # ascending-coefficient polynomials:
    #   N(v) = (A - B)(1 + v^2 - 2 v cb) + 1 - v^2
    #   D(v) = 2 (cg - v ca)
    N = jnp.stack([(A - B) + 1.0, -2.0 * (A - B) * cb, (A - B) - 1.0])
    D = jnp.stack([2.0 * cg, -2.0 * ca])

    def conv(p, q):
        n = p.shape[0] + q.shape[0] - 1
        out = jnp.zeros((n,), dtype)
        for i in range(p.shape[0]):
            out = out.at[i : i + q.shape[0]].add(p[i] * q)
        return out

    def pad(p, n):
        return jnp.concatenate([p, jnp.zeros((n - p.shape[0],), dtype)])

    # E2: u^2 - 2 u cg + 1 - B (1 + v^2 - 2 v cb) = 0, times D(v)^2:
    #   N^2 - 2 cg N D + (1 - B - (-2 B cb) v ... ) D^2 = 0
    Q = jnp.stack([1.0 - B, 2.0 * B * cb, -B])  # 1 - B(1 + v^2 - 2 v cb)
    quartic = (
        pad(conv(N, N), 5)
        - 2.0 * cg * pad(conv(N, D), 5)
        + pad(conv(Q, conv(D, D)), 5)
    )  # ascending, degree 4

    roots = find_roots_durand_kerner(quartic[::-1], num_iters=50)  # (4,)
    v = jnp.real(roots)
    is_real = jnp.abs(jnp.imag(roots)) <= 1e-4 * (1.0 + jnp.abs(v))

    def eval_asc(p, x):
        out = jnp.zeros_like(x)
        for i in range(p.shape[0] - 1, -1, -1):
            out = out * x + p[i]
        return out

    Dv = eval_asc(pad(D, 2), v)
    Dv_safe = jnp.where(jnp.abs(Dv) > 1e-12, Dv, 1e-12)
    u = eval_asc(pad(N, 3), v) / Dv_safe

    denom = 1.0 + v * v - 2.0 * v * cb
    denom = jnp.maximum(denom, 1e-12)
    s1 = jnp.sqrt(b2 / denom)
    s2 = u * s1
    s3 = v * s1
    valid = is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points, then absolute orientation world -> camera
    s = jnp.stack([s1, s2, s3], axis=-1)  # (4 roots, 3 depths)
    pc = s[..., :, None] * f[None, :, :]  # (4, 3, 3)
    pw = jnp.broadcast_to(points3d, pc.shape)
    R, t = _kabsch(pw, pc)
    q = rot.rotmat_to_quat(R)
    poses = rigid3.make(q, t)
    valid &= jnp.isfinite(poses).all(axis=-1)
    return poses, valid


def reprojection_residuals(pose: jax.Array, data: tuple) -> jax.Array:
    """Squared reprojection error in normalized camera coords.

    data = (points3d (N, 3), uv (N, 2)). Points behind the camera get a
    large (but finite, autodiff-safe) residual.
    """
    points3d, uv = data
    pc = rigid3.apply(pose, points3d)
    z = pc[..., 2]
    behind = z < 1e-6
    z_safe = jnp.where(behind, 1.0, z)
    proj = pc[..., :2] / z_safe[..., None]
    r2 = jnp.sum((proj - uv) ** 2, axis=-1)
    return jnp.where(behind, 1e6, r2)


def gn_refine_pose(pose: jax.Array, points3d: jax.Array, uv: jax.Array,
                   weights: jax.Array, num_iters: int = 10,
                   lm_lambda: float = 1e-4):
    """Damped Gauss-Newton pose refinement on the SE3 tangent (6 dof).

    Replaces the reference's ceres RefineAbsolutePose
    (estimators/pose.h:156). Fixed iterations, fully jittable/vmappable.
    """

    def residual_vec(p):
        pc = rigid3.apply(p, points3d)
        z = jnp.where(pc[..., 2] > 1e-6, pc[..., 2], 1e-6)
        proj = pc[..., :2] / z[..., None]
        return ((proj - uv) * weights[..., None]).reshape(-1)

    def step(pose, _):
        def r_of_delta(delta):
            return residual_vec(rigid3.exp_update(pose, delta))

        delta0 = jnp.zeros(6, dtype=pose.dtype)
        J = jax.jacfwd(r_of_delta)(delta0)  # (2N, 6)
        r = r_of_delta(delta0)
        JtJ = J.T @ J
        Jtr = J.T @ r
        H = JtJ + lm_lambda * jnp.diag(jnp.diag(JtJ)) + 1e-8 * jnp.eye(6, dtype=pose.dtype)
        delta = -jnp.linalg.solve(H, Jtr)
        new_pose = rigid3.exp_update(pose, delta)
        # accept only if cost decreased
        better = jnp.sum(r_of_delta(delta) ** 2) < jnp.sum(r**2)
        return jnp.where(better, new_pose, pose), None

    pose, _ = jax.lax.scan(step, pose, None, length=num_iters)
    return pose


def refit(pose: jax.Array, data: tuple, weights: jax.Array):
    """LO-RANSAC non-minimal step: GN refine from the current best pose."""
    points3d, uv = data
    new_pose = gn_refine_pose(pose, points3d, uv, weights, num_iters=5)
    return new_pose, jnp.isfinite(new_pose).all()


residuals = reprojection_residuals


# ---------------------------------------------------------------------------
# EPnP (n-point, non-minimal)
# ---------------------------------------------------------------------------


def solve_epnp(points3d: jax.Array, uv: jax.Array,
               weights: jax.Array | None = None):
    """EPnP n-point absolute pose (reference: estimators/absolute_pose.h:125
    EPnPEstimator). points3d (N, 3) world, uv (N, 2) normalized coords.

    Control points via weighted PCA, M-matrix nullspace (N=1 beta case),
    scale from inter-control-point distances, rigid alignment via Kabsch;
    a short damped-GN polish matches the higher beta cases' accuracy.
    Returns (pose (7,), valid scalar).
    """
    n = points3d.shape[0]
    dtype = points3d.dtype
    if weights is None:
        weights = jnp.ones(n, dtype)
    wsum = jnp.maximum(jnp.sum(weights), 1e-9)

    # control points: centroid + principal axes
    c0 = jnp.sum(points3d * weights[:, None], 0) / wsum
    centered = (points3d - c0) * jnp.sqrt(weights)[:, None]
    cov = centered.T @ centered / wsum
    evals, evecs = jnp.linalg.eigh(cov)
    axes = evecs.T * jnp.sqrt(jnp.maximum(evals, 1e-12))[:, None]  # (3, 3)
    ctrl_w = jnp.concatenate([c0[None], c0[None] + axes], 0)  # (4, 3)

    # barycentric coordinates
    A = axes.T  # world offsets of ctrl 1..3
    beta = jnp.linalg.solve(A + 1e-12 * jnp.eye(3, dtype=dtype),
                            (points3d - c0).T).T  # (N, 3)
    alphas = jnp.concatenate([1.0 - jnp.sum(beta, 1, keepdims=True), beta], 1)

    # M matrix (2N, 12) for normalized coords
    u = uv[:, 0]
    v = uv[:, 1]
    zeros = jnp.zeros_like(alphas)
    rx = jnp.stack([alphas, zeros, -alphas * u[:, None]], -1)  # (N, 4, 3)
    ry = jnp.stack([zeros, alphas, -alphas * v[:, None]], -1)
    M = jnp.concatenate([rx.reshape(n, 12), ry.reshape(n, 12)], 0)
    M = M * jnp.concatenate([weights, weights])[:, None]
    MtM = M.T @ M
    evals2, evecs2 = jnp.linalg.eigh(MtM)
    vker = evecs2[:, 0].reshape(4, 3)  # ctrl points in camera frame (scale amb.)

    # scale from control-point distances (beta case N=1)
    def pdists(c):
        d = c[:, None, :] - c[None, :, :]
        return jnp.sqrt(jnp.sum(d * d, -1) + 1e-12)

    dw = pdists(ctrl_w)
    dc = pdists(vker)
    scale = jnp.sum(dw * dc) / jnp.maximum(jnp.sum(dc * dc), 1e-12)
    ctrl_c = vker * scale
    # fix the sign so points land in front of the camera
    pts_c = alphas @ ctrl_c
    sign = jnp.where(jnp.sum(jnp.sign(pts_c[:, 2]) * weights) >= 0, 1.0, -1.0)
    ctrl_c = ctrl_c * sign

    R, t = _kabsch(ctrl_w, ctrl_c)
    pose = rigid3.make(rot.rotmat_to_quat(R), t)
    pose = gn_refine_pose(pose, points3d, uv, weights, num_iters=8)
    valid = jnp.isfinite(pose).all()
    r2 = reprojection_residuals(pose, (points3d, uv))
    valid &= jnp.sum(jnp.where(weights > 0, r2, 0.0)) < 1e6
    return pose, valid


def epnp_refit(pose: jax.Array, data: tuple, weights: jax.Array):
    """LO-RANSAC refit via EPnP (initialization-free non-minimal solver)."""
    del pose
    points3d, uv = data
    return solve_epnp(points3d, uv, weights)


# ---------------------------------------------------------------------------
# Absolute pose with focal-length search
# ---------------------------------------------------------------------------


def estimate_pose_with_focal_search(
    key: jax.Array, points3d: jax.Array, rays_prior: jax.Array,
    valid: jax.Array, max_error_normalized: jax.Array,
    min_focal_ratio: float = 0.5, max_focal_ratio: float = 2.0,
    num_focal_samples: int = 9, ransac_options=None,
):
    """P3P RANSAC over a grid of focal-length factors.

    Reference: AbsolutePoseEstimationOptions focal-length search in
    EstimateAbsolutePose (estimators/pose.h:68-156, kFocalLengthSamples) —
    rays computed with a prior focal are rescaled by each candidate factor
    and the best-support factor wins. All factors run as ONE vmapped
    batched-RANSAC program (factor axis = one more batch dim).

    rays_prior: (N, 2) normalized coords computed with the prior focal.
    Returns (pose, focal_factor, num_inliers, inlier_mask).
    """
    import dataclasses as _dc

    from colmap_tpu.optim.ransac import RansacOptions
    from colmap_tpu.optim.ransac import ransac as run_ransac

    opts = ransac_options or RansacOptions(num_samples=512, lo_iterations=2)
    opts = _dc.replace(opts, max_error=1.0)  # residuals pre-scaled below
    factors = jnp.exp(jnp.linspace(jnp.log(min_focal_ratio),
                                   jnp.log(max_focal_ratio),
                                   num_focal_samples)).astype(points3d.dtype)
    keys = jax.random.split(key, num_focal_samples)

    def run_one(k, f):
        uv = rays_prior / f
        err = max_error_normalized / f
        scale = 1.0 / jnp.maximum(err, 1e-12) ** 2

        def scaled_res(model, data):
            return reprojection_residuals(model, data) * scale

        res = run_ransac(
            k, solve_p3p, scaled_res, refit, (points3d, uv), valid, 3, opts)
        return res.model, res.num_inliers, res.score, res.inlier_mask

    poses, ninl, scores, masks = jax.vmap(run_one)(keys, factors)
    best = jnp.argmax(scores)
    return poses[best], factors[best], ninl[best], masks[best]
