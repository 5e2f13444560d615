"""Generalized (multi-camera rig) absolute pose estimation.

Reference: src/colmap/estimators/generalized_absolute_pose.h (GP3P),
generalized_pose.h (EstimateGeneralizedAbsolutePose). This design
replaces the algebraic GP3P minimal solver with per-camera P3P hypotheses
lifted to the rig frame (a hypothesis from camera c's triple gives
rig_from_world = inv(cam_from_rig_c) * cam_from_world_c), scored against
ALL observations of ALL rig cameras in one batched residual program, with a
generalized GN refinement over the rig pose as the LO step. Same-camera
triples lose no generality for scoring and keep the solver a pure vmapped
P3P batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from colmap_tpu.estimators import absolute_pose as ap
from colmap_tpu.geometry import rigid3
from colmap_tpu.optim.ransac import RansacOptions, ransac


class GeneralizedPoseResult(NamedTuple):
    rig_from_world: jax.Array  # (7,)
    num_inliers: jax.Array
    inlier_mask: jax.Array
    success: jax.Array


def _rig_residuals(rig_pose, data):
    """Squared reprojection error in normalized coords per observation.

    data = (points3d (N,3), uv (N,2), cams_from_rig_per_obs (N,7)).
    """
    points3d, uv, cams = data
    cam_from_world = jax.vmap(rigid3.compose, in_axes=(0, None))(cams, rig_pose)
    pc = jax.vmap(rigid3.apply)(cam_from_world, points3d)
    z = pc[..., 2]
    behind = z < 1e-6
    z_safe = jnp.where(behind, 1.0, z)
    proj = pc[..., :2] / z_safe[..., None]
    r2 = jnp.sum((proj - uv) ** 2, axis=-1)
    return jnp.where(behind, 1e6, r2)


def _rig_gn_refine(rig_pose, points3d, uv, cams, weights, num_iters=8,
                   lm_lambda=1e-4):
    """Damped GN on the rig SE3 tangent over all cameras' observations."""

    def residual_vec(p):
        cam_from_world = jax.vmap(rigid3.compose, in_axes=(0, None))(cams, p)
        pc = jax.vmap(rigid3.apply)(cam_from_world, points3d)
        z = jnp.where(pc[..., 2] > 1e-6, pc[..., 2], 1e-6)
        proj = pc[..., :2] / z[..., None]
        return ((proj - uv) * weights[..., None]).reshape(-1)

    def step(pose, _):
        def r_of(delta):
            return residual_vec(rigid3.exp_update(pose, delta))

        d0 = jnp.zeros(6, pose.dtype)
        J = jax.jacfwd(r_of)(d0)
        r = r_of(d0)
        JtJ = J.T @ J
        H = JtJ + lm_lambda * jnp.diag(jnp.diag(JtJ)) \
            + 1e-8 * jnp.eye(6, dtype=pose.dtype)
        delta = -jnp.linalg.solve(H, J.T @ r)
        new_pose = rigid3.exp_update(pose, delta)
        better = jnp.sum(r_of(delta) ** 2) < jnp.sum(r ** 2)
        return jnp.where(better, new_pose, pose), None

    pose, _ = jax.lax.scan(step, rig_pose, None, length=num_iters)
    return pose


def estimate_generalized_absolute_pose(
    key: jax.Array,
    points3d: jax.Array,  # (N, 3) world
    uv: jax.Array,  # (N, 2) normalized coords in the OBSERVING camera
    cam_idx: jax.Array,  # (N,) int32 rig camera index per observation
    cams_from_rig: jax.Array,  # (C, 7)
    valid: jax.Array,  # (N,)
    options: Optional[RansacOptions] = None,
) -> GeneralizedPoseResult:
    """RANSAC generalized absolute pose (rig registration). Jittable."""
    opts = options or RansacOptions(num_samples=1024, lo_iterations=2)
    cams_per_obs = cams_from_rig[cam_idx]  # (N, 7)
    rigs_from_cams = jax.vmap(rigid3.inverse)(cams_from_rig)  # (C, 7)

    def solver(p3, uv3, cams3, camidx3):
        # P3P in the camera frame of the sample's FIRST observation; all
        # three sample points must come from that camera for the minimal
        # solve — hypotheses from mixed-camera triples are masked invalid
        # (they still occur at rate sum_c (n_c/n)^3 under uniform draws,
        # which the hypothesis budget absorbs).
        poses, ok = ap.solve_p3p(p3, uv3)
        same_cam = (camidx3[0] == camidx3[1]) & (camidx3[0] == camidx3[2])
        rig_from_cam = rigs_from_cams[camidx3[0]]
        rig_poses = jax.vmap(
            lambda cw: rigid3.compose(rig_from_cam, cw))(poses)
        return rig_poses, ok & same_cam

    def residual_fn(model, data):
        return _rig_residuals(model, data[:3])

    def refit_fn(model, data, weights):
        p, u, c, _ = data
        new = _rig_gn_refine(model, p, u, c, weights, num_iters=5)
        return new, jnp.isfinite(new).all()

    res = ransac(
        key,
        solver=solver,
        residual_fn=residual_fn,
        refit_fn=refit_fn,
        data=(points3d, uv, cams_per_obs, cam_idx),
        valid=valid,
        sample_size=3,
        options=opts,
    )
    return GeneralizedPoseResult(
        rig_from_world=res.model,
        num_inliers=res.num_inliers,
        inlier_mask=res.inlier_mask,
        success=res.success,
    )


def estimate_generalized_relative_pose(
    key: jax.Array,
    rays1: jax.Array,  # (N, 2) normalized coords in observing cam, rig pos 1
    rays2: jax.Array,  # (N, 2) same feature seen from rig pos 2
    cam_idx1: jax.Array,  # (N,) rig camera index at position 1
    cam_idx2: jax.Array,  # (N,) rig camera index at position 2
    cams_from_rig: jax.Array,  # (C, 7)
    valid: jax.Array,
    options: Optional[RansacOptions] = None,
):
    """Relative pose between two RIG positions (reference:
    estimators/generalized_relative_pose.h GR6P).

    Design: hypotheses come from same-camera 5-point essential solves
    (a same-camera correspondence subset gives cam_from_cam' = E-pose, and
    rig2_from_rig1 = inv(cam_from_rig) o cam2_from_cam1 o cam_from_rig —
    valid up to the E-pose scale ambiguity, which the cross-camera
    observations then disambiguate in the LO step: a GN on rig2_from_rig1
    over ALL correspondences with the generalized epipolar residual).
    Returns (rig2_from_rig1 (7,), num_inliers, inlier_mask, success).
    """
    from colmap_tpu.estimators import essential_matrix as em
    from colmap_tpu.estimators.two_view_geometry import recover_relative_pose
    from colmap_tpu.geometry import essential as ess

    opts = options or RansacOptions(num_samples=2048, lo_iterations=2)
    rigs_from_cams = jax.vmap(rigid3.inverse)(cams_from_rig)

    def h1(uv):
        return jnp.concatenate([uv, jnp.ones_like(uv[..., :1])], -1)

    def gen_epipolar_residual(rig_pose, data):
        """Squared generalized epipolar error (angular, Plücker form)."""
        r1, r2, c1, c2 = data
        # ray directions + origins in the rig-1 frame
        d1 = h1(r1)
        # to rig frame: x_rig = R_cam^T (x_cam - t) => direction R^T d
        cfr1 = cams_from_rig[c1]
        cfr2 = cams_from_rig[c2]

        def to_rig(cfr, d):
            q = cfr[..., :4]
            Rt_d = jax.vmap(lambda qq, dd: rot_apply_inv(qq, dd))(q, d)
            origin = jax.vmap(rigid3.projection_center)(cfr)
            return Rt_d, origin

        d1r, o1 = to_rig(cfr1, d1)
        d2r, o2 = to_rig(cfr2, h1(r2))
        # transform rig-2 rays into the rig-1 frame via inv(rig_pose)
        inv_pose = rigid3.inverse(rig_pose)
        q_inv = inv_pose[:4]
        d2w = jax.vmap(lambda dd: rot_apply(q_inv, dd))(d2r)
        o2w = jax.vmap(lambda oo: rigid3.apply(inv_pose, oo))(o2)
        # residual: shortest distance between the two 3D lines, normalized
        cr = jnp.cross(d1r, d2w)
        denom = jnp.linalg.norm(cr, axis=-1)
        diff = o2w - o1
        dist = jnp.abs(jnp.sum(diff * cr, -1)) / jnp.maximum(denom, 1e-9)
        # near-parallel rays: fall back to angular separation of directions
        sep = jnp.linalg.norm(
            jnp.cross(d1r, d2w), axis=-1) / (
            jnp.linalg.norm(d1r, axis=-1) * jnp.linalg.norm(d2w, axis=-1))
        r = jnp.where(denom > 1e-6, dist, sep)
        return r * r

    def rot_apply(q, v):
        p = jnp.concatenate([q, jnp.zeros(3, q.dtype)])
        return rigid3.apply(p, v)

    def rot_apply_inv(q, v):
        q_conj = q * jnp.array([1.0, -1, -1, -1], q.dtype)
        return rot_apply(q_conj, v)

    def solver(r1s, r2s, c1s, c2s):
        # 5-pt essential on the sample (requires same camera on both sides)
        models, ok = em.solve_5pt(r1s, r2s)
        same = jnp.all((c1s == c1s[0]) & (c2s == c2s[0]))
        cfr1 = cams_from_rig[c1s[0]]
        rig_from_cam2 = rigs_from_cams[c2s[0]]

        def lift(E):
            pose, _, _ = ess.pose_from_essential_matrix(
                E, r1s, r2s, jnp.ones(r1s.shape[0], bool))
            # cam2_from_cam1 -> rig2_from_rig1
            return rigid3.compose(rig_from_cam2,
                                  rigid3.compose(pose, cfr1))

        poses = jax.vmap(lift)(models)
        return poses, ok & same

    def refit_fn(model, data, weights):
        new = _rig_relpose_gn(model, data, weights)
        return new, jnp.isfinite(new).all()

    def _rig_relpose_gn(pose, data, weights, num_iters=6, lm_lambda=1e-4):
        def residual_vec(p):
            return jnp.sqrt(gen_epipolar_residual(p, data) + 1e-12) * weights

        def step(pose, _):
            def r_of(delta):
                return residual_vec(rigid3.exp_update(pose, delta))

            d0 = jnp.zeros(6, pose.dtype)
            J = jax.jacfwd(r_of)(d0)
            r = r_of(d0)
            JtJ = J.T @ J
            H = JtJ + lm_lambda * jnp.diag(jnp.diag(JtJ)) \
                + 1e-8 * jnp.eye(6, dtype=pose.dtype)
            delta = -jnp.linalg.solve(H, J.T @ r)
            newp = rigid3.exp_update(pose, delta)
            better = jnp.sum(r_of(delta) ** 2) < jnp.sum(r ** 2)
            return jnp.where(better, newp, pose), None

        pose, _ = jax.lax.scan(step, pose, None, length=num_iters)
        return pose

    res = ransac(
        key, solver=solver, residual_fn=gen_epipolar_residual,
        refit_fn=refit_fn,
        data=(rays1, rays2, cam_idx1, cam_idx2),
        valid=valid, sample_size=5, options=opts)
    return GeneralizedPoseResult(
        rig_from_world=res.model, num_inliers=res.num_inliers,
        inlier_mask=res.inlier_mask, success=res.success)
