"""Rig-constrained bundle adjustment.

Reference: src/colmap/estimators/bundle_adjustment.h:201 RigBundleAdjuster —
images of a rig snapshot share one rig pose plus per-camera rig extrinsics
(cam_from_world = cam_from_rig * rig_from_world).

Design: a matrix-free Levenberg-Marquardt over the stacked parameter
blocks (rig snapshot poses, cam_from_rig extrinsics, points). The normal
equations are never materialized — Hv products come from jvp/vjp through
the batched projection residual, solved with CG. This handles the
cross-block coupling of the rig structure without a hand-derived Schur
elimination; problem sizes (snapshots x cameras) stay modest.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from colmap_tpu.geometry import rigid3
from colmap_tpu.sensor import models as camera_models


class RigBAProblem(NamedTuple):
    rig_poses: jax.Array  # (S, 7) rig_from_world per snapshot
    cams_from_rig: jax.Array  # (C, 7)
    cam_params: jax.Array  # (C, 12)
    points: jax.Array  # (M, 3)
    obs_snapshot_idx: jax.Array  # (N,)
    obs_rigcam_idx: jax.Array  # (N,)
    obs_point_idx: jax.Array  # (N,)
    obs_xy: jax.Array  # (N, 2)
    obs_weight: jax.Array  # (N,)
    rig_pose_mask: jax.Array  # (S, 6)
    rig_cam_mask: jax.Array  # (C, 6)
    point_mask: jax.Array  # (M, 3)


@dataclasses.dataclass(frozen=True)
class RigBAOptions:
    max_iterations: int = 30
    cg_iterations: int = 30
    initial_lambda: float = 1e-4
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_PINHOLE)
    refine_relative_poses: bool = True  # reference RigBundleAdjuster option


def _residuals(problem: RigBAProblem, rig_poses, cams_from_rig, points,
               model_id: int):
    rp = rig_poses[problem.obs_snapshot_idx]
    cr = cams_from_rig[problem.obs_rigcam_idx]
    cp = problem.cam_params[problem.obs_rigcam_idx]
    X = points[problem.obs_point_idx]
    cam_from_world = jax.vmap(rigid3.compose)(cr, rp)
    pc = jax.vmap(rigid3.apply)(cam_from_world, X)
    z = pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    uv = pc[..., :2] / z_safe[..., None]
    proj = jax.vmap(
        lambda c, u: camera_models.img_from_cam(model_id, c, u[None])[0]
    )(cp, uv)
    r = (proj - problem.obs_xy) * problem.obs_weight[..., None]
    return jnp.where((z > 1e-8)[..., None], r, 1e2 * problem.obs_weight[..., None])


@functools.partial(jax.jit, static_argnums=(1,))
def solve_rig(problem: RigBAProblem, options: RigBAOptions = RigBAOptions()):
    """Run LM; returns updated RigBAProblem (poses/extrinsics/points)."""
    model_id = options.camera_model_id
    S = problem.rig_poses.shape[0]
    C = problem.cams_from_rig.shape[0]
    M = problem.points.shape[0]

    cam_mask = problem.rig_cam_mask
    if not options.refine_relative_poses:
        cam_mask = jnp.zeros_like(cam_mask)

    def apply_delta(params, delta):
        rig, cams, pts = params
        d_rig = delta[: S * 6].reshape(S, 6) * problem.rig_pose_mask
        d_cam = delta[S * 6: S * 6 + C * 6].reshape(C, 6) * cam_mask
        d_pt = delta[S * 6 + C * 6:].reshape(M, 3) * problem.point_mask
        rig2 = jax.vmap(rigid3.exp_update)(rig, d_rig)
        cams2 = jax.vmap(rigid3.exp_update)(cams, d_cam)
        return rig2, cams2, pts + d_pt

    n_params = S * 6 + C * 6 + M * 3

    def cost_of(params):
        r = _residuals(problem, *params, model_id)
        return 0.5 * jnp.sum(r * r)

    def lm_iter(state, _):
        params, lam, cost = state
        zero = jnp.zeros(n_params, problem.points.dtype)

        def r_of(delta):
            return _residuals(problem, *apply_delta(params, delta),
                              model_id).reshape(-1)

        r0 = r_of(zero)
        # g = J^T r; Hv = J^T J v via jvp + vjp
        _, vjp = jax.vjp(r_of, zero)
        g = vjp(r0)[0]

        def Hv(v):
            Jv = jax.jvp(r_of, (zero,), (v,))[1]
            return vjp(Jv)[0] + lam * v

        delta, _ = jax.scipy.sparse.linalg.cg(
            Hv, -g, maxiter=options.cg_iterations)
        new_params = apply_delta(params, delta)
        new_cost = cost_of(new_params)
        accept = new_cost < cost
        params = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), params, new_params)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10),
                        jnp.minimum(lam * 5.0, 1e6))
        cost = jnp.where(accept, new_cost, cost)
        return (params, lam, cost), cost

    params0 = (problem.rig_poses, problem.cams_from_rig, problem.points)
    init = (params0, jnp.asarray(options.initial_lambda,
                                 problem.points.dtype), cost_of(params0))
    (params, _, cost), _ = jax.lax.scan(lm_iter, init, None,
                                        length=options.max_iterations)
    rig, cams, pts = params
    return problem._replace(rig_poses=rig, cams_from_rig=cams,
                            points=pts), cost


def make_rig_problem(rig_poses, cams_from_rig, cam_params, points,
                     obs_snapshot_idx, obs_rigcam_idx, obs_point_idx,
                     obs_xy, obs_weight=None, fix_first_snapshot: bool = True
                     ) -> RigBAProblem:
    rig_poses = jnp.asarray(rig_poses, jnp.float32)
    S = rig_poses.shape[0]
    C = jnp.asarray(cams_from_rig).shape[0]
    M = jnp.asarray(points).shape[0]
    n = len(obs_xy)
    if obs_weight is None:
        obs_weight = np.ones(n, np.float32)
    rig_pose_mask = np.ones((S, 6), np.float32)
    if fix_first_snapshot:
        rig_pose_mask[0] = 0.0
    # gauge: fix the reference camera's extrinsics (identity cam 0)
    rig_cam_mask = np.ones((int(C), 6), np.float32)
    rig_cam_mask[0] = 0.0
    return RigBAProblem(
        rig_poses=rig_poses,
        cams_from_rig=jnp.asarray(cams_from_rig, jnp.float32),
        cam_params=jnp.asarray(cam_params, jnp.float32),
        points=jnp.asarray(points, jnp.float32),
        obs_snapshot_idx=jnp.asarray(obs_snapshot_idx, jnp.int32),
        obs_rigcam_idx=jnp.asarray(obs_rigcam_idx, jnp.int32),
        obs_point_idx=jnp.asarray(obs_point_idx, jnp.int32),
        obs_xy=jnp.asarray(obs_xy, jnp.float32),
        obs_weight=jnp.asarray(obs_weight, jnp.float32),
        rig_pose_mask=jnp.asarray(rig_pose_mask),
        rig_cam_mask=jnp.asarray(rig_cam_mask),
        point_mask=jnp.ones((int(M), 3), jnp.float32),
    )
