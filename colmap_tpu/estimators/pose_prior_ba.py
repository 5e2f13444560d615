"""Position-prior-constrained bundle adjustment.

Reference: src/colmap/estimators/bundle_adjustment.h:260
PosePriorBundleAdjuster — adds per-image position-prior residuals
(PositionPriorError cost functor, estimators/cost_functions.h) so the model
stays registered to the prior frame (GPS/ENU) during BA.

Design: matrix-free LM (jvp/vjp Hessian products + CG) over poses and
points with two residual groups — reprojection and weighted
projection-center priors. The prior weight is 1/sigma per axis.
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


class PriorBAProblem(NamedTuple):
    poses: jax.Array  # (P, 7) cam_from_world
    cam_params: jax.Array  # (C, 12)
    points: jax.Array  # (M, 3)
    obs_pose_idx: jax.Array
    obs_cam_idx: jax.Array
    obs_point_idx: jax.Array
    obs_xy: jax.Array
    obs_weight: jax.Array
    prior_positions: jax.Array  # (P, 3) projection-center priors (world)
    prior_weight: jax.Array  # (P, 3) 1/sigma per axis; 0 = no prior
    pose_mask: jax.Array  # (P, 6)
    point_mask: jax.Array  # (M, 3)


@dataclasses.dataclass(frozen=True)
class PriorBAOptions:
    max_iterations: int = 30
    cg_iterations: int = 40
    initial_lambda: float = 1e-4
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_PINHOLE)
    prior_loss_scale: float = 1.0  # Cauchy scale on prior residuals (units)


def _reproj_residuals(problem, poses, points, model_id):
    p = poses[problem.obs_pose_idx]
    c = problem.cam_params[problem.obs_cam_idx]
    X = points[problem.obs_point_idx]
    pc = jax.vmap(rigid3.apply)(p, X)
    z = pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    uv = pc[..., :2] / z_safe[..., None]
    proj = jax.vmap(
        lambda ci, u: camera_models.img_from_cam(model_id, ci, u[None])[0]
    )(c, uv)
    r = (proj - problem.obs_xy) * problem.obs_weight[..., None]
    return jnp.where((z > 1e-8)[..., None], r,
                     1e2 * problem.obs_weight[..., None])


def _prior_residuals(problem, poses, scale):
    centers = jax.vmap(rigid3.projection_center)(poses)
    r = (centers - problem.prior_positions) * problem.prior_weight
    # Cauchy robustification (reference wraps priors in a loss)
    r2 = jnp.sum(r * r, -1, keepdims=True)
    w = jax.lax.rsqrt(1.0 + r2 / (scale * scale))
    return r * w


@functools.partial(jax.jit, static_argnums=(1,))
def solve_prior_ba(problem: PriorBAProblem,
                   options: PriorBAOptions = PriorBAOptions()):
    model_id = options.camera_model_id
    P = problem.poses.shape[0]
    M = problem.points.shape[0]
    n_params = P * 6 + M * 3

    def apply_delta(params, delta):
        poses, pts = params
        dp = delta[: P * 6].reshape(P, 6) * problem.pose_mask
        dx = delta[P * 6:].reshape(M, 3) * problem.point_mask
        return jax.vmap(rigid3.exp_update)(poses, dp), pts + dx

    def residuals(params):
        poses, pts = params
        r1 = _reproj_residuals(problem, poses, pts, model_id).reshape(-1)
        r2 = _prior_residuals(problem, poses,
                              options.prior_loss_scale).reshape(-1)
        return jnp.concatenate([r1, r2])

    def cost_of(params):
        r = residuals(params)
        return 0.5 * jnp.sum(r * r)

    def lm_iter(state, _):
        params, lam, cost = state
        zero = jnp.zeros(n_params, problem.points.dtype)

        def r_of(delta):
            return residuals(apply_delta(params, delta))

        r0 = r_of(zero)
        _, vjp = jax.vjp(r_of, zero)
        g = vjp(r0)[0]

        def Hv(v):
            Jv = jax.jvp(r_of, (zero,), (v,))[1]
            return vjp(Jv)[0] + lam * v

        delta, _ = jax.scipy.sparse.linalg.cg(Hv, -g,
                                              maxiter=options.cg_iterations)
        new_params = apply_delta(params, delta)
        new_cost = cost_of(new_params)
        accept = new_cost < cost
        params = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                              params, new_params)
        lam = jnp.where(accept, jnp.maximum(lam * 0.3, 1e-10),
                        jnp.minimum(lam * 5.0, 1e6))
        cost = jnp.where(accept, new_cost, cost)
        return (params, lam, cost), cost

    params0 = (problem.poses, problem.points)
    init = (params0,
            jnp.asarray(options.initial_lambda, problem.points.dtype),
            cost_of(params0))
    (params, _, cost), _ = jax.lax.scan(lm_iter, init, None,
                                        length=options.max_iterations)
    poses, pts = params
    return problem._replace(poses=poses, points=pts), cost


def refine_with_priors(rec, priors: dict, sigma: float = 1.0,
                       options: Optional[PriorBAOptions] = None):
    """Run prior-constrained BA on a Reconstruction in place.

    priors: image_id -> 3-vector position (world/ENU frame of the model).
    Reference: PosePriorBundleAdjuster::Solve.
    """
    reg = rec.registered_image_ids()
    if len(reg) < 2 or not rec.points3D:
        return rec
    img_index = {iid: k for k, iid in enumerate(reg)}
    pids = sorted(rec.points3D.keys())
    pid_index = {pid: k for k, pid in enumerate(pids)}
    cams = sorted(rec.cameras.keys())
    cam_index = {cid: k for k, cid in enumerate(cams)}
    obs_pose, obs_cam, obs_pt, obs_xy = [], [], [], []
    for pid in pids:
        for (iid, f) in rec.points3D[pid].track:
            if iid not in img_index:
                continue
            obs_pose.append(img_index[iid])
            obs_cam.append(cam_index[rec.images[iid].camera_id])
            obs_pt.append(pid_index[pid])
            obs_xy.append(rec.images[iid].xys[f])
    poses = np.stack([rec.images[i].cam_from_world for i in reg]).astype(np.float32)
    points = np.stack([rec.points3D[p].xyz for p in pids]).astype(np.float32)
    cam_params = np.stack([rec.cameras[c].padded_params() for c in cams])

    prior_pos = np.zeros((len(reg), 3), np.float32)
    prior_w = np.zeros((len(reg), 3), np.float32)
    for iid, pos in priors.items():
        if iid in img_index:
            prior_pos[img_index[iid]] = np.asarray(pos, np.float32)
            prior_w[img_index[iid]] = 1.0 / sigma

    model_id = rec.cameras[cams[0]].model_id
    opts = options or PriorBAOptions(camera_model_id=int(model_id))
    problem = PriorBAProblem(
        poses=jnp.asarray(poses),
        cam_params=jnp.asarray(cam_params, jnp.float32),
        points=jnp.asarray(points),
        obs_pose_idx=jnp.asarray(np.array(obs_pose, np.int32)),
        obs_cam_idx=jnp.asarray(np.array(obs_cam, np.int32)),
        obs_point_idx=jnp.asarray(np.array(obs_pt, np.int32)),
        obs_xy=jnp.asarray(np.stack(obs_xy), jnp.float32),
        obs_weight=jnp.ones(len(obs_xy), jnp.float32),
        prior_positions=jnp.asarray(prior_pos),
        prior_weight=jnp.asarray(prior_w),
        # priors fix the gauge -> all poses free
        pose_mask=jnp.ones((len(reg), 6), jnp.float32),
        point_mask=jnp.ones((len(pids), 3), jnp.float32),
    )
    solved, _ = solve_prior_ba(problem, opts)
    new_poses = np.asarray(solved.poses, np.float64)
    new_points = np.asarray(solved.points, np.float64)
    for iid, k in img_index.items():
        rec.images[iid].cam_from_world = new_poses[k]
    for pid, k in pid_index.items():
        rec.points3D[pid].xyz = new_points[k]
    return rec
