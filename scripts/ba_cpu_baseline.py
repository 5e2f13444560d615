"""Measured CPU baseline for the 500-camera BA benchmark.

Implements the same algorithm class ceres uses for this problem size
(DENSE_SCHUR: block Jacobians -> Schur complement on the reduced camera
system -> dense Cholesky; reference
src/colmap/estimators/bundle_adjustment.cc:336-385 selects *_SCHUR) in
vectorized numpy/scipy on the host CPU, on the EXACT problem bench.py
solves on the device (__graft_entry__._build_problem(500, 50k, 6 obs/pt)).

Jacobians come from vectorized central differences over the 6 pose-tangent
+ 3 point dofs (the dominant per-iteration cost in any CPU BA is the
linear algebra, not the 18 residual sweeps, so this is a fair floor).

Prints one JSON line: measured LM iterations/s. bench.py cites this number
(re-run this script to reproduce).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def quat_rotate(q, v):
    qv = q[:, 1:4]
    t = 2.0 * np.cross(qv, v)
    return v + q[:, :1] * t + np.cross(qv, t)


def exp_update(poses, delta):
    """Right-multiplicative SE3-tangent update matching rigid3.exp_update."""
    import jax

    from colmap_tpu.geometry import rigid3
    import jax.numpy as jnp

    return np.asarray(rigid3.exp_update(jnp.asarray(poses, jnp.float64),
                                        jnp.asarray(delta, jnp.float64)))


def residuals(poses, points, obs_pose, obs_pt, obs_xy, params):
    q = poses[obs_pose, :4]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pc = quat_rotate(q, points[obs_pt]) + poses[obs_pose, 4:7]
    z = np.where(np.abs(pc[:, 2]) > 1e-8, pc[:, 2], 1e-8)
    uv = pc[:, :2] / z[:, None]
    f, cx, cy, k = params[0], params[1], params[2], params[3]
    r2 = np.sum(uv * uv, axis=-1)
    d = 1.0 + k * r2
    xy = f * uv * d[:, None] + np.array([cx, cy])
    return xy - obs_xy


def main():
    from __graft_entry__ import _build_problem

    problem, _ = _build_problem(num_poses=500, num_points=50_000,
                                obs_per_point=6, seed=7)
    poses = np.asarray(problem.poses, np.float64)
    points = np.asarray(problem.points, np.float64)
    params = np.asarray(problem.cam_params[0], np.float64)
    obs_pose = np.asarray(problem.obs_pose_idx)
    obs_pt = np.asarray(problem.obs_point_idx)
    obs_xy = np.asarray(problem.obs_xy, np.float64)
    w = np.asarray(problem.obs_weight, np.float64)
    live = w > 0
    obs_pose, obs_pt, obs_xy = obs_pose[live], obs_pt[live], obs_xy[live]
    N, P, M = len(obs_pose), len(poses), len(points)
    print(f"problem: {P} poses, {M} points, {N} obs", file=sys.stderr)

    from scipy.linalg import cho_factor, cho_solve
    from scipy.sparse import coo_matrix

    lam = 1e-4
    h = 1e-6
    times = []
    cost = 0.5 * np.sum(residuals(poses, points, obs_pose, obs_pt, obs_xy,
                                  params) ** 2)
    for it in range(6):
        t0 = time.perf_counter()
        r = residuals(poses, points, obs_pose, obs_pt, obs_xy, params)

        # central-difference block Jacobians (vectorized over all obs)
        Jp = np.zeros((N, 2, 6))
        for i in range(6):
            d = np.zeros((P, 6))
            d[:, i] = h
            rp = residuals(exp_update(poses, d), points, obs_pose, obs_pt,
                           obs_xy, params)
            rm = residuals(exp_update(poses, -d), points, obs_pose, obs_pt,
                           obs_xy, params)
            Jp[:, :, i] = (rp - rm) / (2 * h)
        Jx = np.zeros((N, 2, 3))
        for i in range(3):
            d = np.zeros((M, 3))
            d[:, i] = h
            rp = residuals(poses, points + d, obs_pose, obs_pt, obs_xy, params)
            rm = residuals(poses, points - d, obs_pose, obs_pt, obs_xy, params)
            Jx[:, :, i] = (rp - rm) / (2 * h)

        # normal equations blocks
        Hpp = np.zeros((P, 6, 6))
        np.add.at(Hpp, obs_pose, np.einsum("nki,nkj->nij", Jp, Jp))
        Hxx = np.zeros((M, 3, 3))
        np.add.at(Hxx, obs_pt, np.einsum("nki,nkj->nij", Jx, Jx))
        gp = np.zeros((P, 6))
        np.add.at(gp, obs_pose, np.einsum("nki,nk->ni", Jp, r))
        gx = np.zeros((M, 3))
        np.add.at(gx, obs_pt, np.einsum("nki,nk->ni", Jx, r))
        W = np.einsum("nki,nkj->nij", Jp, Jx)  # (N, 6, 3)

        # damping
        Hpp += lam * np.eye(6) * np.maximum(
            np.einsum("pii->pi", Hpp), 1e-6)[:, :, None] * np.eye(6)
        Hxx_d = Hxx + lam * np.eye(3) * np.maximum(
            np.einsum("mii->mi", Hxx), 1e-6)[:, :, None] * np.eye(3)
        Hxx_inv = np.linalg.inv(Hxx_d + 1e-9 * np.eye(3))

        # Schur complement on the reduced camera system (DENSE_SCHUR)
        WV = np.einsum("nij,njk->nik", W, Hxx_inv[obs_pt])  # (N, 6, 3)
        # S = Hpp - sum_{obs pairs sharing a point} W1 Hxx^-1 W2^T:
        # build sparse (6P x 3M) W and multiply
        rowsW = (obs_pose[:, None, None] * 6
                 + np.arange(6)[None, :, None]).repeat(3, axis=2).ravel()
        colsW = (obs_pt[:, None, None] * 3
                 + np.arange(3)[None, None, :]).repeat(6, axis=1).ravel()
        Ws = coo_matrix((W.ravel(), (rowsW, colsW)),
                        shape=(6 * P, 3 * M)).tocsr()
        WVs = coo_matrix((WV.ravel(), (rowsW, colsW)),
                         shape=(6 * P, 3 * M)).tocsr()
        S = np.zeros((6 * P, 6 * P))
        pidx = np.arange(P)
        S.reshape(P, 6, P, 6)[pidx, :, pidx, :] = Hpp
        S -= (WVs @ Ws.T).toarray()
        rhs = -gp.reshape(-1) + (WVs @ gx.reshape(-1))

        du = cho_solve(cho_factor(S + 1e-9 * np.eye(6 * P)), rhs).reshape(P, 6)
        # point back-substitution
        t = np.zeros((M, 3))
        np.add.at(t, obs_pt, np.einsum("nij,ni->nj", W, du[obs_pose]))
        dx = np.einsum("mij,mj->mi", Hxx_inv, -gx - t)

        trial_poses = exp_update(poses, du)
        trial_points = points + dx
        new_cost = 0.5 * np.sum(residuals(trial_poses, trial_points, obs_pose,
                                          obs_pt, obs_xy, params) ** 2)
        if new_cost < cost:
            poses, points, cost = trial_poses, trial_points, new_cost
            lam = max(lam / 3, 1e-10)
        else:
            lam = min(lam * 4, 1e6)
        dt = time.perf_counter() - t0
        times.append(dt)
        print(f"iter {it}: {dt:.2f}s cost={cost:.1f}", file=sys.stderr)

    med = float(np.median(times))
    print(json.dumps({
        "metric": "ba_cpu_schur_lm_iters_per_s_500cam_300kobs",
        "value": round(1.0 / med, 3),
        "unit": "LM iters/s",
        "method": "numpy/scipy DENSE_SCHUR LM, central-diff block Jacobians, "
                  "host CPU",
    }))


if __name__ == "__main__":
    main()
