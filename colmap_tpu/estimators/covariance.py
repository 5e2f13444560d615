"""Pose / point covariance estimation via Schur complement.

Reference: src/colmap/estimators/covariance.h:17 (772 LoC impl) — computes
camera-pose covariances by eliminating the 3D points from the BA Hessian
(Schur complement on the reduced camera system) and point covariances by
back-substitution.

Design: residual Jacobians come from the same autodiff program as the
BA solver (estimators/bundle_adjustment._obs_residual_and_jac, one fused
device computation); the sparse Schur assembly/inversion is host-side numpy
(covariance is an offline analysis op, O(P^3) in the number of poses).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

import jax.numpy as jnp

from colmap_tpu.estimators import bundle_adjustment as ba


@dataclasses.dataclass
class CovarianceOptions:
    damping: float = 1e-8  # gauge/conditioning regularizer on the reduced system
    compute_point_covariances: bool = False


@dataclasses.dataclass
class BACovariance:
    pose_covs: Dict[int, np.ndarray]  # pose index -> (6, 6), tangent space
    point_covs: Dict[int, np.ndarray]  # point index -> (3, 3)


def estimate_ba_covariance(problem: ba.BAProblem,
                           options: CovarianceOptions = CovarianceOptions(),
                           camera_model_id: Optional[int] = None
                           ) -> BACovariance:
    """Covariances of the (free) pose and point parameters at the current
    BA solution, assuming unit-variance pixel noise."""
    model_id = camera_model_id if camera_model_id is not None else \
        int(ba.camera_models.CameraModelId.SIMPLE_RADIAL)
    r, Jp, Jc, Jx = ba._obs_residual_and_jac(problem, model_id)
    w = np.asarray(problem.obs_weight)
    Jp = np.asarray(Jp) * w[:, None, None]
    Jx = np.asarray(Jx) * w[:, None, None]
    pose_idx = np.asarray(problem.obs_pose_idx)
    point_idx = np.asarray(problem.obs_point_idx)
    pose_mask = np.asarray(problem.pose_mask)  # (P, 6)
    point_mask = np.asarray(problem.point_mask)
    Jp = Jp * pose_mask[pose_idx][:, None, :]
    Jx = Jx * point_mask[point_idx][:, None, :]

    P = pose_mask.shape[0]
    M = point_mask.shape[0]

    # block accumulations
    Hpp = np.zeros((P, 6, 6))
    np.add.at(Hpp, pose_idx, np.einsum("nri,nrj->nij", Jp, Jp))
    V = np.zeros((M, 3, 3))
    np.add.at(V, point_idx, np.einsum("nri,nrj->nij", Jx, Jx))
    A = np.einsum("nri,nrj->nij", Jp, Jx)  # (N, 6, 3) per-observation U block

    Vinv = np.zeros_like(V)
    for m in range(M):
        Vm = V[m] + options.damping * np.eye(3)
        if np.linalg.cond(Vm) < 1e12:
            Vinv[m] = np.linalg.inv(Vm)

    # reduced camera system S = Hpp - sum_m U_m Vinv_m U_m^T
    S = np.zeros((P, 6, P, 6))
    for p in range(P):
        S[p, :, p, :] = Hpp[p]
    # group observations by point
    order = np.argsort(point_idx, kind="stable")
    sorted_pt = point_idx[order]
    bounds = np.searchsorted(sorted_pt, np.arange(M + 1))
    for m in range(M):
        obs = order[bounds[m]:bounds[m + 1]]
        if len(obs) == 0:
            continue
        B = A[obs] @ Vinv[m]  # (t, 6, 3)
        for ii, oi in enumerate(obs):
            pi = pose_idx[oi]
            for jj, oj in enumerate(obs):
                pj = pose_idx[oj]
                S[pi, :, pj, :] -= B[ii] @ A[oj].T

    free = pose_mask.reshape(-1) > 0
    Sf = S.reshape(6 * P, 6 * P)[np.ix_(free, free)]
    Sf = Sf + options.damping * np.eye(Sf.shape[0])
    try:
        Sinv_f = np.linalg.inv(Sf)
    except np.linalg.LinAlgError:
        Sinv_f = np.linalg.pinv(Sf)
    Sinv = np.zeros((6 * P, 6 * P))
    Sinv[np.ix_(free, free)] = Sinv_f
    Sinv = Sinv.reshape(P, 6, P, 6)

    pose_covs = {p: Sinv[p, :, p, :] for p in range(P)
                 if pose_mask[p].any()}

    point_covs: Dict[int, np.ndarray] = {}
    if options.compute_point_covariances:
        for m in range(M):
            obs = order[bounds[m]:bounds[m + 1]]
            if len(obs) == 0 or not point_mask[m].any():
                continue
            # Sigma_x = Vinv + Vinv U^T Sigma_pose U Vinv
            acc = Vinv[m].copy()
            for ii, oi in enumerate(obs):
                pi = pose_idx[oi]
                for jj, oj in enumerate(obs):
                    pj = pose_idx[oj]
                    acc += (Vinv[m] @ A[oi].T) @ Sinv[pi, :, pj, :] \
                        @ (A[oj] @ Vinv[m])
            point_covs[m] = acc
    return BACovariance(pose_covs=pose_covs, point_covs=point_covs)


def estimate_pose_covariance_full_inverse(problem: ba.BAProblem,
                                          camera_model_id: int,
                                          damping: float = 1e-8
                                          ) -> np.ndarray:
    """Reference implementation for testing: invert the FULL (pose+point)
    Hessian densely and return the pose-block marginals (P, 6, 6)."""
    r, Jp, Jc, Jx = ba._obs_residual_and_jac(problem, camera_model_id)
    w = np.asarray(problem.obs_weight)
    Jp = np.asarray(Jp) * w[:, None, None]
    Jx = np.asarray(Jx) * w[:, None, None]
    pose_idx = np.asarray(problem.obs_pose_idx)
    point_idx = np.asarray(problem.obs_point_idx)
    pose_mask = np.asarray(problem.pose_mask)
    point_mask = np.asarray(problem.point_mask)
    Jp = Jp * pose_mask[pose_idx][:, None, :]
    Jx = Jx * point_mask[point_idx][:, None, :]
    P = pose_mask.shape[0]
    M = point_mask.shape[0]
    n = 6 * P + 3 * M
    J = np.zeros((2 * len(pose_idx), n))
    for k in range(len(pose_idx)):
        J[2 * k:2 * k + 2, 6 * pose_idx[k]:6 * pose_idx[k] + 6] = Jp[k]
        J[2 * k:2 * k + 2, 6 * P + 3 * point_idx[k]:6 * P + 3 * point_idx[k] + 3] = Jx[k]
    H = J.T @ J
    free = np.concatenate([pose_mask.reshape(-1) > 0,
                           point_mask.reshape(-1) > 0])
    Hf = H[np.ix_(free, free)] + damping * np.eye(int(free.sum()))
    Hinv = np.linalg.inv(Hf)
    full = np.zeros((n, n))
    full[np.ix_(free, free)] = Hinv
    return full[: 6 * P, : 6 * P].reshape(P, 6, P, 6)
