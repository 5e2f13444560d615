"""Bundle adjustment: batched Levenberg-Marquardt with a matrix-free
Schur-complement CG solver.

This replaces the reference's entire ceres stack
(src/colmap/estimators/bundle_adjustment.h:15-197, solver selection
bundle_adjustment.cc:336-385) as batched device programs:

  * The problem is a flat, fixed-capacity tableau of observations
    (pose_idx, cam_idx, point_idx, xy, weight) — padding rows carry weight 0,
    so every shape is static and the whole optimizer jits once.
  * Per-observation 2x21 Jacobians (6 pose tangent + 3 point + 12 intrinsics)
    come from forward-mode autodiff, vmapped — the direct analog of ceres
    autodiff cost functors (reference estimators/cost_functions.h:28) but
    evaluated as one dense batched program.
  * The camera system is reduced by the Schur complement *matrix-free*:
    S u = A u - W Hpp^-1 W^T u is evaluated with per-observation
    contractions + segment sums; no sparse matrices are materialized.
    Point blocks (3x3) invert in closed form.
  * Preconditioned CG (block-Jacobi 6x6/12x12) solves the reduced system —
    the equivalent of ceres ITERATIVE_SCHUR + SCHUR_JACOBI, which the
    reference only reaches for >1000 images; here it is the single code path
    and it shards: with `axis_name` set, observation arrays are sharded
    across devices and every reduction gains a psum (distributed BA over
    the device interconnect).
  * Robust losses (trivial/huber/cauchy) via IRLS reweighting.

Gauge handling: per-dof float masks on poses/points/intrinsics; fixed dofs
have their Jacobian columns zeroed (reference fixes one pose + one
translation coordinate; pass masks to reproduce that).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from colmap_tpu.geometry import rigid3
from colmap_tpu.sensor import models as camera_models


class BAProblem(NamedTuple):
    """Fixed-capacity BA tableau. All arrays device-resident.

    The optional *gather layouts* make every reduction scatter-free
    (scatter-adds serialize on colliding indices: sort-based kernels or
    atomics, far slower than gathers), so `pt_gather` (M, T) and `pose_gather` (P, S) hold, per point / per
    pose, the indices of its observations in the flat obs axis (-1 pad).
    Point/pose reductions become gather + dense axis-sum; the tiny camera
    axis reduces through a one-hot matmul. When the layouts are
    None (e.g. the observation-sharded distributed path), lm_step falls
    back to segment_sum.
    """

    poses: jax.Array  # (P, 7) cam_from_world
    cam_params: jax.Array  # (C, 12) padded intrinsics
    points: jax.Array  # (M, 3)
    obs_pose_idx: jax.Array  # (N,) int32
    obs_cam_idx: jax.Array  # (N,) int32
    obs_point_idx: jax.Array  # (N,) int32
    obs_xy: jax.Array  # (N, 2)
    obs_weight: jax.Array  # (N,) float; 0 = padding
    pose_mask: jax.Array  # (P, 6) float; 0 = frozen dof
    cam_mask: jax.Array  # (C, 12) float
    point_mask: jax.Array  # (M, 3) float
    pt_gather: Optional[jax.Array] = None  # (M, T) int32 obs idx, -1 = pad
    pose_gather: Optional[jax.Array] = None  # (P, S) int32 obs idx, -1 = pad
    # camera of each pose (every image has exactly one camera, so camera
    # reductions go obs -> pose -> camera; the (P, C) one-hot is tiny,
    # unlike the previous dense (N, C) layout which was 800 MB at
    # 1M obs x 200 cams)
    pose_cam_idx: Optional[jax.Array] = None  # (P,) int32
    # pose-major dense layout companions (see lm_step): indices of each
    # point's observations in the flattened (P*S) pose-major space, and the
    # point index of every (P, S) slot
    pt_gather_ps: Optional[jax.Array] = None  # (M, T) int32 into P*S, -1 pad
    ps_point_idx: Optional[jax.Array] = None  # (P, S) int32, 0 for pads


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_iterations: int = 50
    cg_iterations: int = 30
    # static switch: when False, intrinsics Jacobians/updates are skipped
    # entirely (smaller + faster program). cam_mask can still freeze dofs
    # dynamically when True.
    refine_intrinsics: bool = True
    loss: str = "trivial"  # trivial | huber | cauchy | soft_l1
    loss_scale: float = 1.0  # in pixels
    initial_lambda: float = 1e-4
    min_lambda: float = 1e-10
    max_lambda: float = 1e6
    # early exit (reference: ceres function_tolerance): stop once an
    # accepted step decreases the cost by less than this relative amount,
    # or once lambda saturates at max_lambda (solver stuck). <= 0 disables
    # and always runs max_iterations (the fixed-cost bench mode).
    function_tolerance: float = 1e-6
    # truncated-CG forcing tolerance, eta-style (reference: ceres
    # Solver::Options::eta for ITERATIVE_SCHUR, default 0.1): the inner
    # PCG stops once the preconditioned residual norm drops below
    # eta * its starting value, so nearly-converged solves (most
    # intermediate global BAs in the mapper) cost a handful of matvecs
    # instead of the full cg_iterations budget. Note ceres applies eta as
    # a Q-criterion (relative decrease of the CG quadratic model); this is
    # the classical r-ratio variant on the preconditioned residual.
    # <= 0 disables (fixed-trip-count CG — benches pass 0.0 explicitly
    # for stable timing).
    cg_tolerance: float = 0.1
    # camera model id shared by the problem (static specialization)
    camera_model_id: int = int(camera_models.CameraModelId.SIMPLE_RADIAL)


# ---------------------------------------------------------------------------
# residuals + jacobians
# ---------------------------------------------------------------------------


def _project_residual(pose, cam, point, xy, model_id: int):
    pc = rigid3.apply(pose, point)
    z = pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) > 1e-8, z, 1e-8)
    uv = pc[..., :2] / z_safe[..., None]
    proj = camera_models.img_from_cam(model_id, cam, uv)
    r = proj - xy
    # behind-camera observations get residuals damped to a large constant
    # gradient-free region (matches reference filtering semantics where
    # negative-depth points are filtered out of the problem)
    return jnp.where(z > 1e-8, r, jnp.zeros_like(r) + 1e3)


def _obs_residual_and_jac(problem: BAProblem, model_id: int,
                          with_cam: bool = True):
    """Per-observation residuals (N, 2) and Jacobians wrt local params.

    with_cam=False skips the 12 intrinsics tangents (12 of 21 forward-mode
    passes) and returns Jc = zeros — used when intrinsics are frozen.
    """

    poses = problem.poses[problem.obs_pose_idx]  # (N, 7)
    cams = problem.cam_params[problem.obs_cam_idx]  # (N, 12)
    points = problem.points[problem.obs_point_idx]  # (N, 3)

    def res_local(delta_pose, delta_cam, delta_point, pose, cam, point, xy):
        return _project_residual(
            rigid3.exp_update(pose, delta_pose),
            cam + delta_cam,
            point + delta_point,
            xy,
            model_id,
        )

    zeros6 = jnp.zeros(poses.shape[:1] + (6,), poses.dtype)
    zeros12 = jnp.zeros(cams.shape, cams.dtype)
    zeros3 = jnp.zeros(points.shape, points.dtype)

    def single(dp, dc, dx, pose, cam, point, xy):
        return res_local(dp, dc, dx, pose, cam, point, xy)

    r = jax.vmap(single)(zeros6, zeros12, zeros3, poses, cams, points, problem.obs_xy)
    argnums = (0, 1, 2) if with_cam else (0, 2)
    jac = jax.vmap(
        lambda pose, cam, point, xy: jax.jacfwd(single, argnums=argnums)(
            jnp.zeros(6, poses.dtype),
            jnp.zeros(12, cams.dtype),
            jnp.zeros(3, points.dtype),
            pose,
            cam,
            point,
            xy,
        )
    )(poses, cams, points, problem.obs_xy)
    if with_cam:
        Jp, Jc, Jx = jac
    else:
        Jp, Jx = jac
        Jc = jnp.zeros(poses.shape[:1] + (2, 12), poses.dtype)
    return r, Jp, Jc, Jx  # (N,2), (N,2,6), (N,2,12), (N,2,3)


def _robust_weight(r2: jax.Array, loss: str, scale: float) -> jax.Array:
    """IRLS weight rho'(r2) for squared residual norms r2."""
    s2 = scale * scale
    if loss == "trivial":
        return jnp.ones_like(r2)
    if loss == "huber":
        return jnp.where(r2 <= s2, 1.0, jnp.sqrt(s2 / jnp.maximum(r2, 1e-12)))
    if loss == "cauchy":
        return 1.0 / (1.0 + r2 / s2)
    if loss == "soft_l1":
        return 1.0 / jnp.sqrt(1.0 + r2 / s2)
    raise ValueError(f"unknown loss {loss}")


def _robust_cost(r2: jax.Array, loss: str, scale: float) -> jax.Array:
    s2 = scale * scale
    if loss == "trivial":
        return r2
    if loss == "huber":
        r = jnp.sqrt(jnp.maximum(r2, 1e-20))
        return jnp.where(r2 <= s2, r2, 2.0 * scale * r - s2)
    if loss == "cauchy":
        return s2 * jnp.log1p(r2 / s2)
    if loss == "soft_l1":
        return 2.0 * s2 * (jnp.sqrt(1.0 + r2 / s2) - 1.0)
    raise ValueError(f"unknown loss {loss}")


def compute_cost(problem: BAProblem, options: BAOptions) -> jax.Array:
    """Total robust cost (0.5 * sum rho(||r||^2))."""
    poses = problem.poses[problem.obs_pose_idx]
    cams = problem.cam_params[problem.obs_cam_idx]
    points = problem.points[problem.obs_point_idx]
    r = jax.vmap(lambda p, c, x, xy: _project_residual(p, c, x, xy, options.camera_model_id))(
        poses, cams, points, problem.obs_xy
    )
    r2 = jnp.sum(r * r, axis=-1) * problem.obs_weight
    return 0.5 * jnp.sum(_robust_cost(r2, options.loss, options.loss_scale))


# ---------------------------------------------------------------------------
# the LM step
# ---------------------------------------------------------------------------


def _inv3x3_sym(A: jax.Array) -> jax.Array:
    """Closed-form batched symmetric 3x3 inverse (adjugate) — avoids the
    batched-LU custom call, which dominated an earlier LM profile."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 0, 2]
    d = A[..., 1, 1]
    e = A[..., 1, 2]
    f = A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    idet = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    row0 = jnp.stack([co00, co01, co02], -1)
    row1 = jnp.stack([co01, co11, co12], -1)
    row2 = jnp.stack([co02, co12, co22], -1)
    return jnp.stack([row0, row1, row2], -2) * idet[..., None, None]


def _psum(x, axis_name):
    return jax.lax.psum(x, axis_name) if axis_name is not None else x


def _segsum(x, idx, n):
    return jax.ops.segment_sum(x, idx, num_segments=n)


def _gather_reduce(vals: jax.Array, gather: jax.Array) -> jax.Array:
    """Scatter-free segment sum: vals (N, ...) summed per gather row.

    gather: (G, T) int32 indices into the obs axis; -1 entries are padding.
    Returns (G, ...).
    """
    idx = jnp.maximum(gather, 0)
    mask = (gather >= 0).astype(vals.dtype)
    g = jnp.take(vals, idx.reshape(-1), axis=0)
    g = g.reshape(gather.shape + vals.shape[1:])
    mask = mask.reshape(mask.shape + (1,) * (vals.ndim - 1))
    return jnp.sum(g * mask, axis=1)


def _make_reducers(problem: "BAProblem", axis_name, P: int, C: int, M: int):
    """Returns (point_reduce, pose_reduce, cam_reduce) closures."""
    if axis_name is None and problem.pt_gather is not None:
        pt_g = problem.pt_gather
        pose_g = problem.pose_gather

        def point_reduce(v):
            return _gather_reduce(v, pt_g)

        def pose_reduce(v):
            return _gather_reduce(v, pose_g)

        if C <= 8:
            # small camera count: one-hot contraction straight over the obs
            # axis (O(N*C) transient is tiny; this is the fast path the
            # single-camera 500-cam bench hits)
            obs_oh = (problem.obs_cam_idx[:, None]
                      == jnp.arange(C)[None, :]).astype(jnp.float32)
            obs_oh = obs_oh * (problem.obs_weight > 0)[:, None]

            def cam_reduce(v):
                flat = v.reshape(v.shape[0], -1)
                out = jnp.einsum("nc,nk->ck", obs_oh, flat,
                                 preferred_element_type=flat.dtype)
                return out.reshape((C,) + v.shape[1:])
        else:
            # many cameras: reduce obs -> pose -> camera; every pose has
            # exactly one camera, so this is exact and the layout memory is
            # O(P*C), not the old O(N*C) dense one-hot (800 MB at 1M obs x
            # 200 cams)
            pose_cam_oh = (problem.pose_cam_idx[:, None]
                           == jnp.arange(C)[None, :]).astype(jnp.float32)

            def cam_reduce(v):
                per_pose = _gather_reduce(v, pose_g)  # (P, ...)
                flat = per_pose.reshape(P, -1)
                out = jnp.einsum("pc,pk->ck", pose_cam_oh, flat,
                                 preferred_element_type=flat.dtype)
                return out.reshape((C,) + v.shape[1:])

        return point_reduce, pose_reduce, cam_reduce

    def point_reduce(v):
        return _psum(_segsum(v, problem.obs_point_idx, M), axis_name)

    def pose_reduce(v):
        return _psum(_segsum(v, problem.obs_pose_idx, P), axis_name)

    def cam_reduce(v):
        return _psum(_segsum(v, problem.obs_cam_idx, C), axis_name)

    return point_reduce, pose_reduce, cam_reduce


class LMState(NamedTuple):
    problem: BAProblem
    lam: jax.Array
    cost: jax.Array
    iteration: jax.Array
    # |trial_cost - cost| / cost of the last ACCEPTED step; inf after a
    # rejected step (ceres evaluates function_tolerance only on successful
    # steps — a rejected near-zero-change trial must raise lambda and
    # retry, the lam-saturation check covers the truly-stuck case).
    rel_change: jax.Array = None


def lm_step(state: LMState, options: BAOptions, axis_name: Optional[str] = None,
            cg_iters=None):
    """One damped LM iteration (jittable; shard obs arrays + set axis_name
    for multi-device). Returns the updated LMState.

    `cg_iters` optionally overrides options.cg_iterations with a TRACED
    scalar: the CG trip count then stays out of the program hash, so BA
    calls that differ only in iteration budget (local vs global vs final
    refinement) share one compiled program per shape class."""
    problem = state.problem
    P = problem.poses.shape[0]
    C = problem.cam_params.shape[0]
    M = problem.points.shape[0]

    use_cam = options.refine_intrinsics
    r, Jp, Jc, Jx = _obs_residual_and_jac(problem, options.camera_model_id,
                                          with_cam=use_cam)
    point_reduce, pose_reduce, cam_reduce = _make_reducers(
        problem, axis_name, P, C, M)
    # pose-major gather layouts. With axis_name set this is the POSE-SHARDED
    # distributed regime (parallel/distributed_ba.shard_problem_by_pose):
    # each shard owns P/n poses + their observations with LOCAL pose
    # indices; points/cameras are replicated, so point and camera block
    # reductions psum over the mesh while pose reductions stay shard-local.
    use_ps = problem.pt_gather_ps is not None
    pose_sharded = use_ps and axis_name is not None

    # robust IRLS scaling + observation weights + frozen-dof column masks
    r2 = jnp.sum(r * r, axis=-1)
    w = _robust_weight(r2, options.loss, options.loss_scale) * problem.obs_weight
    sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
    r = r * sw
    Jp = Jp * sw[..., None] * problem.pose_mask[problem.obs_pose_idx][:, None, :]
    Jc = Jc * sw[..., None] * problem.cam_mask[problem.obs_cam_idx][:, None, :]
    Jx = Jx * sw[..., None] * problem.point_mask[problem.obs_point_idx][:, None, :]

    lam = state.lam
    eye3 = jnp.eye(3, dtype=Jx.dtype)
    eye6 = jnp.eye(6, dtype=Jp.dtype)
    eye12 = jnp.eye(12, dtype=Jc.dtype)

    # ---- matrix-free Schur operator ---------------------------------------
    if use_ps:
        # pose-major / point-major dense layouts: gather the thin (2, k)
        # Jacobian rows ONCE, then every block reduction (Hxx, Hpp, Hcc,
        # gradients, the SCHUR_JACOBI self term) is a plain einsum over the
        # slot axis — no (N, 6, 6)/(N, 6, 3) materialization and no
        # gather-reduce of 36-wide rows (those two cost ~60% of an LM
        # iteration at 400k observations; see scripts/ba_profile.py)
        Sg = problem.pose_gather  # (P, S)
        ps_mask = (Sg >= 0)
        Tg = problem.pt_gather  # (M, T)
        pt_mask = (Tg >= 0)

        def to_ps(v):
            g = jnp.take(v, jnp.maximum(Sg, 0).reshape(-1), axis=0)
            g = g.reshape(Sg.shape + v.shape[1:])
            m = ps_mask.reshape(ps_mask.shape + (1,) * (v.ndim - 1))
            return g * m.astype(g.dtype)

        def to_pt(v):
            g = jnp.take(v, jnp.maximum(Tg, 0).reshape(-1), axis=0)
            g = g.reshape(Tg.shape + v.shape[1:])
            m = pt_mask.reshape(pt_mask.shape + (1,) * (v.ndim - 1))
            return g * m.astype(g.dtype)

        Jp_l = to_ps(Jp)  # (P, S, 2, 6)
        Jx_l = to_ps(Jx)
        r_l = to_ps(r)  # (P, S, 2)
        Jx_pm = to_pt(Jx)  # (M, T, 2, 3)
        r_pm = to_pt(r)

        # point/camera axes are replicated across shards: their block
        # reductions see only the local observation slice -> psum totals
        # them. Pose reductions are shard-local (pose axis is the shard).
        Hxx = _psum(jnp.einsum("mtki,mtkj->mij", Jx_pm, Jx_pm),
                    axis_name)  # (M, 3, 3)
        gx = _psum(jnp.einsum("mtki,mtk->mi", Jx_pm, r_pm),
                   axis_name)  # (M, 3)
        Hpp = jnp.einsum("pski,pskj->pij", Jp_l, Jp_l)  # (P, 6, 6)
        gp = jnp.einsum("pski,psk->pi", Jp_l, r_l)
        if use_cam:
            Jc_l = to_ps(Jc)
            # every pose has one camera: reduce camera contributions
            # pose-first through the tiny (P, C) one-hot
            pose_cam = problem.pose_cam_idx  # (P,)
            pose_cam_oh = (pose_cam[:, None]
                           == jnp.arange(C)[None, :]).astype(Jc_l.dtype)
            Hcc = _psum(jnp.einsum("pc,pij->cij", pose_cam_oh,
                                   jnp.einsum("pski,pskj->pij", Jc_l, Jc_l)),
                        axis_name)
            gc = _psum(jnp.einsum("pc,pi->ci", pose_cam_oh,
                                  jnp.einsum("pski,psk->pi", Jc_l, r_l)),
                       axis_name)
        else:
            Hcc = jnp.zeros((C, 12, 12), Jc.dtype)
            gc = jnp.zeros((C, 12), Jc.dtype)

        dHxx = jnp.maximum(jnp.diagonal(Hxx, axis1=-2, axis2=-1), 1e-6)
        Hxx_inv = _inv3x3_sym(Hxx + lam * dHxx[..., None] * eye3
                              + 1e-8 * eye3)

        ptidx_l = problem.ps_point_idx  # (P, S)
        gidx = problem.pt_gather_ps  # (M, T) into P*S
        gmask = (gidx >= 0)

        dHpp = jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6)
        dHcc = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6)
        # true SCHUR_JACOBI preconditioner (reference: ceres schur_jacobi):
        # S[p,p] = Hpp[p] - sum_s W_s Hxx^-1 W_s^T, all in pose-major
        W_l = jnp.einsum("pski,pskj->psij", Jp_l, Jx_l)  # (P, S, 6, 3)
        WV = jnp.einsum("psij,psjk->psik", W_l, Hxx_inv[ptidx_l])
        S_self = jnp.einsum("psik,psjk->pij", WV, W_l)  # (P, 6, 6)
        Hpp_prec = Hpp - S_self + lam * dHpp[..., None] * eye6 + 1e-8 * eye6
        Hcc_prec = Hcc + lam * dHcc[..., None] * eye12 + 1e-8 * eye12
        Hpp_prec_inv = jnp.linalg.inv(Hpp_prec)
        Hcc_prec_inv = jnp.linalg.inv(Hcc_prec)

        def S_matvec(u_pose, u_cam):
            a = jnp.einsum("pski,pi->psk", Jp_l, u_pose)
            if use_cam:
                a = a + jnp.einsum("pski,pi->psk", Jc_l, u_cam[pose_cam])
            q = jnp.einsum("pski,psk->psi", Jx_l, a).reshape(-1, 3)
            gv = jnp.take(q, jnp.maximum(gidx, 0).reshape(-1), axis=0)
            gv = gv.reshape(gidx.shape + (3,))
            # per-point reduce: local track slice only -> psum totals
            v = _psum(jnp.sum(gv * gmask[..., None], axis=1),
                      axis_name)  # (M, 3)
            wv = jnp.einsum("mij,mj->mi", Hxx_inv, v)
            b = a - jnp.einsum("pski,psi->psk", Jx_l, wv[ptidx_l])
            out_pose = jnp.einsum("pski,psk->pi", Jp_l, b) \
                + lam * dHpp * u_pose + 1e-8 * u_pose
            if use_cam:
                contrib = jnp.einsum("pski,psk->pi", Jc_l, b)  # (P, 12)
                out_cam = _psum(jnp.einsum("pc,pi->ci", pose_cam_oh,
                                           contrib), axis_name) \
                    + lam * dHcc * u_cam + 1e-8 * u_cam
            else:
                out_cam = u_cam
            return out_pose, out_cam
    else:
        # segment-sum path (distributed shards / layout-less problems):
        # N-major block reductions
        Hxx = point_reduce(jnp.einsum("nki,nkj->nij", Jx, Jx))  # (M, 3, 3)
        gx = point_reduce(jnp.einsum("nki,nk->ni", Jx, r))
        Hpp = pose_reduce(jnp.einsum("nki,nkj->nij", Jp, Jp))  # (P, 6, 6)
        Hcc = cam_reduce(jnp.einsum("nki,nkj->nij", Jc, Jc))
        gp = pose_reduce(jnp.einsum("nki,nk->ni", Jp, r))
        gc = cam_reduce(jnp.einsum("nki,nk->ni", Jc, r))

        dHxx = jnp.maximum(jnp.diagonal(Hxx, axis1=-2, axis2=-1), 1e-6)
        Hxx_inv = _inv3x3_sym(Hxx + lam * dHxx[..., None] * eye3
                              + 1e-8 * eye3)
        dHpp = jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6)
        dHcc = jnp.maximum(jnp.diagonal(Hcc, axis1=-2, axis2=-1), 1e-6)
        # SCHUR_JACOBI self term, N-major
        W = jnp.einsum("nki,nkj->nij", Jp, Jx)  # (N, 6, 3)
        WV = jnp.einsum("nij,njk->nik", W, Hxx_inv[problem.obs_point_idx])
        S_self = pose_reduce(jnp.einsum("nik,njk->nij", WV, W))
        Hpp_prec = Hpp - S_self + lam * dHpp[..., None] * eye6 + 1e-8 * eye6
        Hcc_prec = Hcc + lam * dHcc[..., None] * eye12 + 1e-8 * eye12
        Hpp_prec_inv = jnp.linalg.inv(Hpp_prec)
        Hcc_prec_inv = jnp.linalg.inv(Hcc_prec)

        def S_matvec(u_pose, u_cam):
            # a_k = Jp u[p] + Jc u[c]                    (N, 2)
            a = jnp.einsum("nki,ni->nk", Jp, u_pose[problem.obs_pose_idx]) \
                + jnp.einsum("nki,ni->nk", Jc, u_cam[problem.obs_cam_idx])
            # v_m = sum Jx^T a                           (M, 3)
            v = point_reduce(jnp.einsum("nki,nk->ni", Jx, a))
            wv = jnp.einsum("mij,mj->mi", Hxx_inv, v)
            b = a - jnp.einsum("nki,ni->nk", Jx, wv[problem.obs_point_idx])
            out_pose = pose_reduce(jnp.einsum("nki,nk->ni", Jp, b)) \
                + lam * dHpp * u_pose + 1e-8 * u_pose
            out_cam = cam_reduce(jnp.einsum("nki,nk->ni", Jc, b)) \
                + lam * dHcc * u_cam + 1e-8 * u_cam
            return out_pose, out_cam

    # reduced RHS: -g_cam + W Hxx^-1 g_x
    hg = jnp.einsum("mij,mj->mi", Hxx_inv, gx)  # (M, 3)
    if use_ps:
        # b_k correction term in pose-major
        t_ps = jnp.einsum("pski,psi->psk", Jx_l, hg[ptidx_l])  # (P, S, 2)
        rhs_pose = -gp + jnp.einsum("pski,psk->pi", Jp_l, t_ps)
        if use_cam:
            rhs_cam = -gc + _psum(jnp.einsum(
                "pc,pi->ci", pose_cam_oh,
                jnp.einsum("pski,psk->pi", Jc_l, t_ps)), axis_name)
        else:
            rhs_cam = -gc
    else:
        # b_k correction term: Jcam^T Jx Hxx^-1 gx
        t = jnp.einsum("nki,ni->nk", Jx, hg[problem.obs_point_idx])  # (N, 2)
        rhs_pose = -gp + pose_reduce(jnp.einsum("nki,nk->ni", Jp, t))
        rhs_cam = -gc + cam_reduce(jnp.einsum("nki,nk->ni", Jc, t))

    def precond(u_pose, u_cam):
        return (
            jnp.einsum("pij,pj->pi", Hpp_prec_inv, u_pose),
            jnp.einsum("cij,cj->ci", Hcc_prec_inv, u_cam),
        )

    def dot(a, b):
        # pose vectors are sharded in the pose-sharded distributed regime
        # (each shard holds P/n rows) while camera vectors are replicated:
        # the pose part psums, the camera part is identical on every shard.
        dp = jnp.sum(a[0] * b[0])
        if pose_sharded:
            dp = jax.lax.psum(dp, axis_name)
        return dp + jnp.sum(a[1] * b[1])

    # ---- PCG --------------------------------------------------------------
    x0 = (jnp.zeros((P, 6), r.dtype), jnp.zeros((C, 12), r.dtype))
    r0 = (rhs_pose, rhs_cam)
    z0 = precond(*r0)
    p0 = z0

    def cg_body(_, carry):
        x, rr, z, p, rz = carry
        Ap = S_matvec(*p)
        pAp = dot(p, Ap)
        alpha = rz / jnp.where(jnp.abs(pAp) > 1e-20, pAp, 1e-20)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
        z = precond(*rr)
        rz_new = dot(rr, z)
        beta = rz_new / jnp.where(jnp.abs(rz) > 1e-20, rz, 1e-20)
        p = (z[0] + beta * p[0], z[1] + beta * p[1])
        return (x, rr, z, p, rz_new)

    n_cg = options.cg_iterations if cg_iters is None else cg_iters
    rz0 = dot(r0, z0)
    if options.cg_tolerance > 0:
        # truncated CG: rz = r^T M^-1 r is the squared M-inverse-norm of
        # the residual; stop once it drops below eta^2 * its start value.
        # This is an eta-style forcing tolerance on the preconditioned
        # residual norm (ceres uses eta as a Q-criterion — relative
        # decrease of the CG quadratic model — this is the classical
        # r-ratio variant).
        thresh = (options.cg_tolerance ** 2) * rz0

        def cg_cond(carry):
            i, (_, _, _, _, rz) = carry
            return (i < n_cg) & (rz > thresh)

        _, (x, _, _, _, _) = jax.lax.while_loop(
            cg_cond,
            lambda c: (c[0] + 1, cg_body(c[0], c[1])),
            (jnp.int32(0), (x0, r0, z0, p0, rz0)),
        )
    else:
        x, _, _, _, _ = jax.lax.fori_loop(
            0, n_cg, cg_body, (x0, r0, z0, p0, rz0)
        )
    du_pose, du_cam = x

    # ---- back-substitute point updates ------------------------------------
    if use_ps:
        a_ps = jnp.einsum("pski,pi->psk", Jp_l, du_pose)
        if use_cam:
            a_ps = a_ps + jnp.einsum("pski,pi->psk", Jc_l, du_cam[pose_cam])
        a_flat = a_ps.reshape(-1, 2)
        a_pm = jnp.take(a_flat, jnp.maximum(gidx, 0).reshape(-1), axis=0)
        a_pm = a_pm.reshape(gidx.shape + (2,)) * gmask[..., None]
        rhs_x = -gx - _psum(jnp.einsum("mtki,mtk->mi", Jx_pm, a_pm),
                            axis_name)
    else:
        a = jnp.einsum("nki,ni->nk", Jp, du_pose[problem.obs_pose_idx]) \
            + jnp.einsum("nki,ni->nk", Jc, du_cam[problem.obs_cam_idx])
        rhs_x = -gx - point_reduce(jnp.einsum("nki,nk->ni", Jx, a))
    dx = jnp.einsum("mij,mj->mi", Hxx_inv, rhs_x)

    # apply masks (frozen dofs stay put even with numerical noise)
    du_pose = du_pose * problem.pose_mask
    du_cam = du_cam * problem.cam_mask
    dx = dx * problem.point_mask

    # ---- trial state + accept/reject ---------------------------------------
    new_poses = rigid3.exp_update(problem.poses, du_pose)
    new_cams = problem.cam_params + du_cam
    new_points = problem.points + dx
    trial = problem._replace(poses=new_poses, cam_params=new_cams, points=new_points)

    new_cost = compute_cost(trial, options)
    if axis_name is not None:
        # compute_cost sums the local observation shard; psum totals it.
        new_cost = jax.lax.psum(new_cost, axis_name)
    cur_cost = state.cost

    accept = new_cost < cur_cost
    lam_new = jnp.where(
        accept,
        jnp.maximum(lam * 0.3333, options.min_lambda),
        jnp.minimum(lam * 4.0, options.max_lambda),
    )

    def pick(a, b):
        return jax.tree.map(lambda x, y: jnp.where(accept, x, y), a, b)

    next_problem = pick(trial, problem)
    next_cost = jnp.where(accept, new_cost, cur_cost)
    # function_tolerance is evaluated on ACCEPTED steps only (ceres
    # semantics): a REJECTED trial whose cost happens to land within tol of
    # the current cost means the damped step shrank to nothing — LM must
    # raise lambda and retry, not terminate. Rejected steps report inf.
    rel = jnp.abs(cur_cost - new_cost) / jnp.maximum(cur_cost, 1e-20)
    return LMState(
        problem=next_problem,
        lam=lam_new,
        cost=next_cost,
        iteration=state.iteration + 1,
        rel_change=jnp.where(accept, rel, jnp.asarray(jnp.inf, rel.dtype)),
    )


def run_lm(state: LMState, options: BAOptions,
           axis_name: Optional[str] = None,
           max_iters=None, cg_iters=None, function_tol=None) -> LMState:
    """The LM iteration loop (traceable; shared by solve/solve_distributed).

    With function_tolerance > 0 this is a while_loop that exits as soon as
    an accepted step improves the cost by less than the tolerance (or the
    damping saturates with no accepted step) — the analog of ceres
    function_tolerance termination, and the main reason intermediate global
    BAs inside the mapper are cheap once the model is nearly converged.

    `max_iters` / `cg_iters` / `function_tol` optionally override the
    corresponding options fields with TRACED scalars, keeping the
    iteration budget and tolerance out of the program hash (one compiled
    BA program per shape class instead of one per (shape, budget) pair).
    """
    mi = options.max_iterations if max_iters is None else max_iters
    if options.function_tolerance <= 0:
        def body(_, s):
            return lm_step(s, options, axis_name, cg_iters=cg_iters)

        return jax.lax.fori_loop(0, mi, body, state)

    tol = options.function_tolerance if function_tol is None else function_tol
    if state.rel_change is None:
        state = state._replace(
            rel_change=jnp.asarray(jnp.inf, state.cost.dtype))

    def cond(s):
        stuck = s.lam >= options.max_lambda * 0.999
        # cost < tol is the absolute-zero escape: a squared-pixel cost
        # below the tolerance is exactly converged for any real problem
        # (without it, a start at the optimum ramps lambda for ~15 iters)
        converged = (s.rel_change < tol) | stuck | (s.cost < tol)
        return (s.iteration < mi) & ~converged

    return jax.lax.while_loop(
        cond, lambda s: lm_step(s, options, axis_name, cg_iters=cg_iters),
        state)


def init_state(problem: BAProblem, options: BAOptions,
               axis_name: Optional[str] = None) -> LMState:
    cost0 = compute_cost(problem, options)
    if axis_name is not None:
        cost0 = jax.lax.psum(cost0, axis_name)
    return LMState(
        problem=problem,
        lam=jnp.asarray(options.initial_lambda, problem.poses.dtype),
        cost=cost0,
        iteration=jnp.asarray(0, jnp.int32),
        rel_change=jnp.asarray(jnp.inf, cost0.dtype),
    )


@partial(jax.jit, static_argnames=("options", "axis_name"))
def solve(problem: BAProblem, options: BAOptions, axis_name: Optional[str] = None) -> LMState:
    """Run up to `options.max_iterations` LM iterations (fully on device)."""
    return run_lm(init_state(problem, options, axis_name), options, axis_name)


# ---------------------------------------------------------------------------
# Problem construction helpers (host side)
# ---------------------------------------------------------------------------


def build_gather_layouts(obs_point_idx, obs_pose_idx, obs_cam_idx,
                         obs_weight, M: int, P: int, C: int,
                         max_pad_ratio: float = 8.0,
                         max_slots: int = 4_000_000):
    """Host-side construction of the scatter-free reduction layouts.

    Returns (pt_gather (M, T), pose_gather (P, S), pose_cam_idx (P,),
    pt_gather_ps, ps_point_idx) as numpy arrays, or all-None when padding
    would blow up memory (heavily skewed per-pose observation counts).

    `max_slots` bounds the ABSOLUTE padded-layout size: the pose-major CG
    path materializes several (P, S, 2, 6..12) float32 arrays (~170 bytes
    per slot), so an uncapped 8x pad ratio at 1M+ observations would
    allocate multiple GB of device memory — large problems fall back to the
    segment-sum path instead of OOMing mid-run.
    """
    import numpy as np

    pt = np.asarray(obs_point_idx)
    po = np.asarray(obs_pose_idx)
    cam = np.asarray(obs_cam_idx)
    w = np.asarray(obs_weight)
    n = len(pt)
    live = w > 0

    def layout(idx, num_rows):
        counts = np.bincount(idx[live], minlength=num_rows)
        t = int(counts.max()) if len(counts) else 1
        t = max(t, 1)
        t = 1 << (t - 1).bit_length()  # next pow2 (stable jit buckets)
        if t * num_rows > min(max_pad_ratio * max(n, 1), max_slots):
            return None
        out = np.full((num_rows, t), -1, np.int32)
        order = np.argsort(idx[live], kind="stable")
        flat_idx = np.nonzero(live)[0][order]
        sorted_rows = idx[live][order]
        offsets = np.searchsorted(sorted_rows, np.arange(num_rows))
        col = np.arange(len(flat_idx)) - offsets[sorted_rows]
        out[sorted_rows, col] = flat_idx
        return out

    pt_g = layout(pt, M)
    pose_g = layout(po, P)
    if pt_g is None or pose_g is None:
        return None, None, None, None, None
    # camera of each pose (from any live observation; poses with no live
    # observations map to camera 0 — their reduced contributions are zero)
    pose_cam = np.zeros(P, np.int32)
    if live.any():
        pose_cam[po[live]] = cam[live]
    # pose-major companions: position of each obs in the (P*S) space
    S = pose_g.shape[1]
    pos_in_ps = np.full(n, -1, np.int64)
    rows, cols = np.nonzero(pose_g >= 0)
    pos_in_ps[pose_g[rows, cols]] = rows * S + cols
    pt_g_ps = np.where(pt_g >= 0, pos_in_ps[np.maximum(pt_g, 0)], -1
                       ).astype(np.int32)
    ps_point = np.where(pose_g >= 0, pt[np.maximum(pose_g, 0)], 0
                        ).astype(np.int32)
    return pt_g, pose_g, pose_cam, pt_g_ps, ps_point


def layout_widths(obs_point_idx, obs_pose_idx, obs_weight, M: int, P: int,
                  max_pad_ratio: float = 8.0, max_slots: int = 4_000_000):
    """Host-side (cheap: two bincounts) computation of the gather-layout
    widths (T, S) for device-side layout construction, or None when the
    padded layouts would blow past the memory caps (same policy as
    build_gather_layouts)."""
    import numpy as np

    live = np.asarray(obs_weight) > 0
    n = len(live)

    def width(idx, rows):
        counts = np.bincount(np.asarray(idx)[live], minlength=rows)
        t = max(int(counts.max()) if len(counts) else 1, 1)
        t = 1 << (t - 1).bit_length()
        if t * rows > min(max_pad_ratio * max(n, 1), max_slots):
            return None
        return t

    T = width(obs_point_idx, M)
    S = width(obs_pose_idx, P)
    if T is None or S is None:
        return None
    return T, S


def _layout_device(idx, live, num_rows: int, width: int):
    """Traced equivalent of build_gather_layouts' layout(): a (num_rows,
    width) table of observation indices per row, -1-padded. Dead
    observations sort to a virtual trash row and are dropped by the
    out-of-bounds scatter."""
    n = idx.shape[0]
    key = jnp.where(live, idx.astype(jnp.int32), num_rows)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)
    sorted_rows = key[order]
    offsets = jnp.searchsorted(sorted_rows,
                               jnp.arange(num_rows, dtype=jnp.int32))
    col = jnp.arange(n, dtype=jnp.int32) - offsets[sorted_rows].astype(
        jnp.int32)
    out = jnp.full((num_rows, width), -1, jnp.int32)
    return out.at[sorted_rows, col].set(order, mode="drop")


def build_gather_layouts_traced(obs_point_idx, obs_pose_idx, obs_cam_idx,
                                obs_weight, M: int, P: int, T: int, S: int):
    """Device-side construction of the scatter-free reduction layouts —
    the traced twin of build_gather_layouts. Shipping only the raw index
    arrays and rebuilding the four big tables on device cuts the packed
    i32 upload by ~3.5x and drops
    the per-BA host argsorts."""
    live = obs_weight > 0
    n = obs_point_idx.shape[0]
    pt_g = _layout_device(obs_point_idx, live, M, T)
    pose_g = _layout_device(obs_pose_idx, live, P, S)
    pose_cam = jnp.zeros(P, jnp.int32).at[
        jnp.where(live, obs_pose_idx, P)].set(obs_cam_idx.astype(jnp.int32),
                                              mode="drop")
    flat = pose_g.reshape(-1)
    pos_in_ps = jnp.full(n, -1, jnp.int32).at[
        jnp.where(flat >= 0, flat, n)].set(
            jnp.arange(P * S, dtype=jnp.int32), mode="drop")
    pt_g_ps = jnp.where(pt_g >= 0, pos_in_ps[jnp.maximum(pt_g, 0)], -1)
    ps_point = jnp.where(pose_g >= 0,
                         obs_point_idx.astype(jnp.int32)[
                             jnp.maximum(pose_g, 0)], 0)
    return pt_g, pose_g, pose_cam, pt_g_ps, ps_point


class PackedMeta(NamedTuple):
    """Static shape descriptor of a flattened BAProblem (hashable: one jit
    specialization per shape class). T/S = gather-layout widths; T == 0
    means no scatter-free layouts (segment-sum fallback). `dev` = the
    layout tables are NOT in ibuf and are rebuilt on device by
    unflatten_problem."""

    N: int
    P: int
    C: int
    M: int
    T: int
    S: int
    dev: bool = False


def flatten_problem(problem: BAProblem, device_layouts: bool = False):
    """Pack a (host-side) BAProblem into ONE float32 + ONE int32 buffer.

    Every jit argument is its own host->device transfer; packing 16
    problem arrays into 2 buffers makes a BA call 3 transfers (f32 + i32 +
    packed result) instead of ~17. Accepts numpy or device arrays.

    `device_layouts` omits the four big gather tables from ibuf; only
    their widths (computed host-side from two bincounts) ride in the meta
    and unflatten_problem rebuilds the tables on device — the ibuf upload
    shrinks from 3N + P + 2MT + 2PS to 3N entries.
    """
    import numpy as np

    def f(a):
        return np.asarray(a, np.float32).reshape(-1)

    def i(a):
        return np.asarray(a, np.int32).reshape(-1)

    N = int(problem.obs_xy.shape[0])
    P = int(problem.poses.shape[0])
    C = int(problem.cam_params.shape[0])
    M = int(problem.points.shape[0])

    fparts = [f(problem.poses), f(problem.cam_params), f(problem.points),
              f(problem.obs_xy), f(problem.obs_weight),
              f(problem.pose_mask), f(problem.cam_mask),
              f(problem.point_mask)]
    iparts = [i(problem.obs_pose_idx), i(problem.obs_cam_idx),
              i(problem.obs_point_idx)]
    if device_layouts:
        ts = layout_widths(problem.obs_point_idx, problem.obs_pose_idx,
                           problem.obs_weight, M, P)
        if ts is None:
            T = S = 0  # segment-sum fallback
            dev = False
        else:
            T, S = ts
            dev = True
        return (np.concatenate(fparts), np.concatenate(iparts),
                PackedMeta(N=N, P=P, C=C, M=M, T=T, S=S, dev=dev))

    has_layouts = problem.pt_gather is not None
    T = int(problem.pt_gather.shape[1]) if has_layouts else 0
    S = int(problem.pose_gather.shape[1]) if has_layouts else 0
    if has_layouts:
        iparts += [i(problem.pose_cam_idx), i(problem.pt_gather),
                   i(problem.pose_gather), i(problem.pt_gather_ps),
                   i(problem.ps_point_idx)]
    return (np.concatenate(fparts), np.concatenate(iparts),
            PackedMeta(N=N, P=P, C=C, M=M, T=T, S=S))


def unflatten_problem(fbuf, ibuf, meta: PackedMeta) -> BAProblem:
    """Rebuild the BAProblem from the packed buffers (traceable: all
    offsets are static)."""
    N, P, C, M, T, S = meta[:6]

    def cut(buf, off, shape):
        size = 1
        for d in shape:
            size *= d
        return buf[off: off + size].reshape(shape), off + size

    off = 0
    poses, off = cut(fbuf, off, (P, 7))
    cam_params, off = cut(fbuf, off, (C, 12))
    points, off = cut(fbuf, off, (M, 3))
    obs_xy, off = cut(fbuf, off, (N, 2))
    obs_weight, off = cut(fbuf, off, (N,))
    pose_mask, off = cut(fbuf, off, (P, 6))
    cam_mask, off = cut(fbuf, off, (C, 12))
    point_mask, off = cut(fbuf, off, (M, 3))

    ioff = 0
    obs_pose_idx, ioff = cut(ibuf, ioff, (N,))
    obs_cam_idx, ioff = cut(ibuf, ioff, (N,))
    obs_point_idx, ioff = cut(ibuf, ioff, (N,))
    pt_gather = pose_gather = pose_cam_idx = pt_gather_ps = ps_point_idx = None
    if getattr(meta, "dev", False):
        (pt_gather, pose_gather, pose_cam_idx, pt_gather_ps,
         ps_point_idx) = build_gather_layouts_traced(
            obs_point_idx, obs_cam_idx=obs_cam_idx,
            obs_pose_idx=obs_pose_idx, obs_weight=obs_weight,
            M=M, P=P, T=T, S=S)
    elif T > 0:
        pose_cam_idx, ioff = cut(ibuf, ioff, (P,))
        pt_gather, ioff = cut(ibuf, ioff, (M, T))
        pose_gather, ioff = cut(ibuf, ioff, (P, S))
        pt_gather_ps, ioff = cut(ibuf, ioff, (M, T))
        ps_point_idx, ioff = cut(ibuf, ioff, (P, S))
    return BAProblem(
        poses=poses, cam_params=cam_params, points=points,
        obs_pose_idx=obs_pose_idx, obs_cam_idx=obs_cam_idx,
        obs_point_idx=obs_point_idx, obs_xy=obs_xy, obs_weight=obs_weight,
        pose_mask=pose_mask, cam_mask=cam_mask, point_mask=point_mask,
        pt_gather=pt_gather, pose_gather=pose_gather,
        pose_cam_idx=pose_cam_idx, pt_gather_ps=pt_gather_ps,
        ps_point_idx=ps_point_idx,
    )


def make_problem(
    poses,
    cam_params,
    points,
    obs_pose_idx,
    obs_cam_idx,
    obs_point_idx,
    obs_xy,
    obs_weight=None,
    fix_poses=(),
    fix_first_pose_and_gauge: bool = False,
    refine_intrinsics: bool = False,
    refine_extra_params: bool = False,
    refine_principal_point: bool = False,
    camera_model_ids=None,
    dtype=jnp.float32,
    as_numpy: bool = False,
    skip_layouts: bool = False,
) -> BAProblem:
    """Build a BAProblem from numpy/JAX arrays with COLMAP-like gauge defaults.

    `fix_first_pose_and_gauge` reproduces the reference's global-BA gauge:
    the first pose is fully fixed and the second pose's tx is fixed
    (reference bundle_adjustment.cc gauge handling).

    `as_numpy=True` keeps every field a host numpy array (no transfers) —
    the input to `flatten_problem`, which ships the whole problem to the
    device as two packed buffers.
    """
    import numpy as np

    xp = np if as_numpy else jnp
    np_dtype = np.float32 if dtype == jnp.float32 else np.float64
    if as_numpy:
        dtype = np_dtype
    poses = xp.asarray(poses, dtype)
    cam_params = xp.asarray(cam_params, dtype)
    points = xp.asarray(points, dtype)
    P, C, M = poses.shape[0], cam_params.shape[0], points.shape[0]

    if obs_weight is None:
        obs_weight = xp.ones(len(obs_xy), dtype)

    pose_mask = np.ones((P, 6), np.float32)
    for i in fix_poses:
        pose_mask[i] = 0.0
    if fix_first_pose_and_gauge and P >= 2:
        pose_mask[0] = 0.0
        pose_mask[1, 3] = 0.0  # tx of second pose
    cam_mask = np.zeros((C, 12), np.float32)
    if camera_model_ids is not None:
        # reference BA defaults: refine focal (+extra params when asked),
        # keep the principal point FIXED unless explicitly requested
        from colmap_tpu.sensor import models as _cm

        for c in range(C):
            if refine_intrinsics:
                cam_mask[c] = _cm.refine_mask(
                    int(camera_model_ids[c]), focal=True,
                    principal_point=refine_principal_point,
                    extra=refine_extra_params)
    else:
        if refine_intrinsics:
            cam_mask[:, :4] = 1.0
        if refine_extra_params:
            cam_mask[:, 4:] = 1.0

    if skip_layouts:
        # caller flattens with device_layouts=True: the tables are rebuilt
        # on device from the index arrays (build_gather_layouts_traced)
        pt_g = pose_g = pose_cam = pt_g_ps = ps_point = None
    else:
        pt_g, pose_g, pose_cam, pt_g_ps, ps_point = build_gather_layouts(
            obs_point_idx, obs_pose_idx, obs_cam_idx, np.asarray(obs_weight),
            M, P, C)

    return BAProblem(
        poses=poses,
        cam_params=cam_params,
        points=points,
        obs_pose_idx=xp.asarray(obs_pose_idx, xp.int32),
        obs_cam_idx=xp.asarray(obs_cam_idx, xp.int32),
        obs_point_idx=xp.asarray(obs_point_idx, xp.int32),
        obs_xy=xp.asarray(obs_xy, dtype),
        obs_weight=xp.asarray(obs_weight, dtype),
        pose_mask=xp.asarray(pose_mask, dtype),
        cam_mask=xp.asarray(cam_mask, dtype),
        point_mask=xp.ones((M, 3), dtype),
        pt_gather=None if pt_g is None else xp.asarray(pt_g),
        pose_gather=None if pose_g is None else xp.asarray(pose_g),
        pose_cam_idx=None if pose_cam is None else xp.asarray(pose_cam),
        pt_gather_ps=None if pt_g_ps is None else xp.asarray(pt_g_ps),
        ps_point_idx=None if ps_point is None else xp.asarray(ps_point),
    )
