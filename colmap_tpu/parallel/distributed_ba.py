"""Distributed bundle adjustment: pose-sharded LM over a device mesh.

The reference has no distributed BA (ceres is single-process,
src/colmap/estimators/bundle_adjustment.cc). Here the problem shards
across the mesh data axis via shard_map in one of two regimes:

* **pose-sharded (default, fast)** — each device owns a contiguous block
  of P/n poses plus exactly the observations of those poses, with LOCAL
  pose indices, and rebuilds the pose-major gather layouts on device
  (estimators/bundle_adjustment.build_gather_layouts_traced). Pose block
  reductions (Hpp, gp, the SCHUR_JACOBI preconditioner, the CG pose
  updates) are shard-local; point and camera block reductions psum across
  devices because tracks span shards. This is the same fast LM kernel the
  single-device mapper runs (no segment-sum fallback), just with
  collectives at the replicated axes — per SURVEY.md §2.11's
  "per-shard Hessian assembly + Schur-complement reduction with
  collectives".
* **observation-sharded (fallback)** — parameters replicated, raw
  observation rows split evenly, every reduction a psum over the
  segment-sum path. Used when the padded gather layouts would not fit
  (layout_widths returns None).

The mapper routes global BAs here when the process sees >1 device
(controllers/incremental_pipeline + sfm/incremental_mapper num_devices
option); tests exercise both regimes on the 8-device virtual CPU mesh.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from colmap_tpu.estimators import bundle_adjustment as ba
from colmap_tpu.parallel.mesh import DATA_AXIS, make_mesh, pad_to_multiple


def shard_problem(problem: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """Pad observation arrays so they split evenly across shards
    (observation-sharded fallback regime)."""
    def pad_obs(x, fill=0):
        return jnp.asarray(pad_to_multiple(np.asarray(x), n_shards, fill=fill))

    return problem._replace(
        obs_pose_idx=pad_obs(problem.obs_pose_idx),
        obs_cam_idx=pad_obs(problem.obs_cam_idx),
        obs_point_idx=pad_obs(problem.obs_point_idx),
        obs_xy=pad_obs(problem.obs_xy),
        obs_weight=pad_obs(problem.obs_weight),  # padding rows weight 0
        # no gather layouts: the obs-sharded regime reduces with
        # segment_sum + psum instead
        pt_gather=None,
        pose_gather=None,
        pose_cam_idx=None,
        pt_gather_ps=None,
        ps_point_idx=None,
    )


def shard_problem_by_pose(
    problem: ba.BAProblem, n_shards: int,
    max_pad_ratio: float = 8.0, max_slots: int = 4_000_000,
) -> Optional[Tuple[ba.BAProblem, int, int, int, int]]:
    """Host-side pose partition for the pose-sharded regime.

    Poses split into n contiguous blocks (padded to a multiple of n with
    frozen identity poses); each observation goes to its pose's shard
    with a LOCAL pose index; every shard's observation slice pads to a
    common power-of-two length with weight-0 rows. Returns
    (problem, P_local, N_shard, T, S) where the problem's pose axis is
    the global padded (P_pad, 7) in ORIGINAL pose order and the obs axis
    is (n * N_shard,) grouped by shard — ready for
    PartitionSpec(DATA_AXIS) on both. Returns None when the per-shard
    gather layouts would blow the same memory caps as
    build_gather_layouts (caller falls back to observation sharding).
    """
    poses = np.asarray(problem.poses)
    pose_mask = np.asarray(problem.pose_mask)
    P_orig = poses.shape[0]
    P_pad = -(-P_orig // n_shards) * n_shards
    P_local = P_pad // n_shards
    if P_pad != P_orig:
        pad = P_pad - P_orig
        id_pose = np.zeros((pad, 7), poses.dtype)
        id_pose[:, 0] = 1.0  # identity quaternion
        poses = np.concatenate([poses, id_pose])
        pose_mask = np.concatenate(
            [pose_mask, np.zeros((pad, 6), pose_mask.dtype)])

    obs_pose = np.asarray(problem.obs_pose_idx, np.int64)
    obs_cam = np.asarray(problem.obs_cam_idx, np.int32)
    obs_point = np.asarray(problem.obs_point_idx, np.int32)
    obs_xy = np.asarray(problem.obs_xy)
    obs_w = np.asarray(problem.obs_weight)
    M = int(np.asarray(problem.points).shape[0])

    shard_of = obs_pose // P_local
    local_pose = (obs_pose % P_local).astype(np.int32)
    order = np.argsort(shard_of, kind="stable")
    counts = np.bincount(shard_of, minlength=n_shards)
    n_max = max(int(counts.max()), 1)
    N_shard = 1 << (n_max - 1).bit_length()  # pow2: stable jit buckets

    def scatter(x, fill=0):
        out = np.full((n_shards, N_shard) + x.shape[1:], fill, x.dtype)
        pos = np.arange(len(x)) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
        out[shard_of[order], pos] = x[order]
        return out.reshape((n_shards * N_shard,) + x.shape[1:])

    s_pose = scatter(local_pose)
    s_cam = scatter(obs_cam)
    s_point = scatter(obs_point)
    s_xy = scatter(obs_xy)
    s_w = scatter(obs_w)  # pads fill 0 -> weight-0 rows

    # layout widths: global max over shards so every shard compiles the
    # same program; respect the same memory caps as the host builder
    T = S = 1
    for k in range(n_shards):
        sl = slice(k * N_shard, (k + 1) * N_shard)
        ts = ba.layout_widths(s_point[sl], s_pose[sl], s_w[sl], M, P_local,
                              max_pad_ratio=max_pad_ratio,
                              max_slots=max_slots)
        if ts is None:
            return None
        T = max(T, ts[0])
        S = max(S, ts[1])

    sharded = problem._replace(
        poses=jnp.asarray(poses),
        pose_mask=jnp.asarray(pose_mask),
        obs_pose_idx=jnp.asarray(s_pose),
        obs_cam_idx=jnp.asarray(s_cam),
        obs_point_idx=jnp.asarray(s_point),
        obs_xy=jnp.asarray(s_xy),
        obs_weight=jnp.asarray(s_w),
        pt_gather=None, pose_gather=None, pose_cam_idx=None,
        pt_gather_ps=None, ps_point_idx=None,
    )
    return sharded, P_local, N_shard, T, S


def _specs(pose_sharded: bool):
    """(in_spec for BAProblem, out_spec for LMState)."""
    pose_ax = P(DATA_AXIS) if pose_sharded else P()
    obs_spec = ba.BAProblem(
        poses=pose_ax,
        cam_params=P(),
        points=P(),
        obs_pose_idx=P(DATA_AXIS),
        obs_cam_idx=P(DATA_AXIS),
        obs_point_idx=P(DATA_AXIS),
        obs_xy=P(DATA_AXIS),
        obs_weight=P(DATA_AXIS),
        pose_mask=pose_ax,
        cam_mask=P(),
        point_mask=P(),
    )
    state_spec = ba.LMState(problem=obs_spec, lam=P(), cost=P(),
                            iteration=P(), rel_change=P())
    return obs_spec, state_spec


def solve_distributed(problem: ba.BAProblem, options: ba.BAOptions,
                      mesh: Mesh | None = None) -> ba.LMState:
    """Run LM sharded across the mesh data axis.

    Prefers the pose-sharded gather-layout regime (the fast LM kernel);
    falls back to observation sharding with segment-sum reductions when
    the padded layouts would not fit. The returned state's pose axis is
    sliced back to the original pose count.
    """
    if mesh is None:
        mesh = make_mesh()
    n = mesh.devices.size
    if n == 1:
        return ba.solve(problem, options)

    P_orig = int(np.asarray(problem.poses).shape[0])
    by_pose = shard_problem_by_pose(problem, n)
    if by_pose is not None:
        sharded, P_local, N_shard, T, S = by_pose
        M = int(np.asarray(problem.points).shape[0])
        obs_spec, state_spec = _specs(pose_sharded=True)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(obs_spec,),
            out_specs=state_spec,
            check_vma=False,
        )
        def run(p: ba.BAProblem) -> ba.LMState:
            pt_g, pose_g, pose_cam, pt_g_ps, ps_pt = \
                ba.build_gather_layouts_traced(
                    p.obs_point_idx, p.obs_pose_idx, p.obs_cam_idx,
                    p.obs_weight, M=M, P=P_local, T=T, S=S)
            p = p._replace(pt_gather=pt_g, pose_gather=pose_g,
                           pose_cam_idx=pose_cam, pt_gather_ps=pt_g_ps,
                           ps_point_idx=ps_pt)
            state = ba.init_state(p, options, axis_name=DATA_AXIS)
            state = ba.run_lm(state, options, axis_name=DATA_AXIS)
            # strip the per-shard layout tables from the result pytree
            return state._replace(problem=state.problem._replace(
                pt_gather=None, pose_gather=None, pose_cam_idx=None,
                pt_gather_ps=None, ps_point_idx=None))

        with mesh:
            state = jax.jit(run)(sharded)
        # restore the caller's view: original pose count, original
        # (unpermuted, GLOBAL-index) observation tableau + layouts — the
        # solver only moves poses/cams/points, so the shard-permuted
        # local-index obs arrays must not leak out
        state = state._replace(problem=state.problem._replace(
            poses=state.problem.poses[:P_orig],
            pose_mask=problem.pose_mask,
            obs_pose_idx=problem.obs_pose_idx,
            obs_cam_idx=problem.obs_cam_idx,
            obs_point_idx=problem.obs_point_idx,
            obs_xy=problem.obs_xy,
            obs_weight=problem.obs_weight,
            pt_gather=problem.pt_gather,
            pose_gather=problem.pose_gather,
            pose_cam_idx=problem.pose_cam_idx,
            pt_gather_ps=problem.pt_gather_ps,
            ps_point_idx=problem.ps_point_idx))
        return state

    # fallback: observation sharding, segment-sum reductions
    problem = shard_problem(problem, n)
    obs_spec, state_spec = _specs(pose_sharded=False)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(obs_spec,),
        out_specs=state_spec,
        check_vma=False,
    )
    def run(p: ba.BAProblem) -> ba.LMState:
        state = ba.init_state(p, options, axis_name=DATA_AXIS)
        return ba.run_lm(state, options, axis_name=DATA_AXIS)

    with mesh:
        return jax.jit(run)(problem)
