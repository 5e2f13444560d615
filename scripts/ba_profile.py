"""Per-stage device timing of one LM iteration of the BA engine.

Times cumulative sub-programs of lm_step inside a 10-iteration fori loop
(amortizes dispatch overhead), so consecutive-row differences are the
device cost of each stage at the given problem shape.

    python scripts/ba_profile.py [--poses 256 --points 2048 --obs_per_point 200]
"""

import argparse
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--poses", type=int, default=256)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--obs_per_point", type=int, default=200)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from colmap_tpu.estimators import bundle_adjustment as ba
    from __graft_entry__ import _build_problem

    problem, options = _build_problem(num_poses=args.poses,
                                      num_points=args.points,
                                      obs_per_point=args.obs_per_point,
                                      seed=7)
    options = ba.BAOptions(max_iterations=args.iters, cg_iterations=1,
                           loss="cauchy", camera_model_id=2,
                           refine_intrinsics=False, function_tolerance=0.0)
    N = problem.obs_xy.shape[0]
    P = problem.poses.shape[0]
    C = problem.cam_params.shape[0]
    M = problem.points.shape[0]
    lam = jnp.float32(1e-4)

    def stage_fn(stage):
        def step(pr):
            use_cam = False
            r, Jp, Jc, Jx = ba._obs_residual_and_jac(pr, 2, with_cam=use_cam)
            acc = r.sum() + Jp.sum() + Jx.sum()
            if stage == "jac":
                return acc
            point_reduce, pose_reduce, cam_reduce = ba._make_reducers(
                pr, None, P, C, M)
            r2 = jnp.sum(r * r, axis=-1)
            w = ba._robust_weight(r2, "cauchy", 1.0) * pr.obs_weight
            sw = jnp.sqrt(jnp.maximum(w, 0.0))[:, None]
            r = r * sw
            Jp = Jp * sw[..., None] * pr.pose_mask[pr.obs_pose_idx][:, None, :]
            Jx = Jx * sw[..., None] * pr.point_mask[pr.obs_point_idx][:, None, :]
            Hxx = point_reduce(jnp.einsum("nki,nkj->nij", Jx, Jx))
            gx = point_reduce(jnp.einsum("nki,nk->ni", Jx, r))
            Hpp = pose_reduce(jnp.einsum("nki,nkj->nij", Jp, Jp))
            gp = pose_reduce(jnp.einsum("nki,nk->ni", Jp, r))
            acc = Hxx.sum() + gx.sum() + Hpp.sum() + gp.sum()
            if stage == "reduce":
                return acc
            eye3 = jnp.eye(3, dtype=Hxx.dtype)
            dHxx = jnp.maximum(jnp.diagonal(Hxx, axis1=-2, axis2=-1), 1e-6)
            Hxx_inv = ba._inv3x3_sym(Hxx + lam * dHxx[..., None] * eye3
                                     + 1e-8 * eye3)
            eye6 = jnp.eye(6, dtype=Hpp.dtype)
            dHpp = jnp.maximum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), 1e-6)
            W = jnp.einsum("nki,nkj->nij", Jp, Jx)
            WV = jnp.einsum("nij,njk->nik", W, Hxx_inv[pr.obs_point_idx])
            S_self = pose_reduce(jnp.einsum("nik,njk->nij", WV, W))
            Hpp_prec = Hpp - S_self + lam * dHpp[..., None] * eye6 + 1e-8 * eye6
            Hpp_prec_inv = jnp.linalg.inv(Hpp_prec)
            acc = acc + Hxx_inv.sum() + Hpp_prec_inv.sum()
            if stage == "prec":
                return acc
            Sg = pr.pose_gather
            ps_mask = (Sg >= 0)

            def to_ps(v):
                g = jnp.take(v, jnp.maximum(Sg, 0).reshape(-1), axis=0)
                g = g.reshape(Sg.shape + v.shape[1:])
                m = ps_mask.reshape(ps_mask.shape + (1,) * (v.ndim - 1))
                return g * m.astype(g.dtype)

            Jp_l = to_ps(Jp)
            Jx_l = to_ps(Jx)
            acc = acc + Jp_l.sum() + Jx_l.sum()
            if stage == "to_ps":
                return acc
            # one CG matvec through the pose-major operator
            gidx = pr.pt_gather_ps
            gmask = (gidx >= 0)
            u_pose = gp
            a = jnp.einsum("pski,pi->psk", Jp_l, u_pose)
            q = jnp.einsum("pski,psk->psi", Jx_l, a).reshape(-1, 3)
            gv = jnp.take(q, jnp.maximum(gidx, 0).reshape(-1), axis=0)
            gv = gv.reshape(gidx.shape + (3,))
            v = jnp.sum(gv * gmask[..., None], axis=1)
            wv = jnp.einsum("mij,mj->mi", Hxx_inv, v)
            b = a - jnp.einsum("pski,psi->psk", Jx_l, wv[pr.ps_point_idx])
            out_pose = jnp.einsum("pski,psk->pi", Jp_l, b)
            acc = acc + out_pose.sum()
            if stage == "matvec":
                return acc
            cost = ba.compute_cost(pr, options)
            return acc + cost

        @jax.jit
        def run(pr):
            def body(_, carry):
                pr2 = pr._replace(poses=pr.poses + 0.0 * carry)
                return step(pr2).astype(jnp.float32)

            return jax.lax.fori_loop(0, args.iters, body, jnp.float32(0))

        return run

    print(f"P={P} C={C} M={M} N={N}, {args.iters} LM iters, cg=1")
    stages = ["jac", "reduce", "prec", "to_ps", "matvec", "cost"]
    prev = 0.0
    for st in stages:
        run = stage_fn(st)
        float(np.asarray(run(problem)))  # compile
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            float(np.asarray(run(problem)))
            ts.append(time.perf_counter() - t0)
        per_iter = min(ts) / args.iters
        print(f"{st:8s} {per_iter * 1e3:8.1f} ms/iter   "
              f"delta {1e3 * (per_iter - prev):7.1f} ms")
        prev = per_iter

    # reference: the real lm_step at cg=1
    @jax.jit
    def real(pr):
        st = ba.init_state(pr, options)
        return ba.run_lm(st, options).cost

    float(np.asarray(real(problem)))
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        float(np.asarray(real(problem)))
        ts.append(time.perf_counter() - t0)
    print(f"{'lm_full':8s} {min(ts) / args.iters * 1e3:8.1f} ms/iter")


if __name__ == "__main__":
    main()
