"""Relative device-scaling curve for the distributed product paths.

Measures BA LM iters/s (pose-sharded distributed solver) and matcher
pairs/s (pair-axis sharded controller program) at mesh sizes 1/2/4/8 on
the virtual CPU mesh — the BASELINE.json "images registered/s and BA
iters/s at 1 device / 1 host / N>=2 hosts" curve, as far as a CPU host
allows.

HONESTY NOTE (recorded in the output): on a host with few CPU cores the
8 "devices" are XLA host-platform threads time-slicing those cores —
wall-clock speedup is bounded by the core count by construction. What
the curve validates is (a) the distributed programs compile + execute at
every mesh size, (b) the collective/padding overhead vs the single-device
program (efficiency = t1 / (n * tn) would be the per-device efficiency on
real devices where each shard runs on its own card), and (c) per-shard work
shrinking with n (reported analytically as flops_per_device).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/scaling_curve.py
"""

import datetime
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def bench_ba_at(n_dev, problem, options, reps=3):
    import jax

    from colmap_tpu.estimators import bundle_adjustment as ba
    from colmap_tpu.parallel import distributed_ba
    from colmap_tpu.parallel.mesh import make_mesh

    if n_dev == 1:
        solve = jax.jit(lambda p: ba.solve(p, options))
        state = solve(problem)
        float(np.asarray(state.cost))  # warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(np.asarray(solve(problem).cost))
            ts.append(time.perf_counter() - t0)
    else:
        mesh = make_mesh(n_dev)
        state = distributed_ba.solve_distributed(problem, options, mesh)
        float(np.asarray(state.cost))  # warm/compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            st = distributed_ba.solve_distributed(problem, options, mesh)
            float(np.asarray(st.cost))
            ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    return options.max_iterations / dt


def bench_matcher_at(n_dev, d1, d2, v1, v2, reps=3):
    import jax

    from colmap_tpu.features import matching as matching_mod
    from colmap_tpu.parallel import sharded_matching as sm
    from colmap_tpu.parallel.mesh import make_mesh

    B = d1.shape[0]
    mesh = make_mesh(n_dev)
    out = sm.match_pair_blocks_sharded(mesh, d1, d2, v1, v2)  # warm
    assert out.shape[0] == B
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sm.match_pair_blocks_sharded(mesh, d1, d2, v1, v2)
        ts.append(time.perf_counter() - t0)
    return B / float(np.median(ts))


def main():
    import jax

    from colmap_tpu.estimators import bundle_adjustment as ba

    n_avail = jax.local_device_count()
    sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]

    # BA problem: 96 poses / 8k points / 48k obs (big enough that per-shard
    # work dominates dispatch, small enough for the 1-core CPU host)
    from __graft_entry__ import _build_problem

    problem, _ = _build_problem(num_poses=96, num_points=8000,
                                obs_per_point=6, seed=7)
    options = ba.BAOptions(max_iterations=5, cg_iterations=15,
                           function_tolerance=0.0, cg_tolerance=0.0,
                           refine_intrinsics=False)
    n_obs = int(problem.obs_xy.shape[0])
    flops_per_lm = options.cg_iterations * 2 * (2 * n_obs * 2 * (6 + 3 + 4))

    rng = np.random.default_rng(0)
    B, N = 16, 1024
    d1 = rng.integers(0, 255, (B, N, 128)).astype(np.uint8)
    d2 = rng.integers(0, 255, (B, N, 128)).astype(np.uint8)
    v1 = np.ones((B, N), bool)
    v2 = np.ones((B, N), bool)

    report = {
        "self_reported": True,
        "produced_by": "python " + " ".join(sys.argv),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "host_physical_cores": os.cpu_count(),
        "note": ("virtual CPU mesh on a 1-core host: devices time-slice "
                 "one core, so wall speedup is bounded at ~1x by "
                 "construction; the curve validates the distributed "
                 "programs + measures collective/padding overhead "
                 "(t1/tn would be the speedup on real chips only if each "
                 "device had its own core/chip)"),
        "ba": {"problem": f"{problem.poses.shape[0]} poses / "
                          f"{problem.points.shape[0]} points / {n_obs} obs",
               "unit": "LM iters/s (fixed 5 LM x 15 CG)",
               "curve": {}},
        "matcher": {"problem": f"{B} pairs x {N}^2 descriptors",
                    "unit": "pairs/s",
                    "curve": {}},
    }

    base_ba = None
    for n in sizes:
        r = bench_ba_at(n, problem, options)
        base_ba = base_ba or r
        report["ba"]["curve"][str(n)] = {
            "iters_per_s": round(r, 3),
            "rel_vs_1dev": round(r / base_ba, 3),
            "flops_per_device_per_iter": int(flops_per_lm / n),
        }
        print(f"ba n={n}: {r:.3f} iters/s", flush=True)

    base_m = None
    for n in sizes:
        r = bench_matcher_at(n, d1, d2, v1, v2)
        base_m = base_m or r
        report["matcher"]["curve"][str(n)] = {
            "pairs_per_s": round(r, 2),
            "rel_vs_1dev": round(r / base_m, 3),
        }
        print(f"matcher n={n}: {r:.2f} pairs/s", flush=True)

    if "--out" in sys.argv:
        with open(sys.argv[sys.argv.index("--out") + 1], "w") as fp:
            json.dump(report, fp, indent=2)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
