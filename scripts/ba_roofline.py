"""BA LM-step bytes-roofline: is the solve memory-bound, and how close?

Uses XLA's own cost model (compiled.cost_analysis(): bytes accessed and
flops for the WHOLE solve program) rather than hand-counted array sizes,
so the roofline is checkable against the compiler's actual fusion
decisions. Compares against the card's published peaks (bench.PEAKS,
keyed by device kind); needs a GPU.

    python scripts/ba_roofline.py
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import jax

    from bench import PEAKS, _device
    from colmap_tpu.estimators import bundle_adjustment as ba
    from __graft_entry__ import _build_problem

    peak = PEAKS[_device().device_kind]

    problem, _ = _build_problem(num_poses=500, num_points=50_000,
                                obs_per_point=6, seed=7)
    options = ba.BAOptions(max_iterations=10, cg_iterations=20,
                           function_tolerance=0.0, cg_tolerance=0.0)
    solve = jax.jit(lambda pr: ba.solve(pr, options))
    compiled = solve.lower(problem).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    bytes_total = float(ca.get("bytes accessed", 0.0))
    flops_total = float(ca.get("flops", 0.0))

    jax.block_until_ready(solve(problem).cost)  # warm
    dts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(solve(problem).cost)
        dts.append(time.perf_counter() - t0)
    solve_s = float(np.mean(dts))
    n_lm = options.max_iterations

    per_iter_bytes = bytes_total / n_lm
    per_iter_s = solve_s / n_lm
    bw_gbps = per_iter_bytes / per_iter_s / 1e9
    tflops = flops_total / n_lm / per_iter_s / 1e12
    mem_bound_s = per_iter_bytes / (peak["hbm_tb_per_s"] * 1e12)
    out = {
        "problem": "500 poses / 50k points / 300k obs, 10 LM x 20 CG",
        "xla_bytes_accessed_per_lm_iter_mb": round(per_iter_bytes / 1e6, 1),
        "xla_flops_per_lm_iter_gflop": round(flops_total / n_lm / 1e9, 2),
        "measured_lm_iter_ms": round(per_iter_s * 1e3, 1),
        "achieved_gbps": round(bw_gbps, 1),
        "achieved_tflops": round(tflops, 3),
        "pct_of_hbm_peak": round(
            100 * bw_gbps / (peak["hbm_tb_per_s"] * 1e3), 1),
        "pct_of_bf16_peak": round(100 * tflops / peak["bf16_tflops"], 2),
        "memory_bound_floor_ms": round(mem_bound_s * 1e3, 2),
        "headroom_vs_memory_bound_x": round(per_iter_s / mem_bound_s, 1),
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    sys.exit(main())
