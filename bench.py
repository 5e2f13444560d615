"""Benchmark suite on one GPU. Prints ONE JSON line.

Headline metric: global-BA LM iteration throughput on a 500-camera
problem. The `extra` dict carries batched SIFT img/s, matcher pairs/s,
incremental-mapping images registered/s and PatchMatch depth maps/s.

Every time is host wall time around work that ends in `block_until_ready`
(or a host fetch), repeated; each repeated metric reports its `std`.
Where the FLOPs are closed-form, an `mfu` block divides the achieved rate
by the card's published bf16 peak from `PEAKS`. A run without a GPU, or on
a card missing from `PEAKS`, fails.

Baselines (BASELINE_MEASURED.json, measured on a CPU host):
  * BA: ceres-class DENSE_SCHUR LM via scripts/ba_cpu_baseline.py ->
    0.23 iters/s (numpy/scipy); public ceres C++ numbers on comparable BAL
    problems are ~1-3 iters/s, so vs_baseline compares against 2.0.
  * SIFT: cv2 SIFT (CPU) on the same rendered 1472x1088 frame: 2.85 img/s.
  * Matching: cv2 BFMatcher L2 knn (CPU), 4096^2 descriptors: 2.6 pairs/s.
  * Mapping: order-of-magnitude estimate for COLMAP-class CPU mappers,
    1.0 img/s.
"""

import json
import time

import numpy as np

CERES_REFERENCE_ITERS_PER_S = 2.0   # conservative public ceres bar
SCIPY_MEASURED_ITERS_PER_S = 0.23   # scripts/ba_cpu_baseline.py
CV2_SIFT_IMG_PER_S = 2.85           # measured, BASELINE_MEASURED.json
CV2_MATCHER_PAIRS_PER_S = 2.6       # measured, 4096^2
REF_MAPPER_IMG_PER_S = 1.0          # order-of-magnitude estimate

# Published dense peaks by `device_kind` (NVIDIA H100 SXM data sheet, at
# the full 700 W power limit): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, hbm_tb_per_s=3.35),
}


def _device():
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"bench.py measures a GPU; JAX backend is {jax.default_backend()}")
    dev = jax.devices()[0]
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device {dev.device_kind!r}")
    return dev


def _timed_reps(fn, reps):
    """Run fn() `reps` times after one warm-up; per-rep wall seconds.
    fn must return device arrays (it is blocked on) or host values."""
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return np.asarray(out)


def _mfu(rate_per_s, flops_per_unit, peak_tflops):
    tflops = rate_per_s * flops_per_unit / 1e12
    return dict(achieved_tflops=round(tflops, 4),
                pct_of_bf16_peak=round(100 * tflops / peak_tflops, 3))


def bench_ba(peak, refine_intrinsics=False, reps=5):
    import jax

    from colmap_tpu.estimators import bundle_adjustment as ba
    from __graft_entry__ import _build_problem

    problem, _ = _build_problem(num_poses=500, num_points=50_000,
                                obs_per_point=6, seed=7)
    # fixed-iteration mode (function_tolerance=0, cg_tolerance=0 ->
    # fixed-trip CG) for stable timing
    options = ba.BAOptions(max_iterations=10, cg_iterations=20,
                           function_tolerance=0.0, cg_tolerance=0.0,
                           refine_intrinsics=refine_intrinsics)
    solve = jax.jit(lambda p: ba.solve(p, options))
    dts = _timed_reps(lambda: solve(problem).cost, reps)
    iters_per_s = options.max_iterations / dts
    # closed-form CG flops: each CG iter applies J and J^T (2 x 2*nnz
    # where nnz = obs * 2 residuals * (6 pose + 3 point + 4 cam params))
    n_obs = int(problem.obs_xy.shape[0])
    flops_per_lm = options.cg_iterations * 2 * (2 * n_obs * 2 * (6 + 3 + 4))
    return dict(value=round(float(iters_per_s.mean()), 3),
                std=round(float(iters_per_s.std()), 3), reps=reps,
                mfu=_mfu(iters_per_s.mean(), flops_per_lm, peak))


def bench_sift(reps=3):
    """Batched SIFT extraction through the extraction controller's program:
    uint8 upload, one packed uint8 download per batch."""
    from colmap_tpu.features import sift
    from colmap_tpu.scene import synthetic_images as synth

    opts = synth.RoomDatasetOptions(num_images=4, width=1472, height=1088,
                                    focal=1200.0, seed=5)
    images, _, _, _ = synth.render_room_dataset(opts)
    imgs_u8 = np.stack([im if im.ndim == 2 else im.mean(-1).astype(np.uint8)
                        for im in images])
    o = sift.SiftExtractionOptions(max_num_features=4096)
    dts = _timed_reps(lambda: sift.extract_batch_packed(imgs_u8, o), reps)
    ips = len(imgs_u8) / dts
    return dict(value=round(float(ips.mean()), 2),
                std=round(float(ips.std()), 2), reps=reps)


def bench_matcher(peak, reps=10):
    """Production matcher (fused kernel) on a 16 x 4096^2 pair block."""
    import jax

    from colmap_tpu.features import matching, pallas_matcher

    rng = np.random.default_rng(0)
    B, N = 16, 4096
    prep = jax.jit(jax.vmap(matching.prepare_descriptors))
    b1 = prep(rng.integers(0, 255, (B, N, 128)).astype(np.uint8))
    b2 = prep(rng.integers(0, 255, (B, N, 128)).astype(np.uint8))
    dts = _timed_reps(lambda: pallas_matcher.match_pairs(b1, b2), reps)
    rate = B / dts
    # algorithmic flops per pair: ONE exact N^2 x 128 GEMM; the kernel
    # covers the cross check from the same product
    return dict(value=round(float(rate.mean()), 1),
                std=round(float(rate.std()), 1), reps=reps,
                mfu=_mfu(rate.mean(), 2 * N * N * 128, peak))


def bench_patch_match(peak, width=640, height=480, n_src=4, reps=3,
                      big_width=2048):
    """Dense-stereo throughput at reference defaults (window 11x11,
    5 iters, geometric term off), plus ONE problem at >= 2000 px (the
    reference's max_image_size regime) reporting its elapsed time. FLOP
    accounting: per pixel per candidate per source ~ window taps x
    (4-tap bilinear + NCC accumulation ~ 12 flops)."""
    import jax
    import jax.numpy as jnp

    from colmap_tpu.mvs import patch_match as pm
    from colmap_tpu.scene import synthetic_images as synth

    def build(width, height, n_src):
        o = synth.RoomDatasetOptions(num_images=n_src + 1, width=width,
                                     height=height, focal=0.9 * width, seed=2)
        images, K, Rs, ts, depths = synth.render_room_dataset(
            o, return_depth=True)
        srcs = list(range(1, n_src + 1))
        R_rel = np.stack([Rs[s] @ Rs[0].T for s in srcs])
        t_rel = np.stack([ts[s] - R_rel[i] @ ts[0]
                          for i, s in enumerate(srcs)])
        gt = depths[0]
        return pm.PatchMatchProblem(
            ref_image=jnp.asarray(images[0], jnp.float32) / 255.0,
            src_images=jnp.asarray(np.stack([images[s] for s in srcs]),
                                   jnp.float32) / 255.0,
            K_ref=jnp.asarray(K, jnp.float32),
            K_src=jnp.asarray(np.stack([K] * n_src), jnp.float32),
            R_rel=jnp.asarray(R_rel, jnp.float32),
            t_rel=jnp.asarray(t_rel, jnp.float32),
            depth_min=jnp.asarray(gt[gt > 0].min() * 0.7, jnp.float32),
            depth_max=jnp.asarray(gt[gt > 0].max() * 1.3, jnp.float32))

    opts = pm.PatchMatchOptions()
    solve = jax.jit(pm.patch_match, static_argnames=("options",))
    key = jax.random.PRNGKey(0)
    problem = build(width, height, n_src)
    dts = _timed_reps(lambda: solve(key, problem, options=opts)[0], reps)
    maps_per_s = 1.0 / dts
    taps = (2 * opts.window_radius // opts.window_step + 1) ** 2
    cands = 4 + opts.num_perturbations
    total_iters = opts.num_iterations + opts.num_refinement_iterations
    flops = width * height * cands * n_src * taps * 12 * total_iters
    big_h = big_width * 3 // 4
    big = build(big_width, big_h, 2)
    t0 = time.perf_counter()
    d = np.asarray(solve(key, big, options=opts)[0])
    return dict(value=round(float(maps_per_s.mean()), 3),
                std=round(float(maps_per_s.std()), 3), reps=reps,
                mpix_per_s=round(float(maps_per_s.mean()
                                       * width * height / 1e6), 2),
                mfu=_mfu(maps_per_s.mean(), flops, peak),
                big_run=dict(width=big_width, height=big_h,
                             elapsed_s=round(time.perf_counter() - t0, 1),
                             est_frac=round(float((d > 0).mean()), 3)))


def bench_mapping(num_images=200):
    """Incremental mapping throughput, cold/warm: the same reconstruction
    twice; the second (warm) run is the throughput of record, the first
    includes compilation and is reported as cold_s."""
    from colmap_tpu.controllers.incremental_pipeline import IncrementalPipeline
    from colmap_tpu.scene.database import Database
    from colmap_tpu.scene.synthetic import (
        SyntheticDatasetOptions,
        synthesize_dataset,
    )

    db = Database(":memory:")
    synthesize_dataset(
        SyntheticDatasetOptions(num_images=num_images,
                                num_points3D=10 * num_images,
                                point2D_stddev=0.5, seed=3), db)
    t0 = time.perf_counter()
    rec_cold = IncrementalPipeline(db).run()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = IncrementalPipeline(db).run()
    warm_s = time.perf_counter() - t0
    n_reg = rec.num_registered_images()
    return dict(warm_img_per_s=n_reg / warm_s, cold_s=cold_s,
                cold_img_per_s=rec_cold.num_registered_images() / cold_s,
                n_reg=n_reg, num_images=num_images)


def main():
    import jax

    dev = _device()
    peak = PEAKS[dev.device_kind]["bf16_tflops"]
    results = {}
    ba_res = bench_ba(peak)
    results["ba_lm_iters_per_s_500cam_300kobs"] = dict(
        ba_res, unit="LM iters/s (20 CG steps each)",
        vs_baseline=round(ba_res["value"] / CERES_REFERENCE_ITERS_PER_S, 3),
        vs_measured_scipy=round(ba_res["value"] / SCIPY_MEASURED_ITERS_PER_S,
                                1))
    results["ba_lm_iters_per_s_refine_intrinsics"] = dict(
        bench_ba(peak, refine_intrinsics=True, reps=3),
        unit="LM iters/s (20 CG steps, +intrinsics)")
    s = bench_sift()
    results["sift_batched_img_per_s_1472x1088"] = dict(
        s, unit="img/s (batch 4, 4096 feats)",
        vs_baseline=round(s["value"] / CV2_SIFT_IMG_PER_S, 2))
    m = bench_matcher(peak)
    results["matcher_pairs_per_s_16x4096sq"] = dict(
        m, unit="pairs/s (batch 16)",
        vs_baseline=round(m["value"] / CV2_MATCHER_PAIRS_PER_S, 1))
    mp = bench_mapping()
    results["mapping_images_registered_per_s"] = {
        "value": round(mp["warm_img_per_s"], 3),
        "unit": (f"img/s warm ({mp['n_reg']}/{mp['num_images']} registered;"
                 " 2nd identical run)"),
        "cold_s": round(mp["cold_s"], 1),
        "cold_img_per_s": round(mp["cold_img_per_s"], 3),
        "vs_baseline": round(mp["warm_img_per_s"] / REF_MAPPER_IMG_PER_S, 2),
    }
    results["patch_match_depth_maps_per_s_640x480"] = dict(
        bench_patch_match(peak),
        unit="depth maps/s (640x480, 4 src, reference defaults)")

    headline = results.pop("ba_lm_iters_per_s_500cam_300kobs")
    print(json.dumps({
        "metric": "ba_lm_iters_per_s_500cam_300kobs",
        "value": headline["value"],
        "unit": headline["unit"],
        "vs_baseline": headline["vs_baseline"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": results,
    }))


if __name__ == "__main__":
    main()
