"""Smoke run of the main path on one NVIDIA GPU: pixels -> poses -> dense.

    python3 chip_smoke.py               # one card: the four phases below
    python3 chip_smoke.py --four-cards  # four cards against one, only

Phases, each printing its wall seconds and its own numbers:

1. device: JAX must report a GPU (the script fails on any other backend);
   prints the device kind and `nvidia-smi`'s name and power limit.
2. matcher: the production fused matcher kernel against the plain
   reference (`features/matching.match_pairs_batch`) on 16 pairs x 4096
   descriptors; >= 99.9 % identical indices and every disagreement a tie
   within 1 ulp of the best similarity.
3. sparse: 20 rendered images at 1536x1152 through the
   `automatic_reconstructor` CLI at medium quality (SIFT, exhaustive
   matching, verification, incremental mapping); all 20 registered, max
   rotation error <= 1 deg and max centre error <= 0.05 against the
   renderer's poses.
4. dense: a ground-truth sparse model through the `image_undistorter`,
   `patch_match_stereo` (photometric, then geometric), `stereo_fusion`
   and `poisson_mesher` CLI commands at 1536x1152; depth maps against the
   renderer's depth, fused points and mesh against the room's surfaces.

`--four-cards` runs, on four cards, the `exhaustive_matcher` CLI on the
sparse job's features (against one card: identical matches), PatchMatch
round-robin (against one card: depth maps equal within the stated
tolerance) and the sparse job with the mapper's distributed BA (same
gate), cheapest first.

Any failed phase raises, so the script exits non-zero and prints no
result line. The last line of standard output is one JSON object naming
the device.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 11
WIDTH, HEIGHT = 1536, 1152
SPARSE_IMAGES = 20
DENSE_IMAGES = 6
FOUR_CARD_DENSE_IMAGES = 4  # one PatchMatch problem per card
MATCH_PAIRS, MATCH_FEATURES = 16, 4096


def _phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            print(f"[{name}] start", flush=True)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            return out
        return run
    return wrap


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


class _StageClock(logging.Handler):
    """Reads the pipeline's own log lines: when each "=== stage ===" began,
    and the matcher's per-block match / verify seconds."""

    def __init__(self):
        super().__init__()
        self.starts, self.match_s, self.verify_s = [], 0.0, 0.0

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("=== "):
            self.starts.append((msg.strip("= "), time.perf_counter()))
        block = re.search(r"match ([0-9.]+)s, verify ([0-9.]+)s", msg)
        if block:
            self.match_s += float(block.group(1))
            self.verify_s += float(block.group(2))

    def report(self, end: float) -> str:
        bounds = [t for _, t in self.starts[1:]] + [end]
        parts = [f"{name} {b - t:.1f} s" for (name, t), b in
                 zip(self.starts, bounds)]
        return (", ".join(parts) + f" (matcher blocks: match "
                f"{self.match_s:.2f} s, verify {self.verify_s:.2f} s)")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

@_phase("device")
def phase_device(num_devices: int):
    import jax

    _check(jax.default_backend() == "gpu",
           f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    devices = jax.devices()
    _check(len(devices) >= num_devices,
           f"{num_devices} GPU(s) needed, {len(devices)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device_kind: {devices[0].device_kind} x {len(devices)}")
    print(f"nvidia-smi: {smi}")
    return devices


# ---------------------------------------------------------------------------
# 2. matcher at the production block size
# ---------------------------------------------------------------------------

def _matcher_inputs(rng, B, n):
    """Half of each pair's targets are noisy copies of query rows, half
    unrelated, so the ratio and cross checks both decide."""
    d1 = rng.integers(0, 256, (B, n, 128)).astype(np.uint8)
    d2 = rng.integers(0, 256, (B, n, 128)).astype(np.uint8)
    half = n // 2
    for b in range(B):
        src = rng.permutation(n)[:half]
        noisy = d1[b, src].astype(int) + rng.integers(-20, 21, (half, 128))
        d2[b, :half] = np.clip(noisy, 0, 255)
    return d1, d2


def _is_tie(d1, d2, i, j_a, j_b):
    """Host float64 check that a disagreement is a float tie: query row i's
    best two similarities (or the cross check's best two rows for either
    candidate column) lie within 1 f32 ulp of the best."""
    def sims_row(q, targets):
        t = targets.astype(np.float64)
        q = q.astype(np.float64)
        return (t @ q) / (np.linalg.norm(t, axis=1) * np.linalg.norm(q))

    def top2_tie(s):
        top = np.sort(s)[-2:]
        return top[1] - top[0] <= np.spacing(np.float32(top[1]))

    if top2_tie(sims_row(d1[i], d2)):
        return True
    return any(top2_tie(sims_row(d2[j], d1)) for j in (j_a, j_b) if j >= 0)


@_phase("matcher")
def phase_matcher():
    import jax

    from colmap_tpu.features import matching, pallas_matcher

    rng = np.random.default_rng(SEED)
    d1, d2 = _matcher_inputs(rng, MATCH_PAIRS, MATCH_FEATURES)
    b1 = matching.prepare_descriptor_batch(d1, np.ones(d1.shape[:2], bool))
    b2 = matching.prepare_descriptor_batch(d2, np.ones(d2.shape[:2], bool))
    print("kernel: Pallas/Triton, bf16 x bf16 -> f32 products (exact for "
          "centred uint8), f32 selection")
    print("reference: int8 x int8 -> int32 dot_general (exact), f32 "
          f"selection, default matmul precision "
          f"{jax.config.jax_default_matmul_precision!r}")

    def timed(fn):
        jax.block_until_ready(fn())  # compile + warm up
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        return np.asarray(out), 1e3 * float(np.median(times))

    out, t_kernel = timed(lambda: pallas_matcher.match_pairs(b1, b2))
    ref, t_ref = timed(lambda: matching.match_pairs_batch(b1, b2))
    agree = float((out == ref).mean())
    bad = np.argwhere(out != ref)
    ties = sum(_is_tie(d1[b], d2[b], i, out[b, i], ref[b, i])
               for b, i in bad)
    print(f"{MATCH_PAIRS} pairs x {MATCH_FEATURES}^2: kernel {t_kernel:.3f} "
          f"ms, reference {t_ref:.3f} ms (median of 5)")
    print(f"identical indices {agree:.6f}, disagreements {len(bad)} "
          f"({ties} ties), matched share {(ref >= 0).mean():.4f}")
    _check(agree >= 0.999, f"only {agree:.6f} of indices identical")
    _check(ties == len(bad), f"{len(bad) - ties} disagreements are no tie")
    _check((ref >= 0).mean() > 0.2, "reference matched too little")


# ---------------------------------------------------------------------------
# 3. sparse: pixels -> poses
# ---------------------------------------------------------------------------

def _render(num_images: int, return_depth: bool = False):
    from colmap_tpu.scene import synthetic_images as synth

    opts = synth.RoomDatasetOptions(
        num_images=num_images, width=WIDTH, height=HEIGHT,
        focal=0.875 * WIDTH, seed=SEED,
        # texture detail near pixel scale at DSLR resolution
        texture_res=WIDTH)
    return opts, synth.render_room_dataset(opts, return_depth=return_depth)


def _gt_model(K, Rs, ts, names, width, height, image_ids=None):
    import jax.numpy as jnp

    from colmap_tpu.geometry import rotation as rot
    from colmap_tpu.scene.reconstruction import Camera, Image, Reconstruction

    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=width,
                          height=height,
                          params=np.array([K[0, 0], K[1, 1], K[0, 2],
                                           K[1, 2]])))
    image_ids = image_ids or range(1, len(names) + 1)
    for iid, R, t, name in zip(image_ids, Rs, ts, names):
        q = np.asarray(rot.rotmat_to_quat(jnp.asarray(R, jnp.float32)))
        rec.add_image(Image(image_id=iid, name=name, camera_id=1,
                            cam_from_world=np.concatenate([q, t])))
    return rec


@functools.lru_cache(maxsize=None)
def _sparse_images(image_dir: str):
    """The sparse job's rendered images and PINHOLE reader arguments (the
    four-card phases render them once and share them)."""
    from colmap_tpu.scene import synthetic_images as synth

    t0 = time.perf_counter()
    opts, (images, K, Rs, ts) = _render(SPARSE_IMAGES)
    names = synth.write_dataset(image_dir, images)
    print(f"rendered {len(images)} images {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s")
    params = ",".join(str(float(v)) for v in
                      (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    reader = ["--image_path", image_dir,
              "--ImageReader.camera_model", "PINHOLE",
              "--ImageReader.single_camera", "1",
              "--ImageReader.camera_params", params]
    return opts, K, Rs, ts, names, reader


@_phase("sparse")
def phase_sparse(workdir: str, image_dir: str, mapper_devices: int = 1):
    from colmap_tpu import cli
    from colmap_tpu.estimators.similarity_transform import (
        compare_reconstructions)
    from colmap_tpu.scene import reconstruction_io

    opts, K, Rs, ts, names, reader = _sparse_images(image_dir)
    clock = _StageClock()
    logging.getLogger("colmap_tpu").addHandler(clock)
    t0 = time.perf_counter()
    try:
        rc = cli.main(["automatic_reconstructor", "--workspace_path", workdir,
                       "--quality", "medium",
                       "--Mapper.num_devices", str(mapper_devices)]
                      + reader)
    finally:
        logging.getLogger("colmap_tpu").removeHandler(clock)
    t1 = time.perf_counter()
    print(f"automatic_reconstructor: {t1 - t0:.1f} s: {clock.report(t1)}")
    _check(rc == 0, f"automatic_reconstructor returned {rc}")
    rec = reconstruction_io.read_model(os.path.join(workdir, "sparse", "0"))
    # the database assigns its own image ids: match them by name
    by_name = {im.name: iid for iid, im in rec.images.items()}
    gt = _gt_model(K, Rs, ts, names, WIDTH, HEIGHT,
                   [by_name.get(n, -1 - i) for i, n in enumerate(names)])
    cmp = compare_reconstructions(rec, gt)
    _check(cmp is not None, "alignment to the ground truth failed")
    n_reg = rec.num_registered_images()
    rot_err = float(cmp["max_rotation_error_deg"])
    ctr_err = float(cmp["max_center_error"])
    print(f"registered {n_reg}/{SPARSE_IMAGES}, points {len(rec.points3D)}, "
          f"max rotation error {rot_err:.4f} deg, max centre error "
          f"{ctr_err:.5f} (room size {opts.room_size})")
    _check(n_reg == SPARSE_IMAGES, f"only {n_reg} images registered")
    _check(rot_err <= 1.0, f"rotation error {rot_err} deg > 1")
    _check(ctr_err <= 0.05, f"centre error {ctr_err} > 0.05")


# ---------------------------------------------------------------------------
# 4. dense: PatchMatch, fusion, meshing
# ---------------------------------------------------------------------------

def _dense_workspace(workdir: str, num_images: int):
    """Rendered images + a sparse model with the ground-truth poses and a
    sampling of surface points (for PatchMatch's depth ranges)."""
    from colmap_tpu.scene import reconstruction_io, synthetic_images as synth

    opts, (images, K, Rs, ts, depths) = _render(num_images,
                                                return_depth=True)
    image_dir = os.path.join(workdir, "images")
    names = synth.write_dataset(image_dir, images)
    rec = _gt_model(K, Rs, ts, names, WIDTH, HEIGHT)
    rng = np.random.default_rng(SEED)
    n_per_image = 100
    n = len(images)
    for im in rec.images.values():
        im.xys = np.zeros((n * n_per_image, 2))
        im.point3D_ids = np.full(n * n_per_image, -1, np.int64)
    Kinv = np.linalg.inv(K)
    for src in range(n):
        ys, xs = np.nonzero(depths[src] > 0)
        for k, s in enumerate(rng.choice(len(ys), n_per_image,
                                         replace=False)):
            j = src * n_per_image + k
            ray = Kinv @ np.array([xs[s] + 0.5, ys[s] + 0.5, 1.0])
            Xw = Rs[src].T @ (ray * depths[src][ys[s], xs[s]] - ts[src])
            track = []
            for i in range(n):
                Xi = Rs[i] @ Xw + ts[i]
                p = K @ Xi
                if Xi[2] > 0 and 0 <= p[0] / p[2] < WIDTH \
                        and 0 <= p[1] / p[2] < HEIGHT:
                    rec.images[i + 1].xys[j] = p[:2] / p[2]
                    track.append((i + 1, j))
            if len(track) >= 2:
                rec.add_point3D(Xw, track)
    sparse_dir = os.path.join(workdir, "sparse")
    os.makedirs(sparse_dir, exist_ok=True)
    reconstruction_io.write_model(rec, sparse_dir, ext=".bin")
    return opts, names, depths, image_dir, sparse_dir


def _surface_distance(xyz, room_size):
    s = room_size
    return np.minimum(np.minimum(np.abs(xyz[:, 2] - s),
                                 np.abs(xyz[:, 0] - s)),
                      np.abs(xyz[:, 1] - s / 2))


def _read_mesh_ply(path):
    """Vertices and triangles of meshing.write_mesh_ply's output."""
    with open(path, "rb") as fp:
        counts = {}
        while (line := fp.readline().decode().strip()) != "end_header":
            if line.startswith("element"):
                counts[line.split()[1]] = int(line.split()[2])
        verts = np.frombuffer(fp.read(12 * counts["vertex"]), "<f4")
        faces = np.frombuffer(fp.read(), [("n", "u1"), ("v", "<i4", 3)],
                              count=counts["face"])
    return verts.reshape(-1, 3), faces["v"]


def _read_depths(dense_dir, names, kind):
    from colmap_tpu.mvs import depth_map as dm

    return [dm.DepthMap.read(os.path.join(
        dense_dir, "stereo", "depth_maps", f"{name}.{kind}.bin")).data
        for name in names]


@_phase("dense")
def phase_dense(workdir: str):
    from colmap_tpu import cli
    from colmap_tpu.mvs import fusion as fusion_mod

    t0 = time.perf_counter()
    opts, names, gt_depths, image_dir, sparse_dir = _dense_workspace(
        workdir, DENSE_IMAGES)
    print(f"rendered {len(names)} images {WIDTH}x{HEIGHT} + GT model in "
          f"{time.perf_counter() - t0:.1f} s")
    dense_dir = os.path.join(workdir, "dense")
    steps = [
        ["image_undistorter", "--image_path", image_dir,
         "--input_path", sparse_dir, "--output_path", dense_dir],
        ["patch_match_stereo", "--workspace_path", dense_dir],
        ["stereo_fusion", "--workspace_path", dense_dir,
         "--output_path", os.path.join(dense_dir, "fused.ply")],
        ["poisson_mesher", "--input_path",
         os.path.join(dense_dir, "fused.ply"),
         "--output_path", os.path.join(dense_dir, "meshed-poisson.ply")],
    ]
    for argv in steps:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        print(f"{argv[0]}: {time.perf_counter() - t0:.1f} s")
        _check(rc == 0, f"{argv[0]} returned {rc}")

    est = _read_depths(dense_dir, names, "geometric")
    ok_all, rel_all = [], []
    for name, d, gt in zip(names, est, gt_depths):
        _check(d.shape == gt.shape, f"{name}: depth map {d.shape} vs {gt.shape}")
        ok = (d > 0) & (gt > 0)
        rel = np.abs(d - gt)[ok] / gt[ok]
        print(f"{name}: valid {ok.mean():.3f}, median rel err "
              f"{np.median(rel):.4f}, under 5% {(rel < 0.05).mean():.3f}")
        ok_all.append(ok.ravel())
        rel_all.append(rel)
    ok_all, rel_all = np.concatenate(ok_all), np.concatenate(rel_all)
    valid, med = float(ok_all.mean()), float(np.median(rel_all))
    under5 = float((rel_all < 0.05).mean())
    print(f"depth (all images): valid {valid:.3f} (> 0.4), median rel err "
          f"{med:.4f} (< 0.03), under 5% {under5:.3f} (> 0.6)")
    _check(valid > 0.4 and med < 0.03 and under5 > 0.6, "depth gate failed")

    s = opts.room_size
    cloud = fusion_mod.read_ply(os.path.join(dense_dir, "fused.ply"))
    near = float((_surface_distance(cloud["xyz"], s) < 0.05 * s).mean())
    print(f"fused points {len(cloud['xyz'])}, share within 0.05 x room of "
          f"a surface {near:.3f} (> 0.7)")
    _check(len(cloud["xyz"]) > 2000 and near > 0.7, "fusion gate failed")
    verts, faces = _read_mesh_ply(
        os.path.join(dense_dir, "meshed-poisson.ply"))
    med_mesh = float(np.median(_surface_distance(verts, s)))
    print(f"mesh {len(verts)} vertices / {len(faces)} faces, median surface "
          f"distance {med_mesh:.4f} (< {0.08 * s:.2f})")
    _check(len(verts) > 500 and len(faces) > 500 and med_mesh < 0.08 * s,
           "mesh gate failed")


# ---------------------------------------------------------------------------
# four cards against one
# ---------------------------------------------------------------------------

@_phase("four-cards matching")
def phase_four_matching(workdir: str, image_dir: str):
    """The sparse job's features (medium quality), matched on one card and
    on four."""
    from colmap_tpu import cli
    from colmap_tpu.scene.database import Database

    os.makedirs(workdir, exist_ok=True)
    *_, reader = _sparse_images(image_dir)
    features = os.path.join(workdir, "features.db")
    _check(cli.main(["feature_extractor", "--database_path", features,
                     "--SiftExtraction.max_image_size", "1600",
                     "--SiftExtraction.max_num_features", "4096"]
                    + reader) == 0, "feature_extractor failed")
    results = {}
    for n_dev in (1, 4):
        path = os.path.join(workdir, f"match_{n_dev}.db")
        shutil.copy(features, path)
        t0 = time.perf_counter()
        _check(cli.main(["exhaustive_matcher", "--database_path", path,
                         "--FeatureMatching.num_devices", str(n_dev)]) == 0,
               "exhaustive_matcher failed")
        print(f"exhaustive matching on {n_dev} card(s): "
              f"{time.perf_counter() - t0:.1f} s")
        db = Database(path)
        results[n_dev] = {k: db.read_matches(*k)
                          for k in db.read_all_two_view_geometries()}
    _check(set(results[1]) == set(results[4]), "verified pair sets differ")
    same = all(np.array_equal(results[1][k], results[4][k])
               for k in results[1])
    print(f"{len(results[1])} verified pairs, raw matches identical: {same}")
    _check(same, "matches differ between one and four cards")


@_phase("four-cards patch match")
def phase_four_patch_match(workdir: str):
    """Photometric PatchMatch, one problem per card, against one card."""
    from colmap_tpu import cli
    from colmap_tpu.controllers import dense_reconstruction as dense

    _, _, _, image_dir, sparse_dir = _dense_workspace(
        workdir, FOUR_CARD_DENSE_IMAGES)
    dense_dir = os.path.join(workdir, "dense")
    _check(cli.main(["image_undistorter", "--image_path", image_dir,
                     "--input_path", sparse_dir,
                     "--output_path", dense_dir]) == 0, "undistorter failed")
    maps = {}
    for n_dev in (1, 4):
        t0 = time.perf_counter()
        depths = dense.run_patch_match_stereo(
            dense_dir, dense.PatchMatchStereoOptions(
                num_devices=n_dev, geom_consistency=False))
        print(f"PatchMatch on {n_dev} card(s): "
              f"{time.perf_counter() - t0:.1f} s")
        maps[n_dev] = depths
    # same programs, same keys: the maps agree up to floating-point
    # differences between cards; tolerance: 99 % of the pixels estimated
    # on either run agree within 0.1 % relative depth
    for iid in maps[1]:
        a, b = maps[1][iid], maps[4][iid]
        both = (a > 0) | (b > 0)
        close = np.abs(a - b) <= 1e-3 * np.maximum(a, b)
        share = float(close[both].mean())
        print(f"image {iid}: share within 0.1 % {share:.5f}")
        _check(share >= 0.99, f"image {iid}: only {share:.4f} agree")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card phases")
    args = parser.parse_args(argv)
    n_cards = 4 if args.four_cards else 1

    devices = phase_device(n_cards)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        image_dir = os.path.join(workdir, "images")
        if args.four_cards:
            phase_four_matching(os.path.join(workdir, "match"), image_dir)
            phase_four_patch_match(os.path.join(workdir, "dense"))
            phase_sparse(os.path.join(workdir, "sparse"), image_dir,
                         mapper_devices=4)
        else:
            phase_matcher()
            phase_sparse(os.path.join(workdir, "sparse"), image_dir)
            phase_dense(os.path.join(workdir, "dense"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
