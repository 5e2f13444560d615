"""End-to-end reconstruction accuracy gate.

The equivalent of the reference CI benchmark
(/root/reference/scripts/python/benchmark_eth3d.py:110-171 +
.github/workflows/build-ubuntu.yml:250-255): run the one-click
reconstruction on a dataset, align to ground truth, and FAIL (exit 1) if
any image exceeds the rotation / projection-center error bounds or if the
registered-image count mismatches.

Works on any local dataset laid out like ETH3D DSLR undistorted data:

    <dataset>/images/...                      (photographs)
    <dataset>/dslr_calibration_undistorted/   (GT COLMAP model: cameras.txt,
                                               images.txt, points3D.txt)

(or pass --gt_model_path explicitly; .bin models work too). This
environment has no network egress, so unlike the reference script nothing
is downloaded — point it at a pre-downloaded ETH3D scene, or use
--synthetic N to render an N-image ground-truthed dataset and gate on it.

Examples:
    python scripts/benchmark_reconstruction.py --dataset_path ~/eth3d/boulders \
        --max_rot_deg 1.0 --max_center_err 0.05
    python scripts/benchmark_reconstruction.py --synthetic 30 --workspace /tmp/bench_ws
"""

import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_gt(gt_path):
    from colmap_tpu.scene import reconstruction_io as rio

    return rio.read_model(gt_path)


def run(args):
    from colmap_tpu.controllers.automatic_reconstruction import (
        AutomaticReconstructionOptions,
        Quality,
        run_automatic_reconstruction,
    )
    from colmap_tpu.estimators.similarity_transform import (
        compare_reconstructions,
    )

    workspace = args.workspace or os.path.join(args.dataset_path, "ws")
    if args.synthetic:
        from colmap_tpu.scene import synthetic_images as synth
        from colmap_tpu.geometry import rotation as rot
        from colmap_tpu.scene.reconstruction import (
            Camera, Image as RImage, Reconstruction)
        import jax.numpy as jnp

        os.makedirs(workspace, exist_ok=True)
        image_path = os.path.join(workspace, "images")
        opts = synth.RoomDatasetOptions(
            num_images=args.synthetic, width=args.synthetic_width,
            height=args.synthetic_height,
            focal=0.875 * args.synthetic_width, seed=11,
            # keep texture detail near pixel scale at DSLR resolutions so
            # feature localization is texture-limited, not render-limited
            texture_res=max(512, args.synthetic_width))
        images, K, Rs, ts = synth.render_room_dataset(opts)
        synth.write_dataset(image_path, images)
        gt = Reconstruction()
        gt.add_camera(Camera(camera_id=1, model_id=1, width=opts.width,
                             height=opts.height,
                             params=np.array([K[0, 0], K[1, 1],
                                              K[0, 2], K[1, 2]])))
        for i, (R, t) in enumerate(zip(Rs, ts)):
            q = np.asarray(rot.rotmat_to_quat(jnp.asarray(R, jnp.float32)))
            gt.add_image(RImage(image_id=i + 1, name=f"{i:04d}.png",
                                camera_id=1,
                                cam_from_world=np.concatenate([q, t])))
        camera_params = ",".join(map(str, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
        camera_model = "PINHOLE"
    else:
        image_path = os.path.join(args.dataset_path, "images")
        gt_path = args.gt_model_path or os.path.join(
            args.dataset_path, "dslr_calibration_undistorted")
        if not os.path.isdir(gt_path):
            print(f"ground-truth model not found at {gt_path}",
                  file=sys.stderr)
            return 2
        gt = load_gt(gt_path)
        # reference benchmark passes GT PINHOLE intrinsics of the first cam
        cam = gt.cameras[sorted(gt.cameras)[0]]
        camera_params = ",".join(str(float(p)) for p in cam.params)
        camera_model = cam.model_name

    t0 = time.time()
    rec, _ = run_automatic_reconstruction(AutomaticReconstructionOptions(
        workspace_path=workspace,
        image_path=image_path,
        quality=Quality[args.quality.upper()],
        camera_model=camera_model,
        camera_params=camera_params,
        single_camera=True,
        dense=False,
    ))
    elapsed = time.time() - t0

    if rec is None:
        print(json.dumps({"ok": False, "reason": "no model"}))
        return 1
    res = compare_reconstructions(rec, gt)
    n_gt = sum(1 for im in gt.images.values() if im.registered)
    import datetime

    report = {
        "ok": True,
        "produced_by": "python " + " ".join(sys.argv),
        "timestamp_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "elapsed_s": round(elapsed, 1),
        "num_registered": rec.num_registered_images(),
        "num_gt_images": n_gt,
        "num_points3D": len(rec.points3D),
        "max_rotation_error_deg": None,
        "max_center_error": None,
    }
    if res is None:
        report.update(ok=False, reason="alignment to GT failed")
        print(json.dumps(report))
        return 1
    report["max_rotation_error_deg"] = round(
        float(res["max_rotation_error_deg"]), 4)
    report["max_center_error"] = round(float(res["max_center_error"]), 5)
    ok = (report["max_rotation_error_deg"] <= args.max_rot_deg
          and report["max_center_error"] <= args.max_center_err
          and rec.num_registered_images() >= args.min_registered_ratio * n_gt)
    report["ok"] = bool(ok)
    print(json.dumps(report))
    if args.report_path:
        with open(args.report_path, "w") as fp:
            json.dump(report, fp, indent=2)
    return 0 if ok else 1


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_path", default=None,
                   help="ETH3D-style dataset dir (images/ + GT model)")
    p.add_argument("--gt_model_path", default=None)
    p.add_argument("--workspace", default=None)
    p.add_argument("--synthetic", type=int, default=0,
                   help="render an N-image ground-truthed synthetic dataset")
    p.add_argument("--synthetic_width", type=int, default=320)
    p.add_argument("--synthetic_height", type=int, default=240)
    p.add_argument("--quality", default="low",
                   choices=["low", "medium", "high", "extreme"])
    # reference CI bounds: 1.0 deg / 0.05 m (build-ubuntu.yml:250-255)
    p.add_argument("--max_rot_deg", type=float, default=1.0)
    p.add_argument("--max_center_err", type=float, default=0.05)
    p.add_argument("--min_registered_ratio", type=float, default=1.0)
    p.add_argument("--report_path", default=None,
                   help="also write the report JSON here")
    args = p.parse_args()
    if not args.synthetic and not args.dataset_path:
        p.error("pass --dataset_path or --synthetic N")
    sys.exit(run(args))


if __name__ == "__main__":
    main()
