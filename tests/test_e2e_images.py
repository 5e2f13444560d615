"""Full pixels-to-poses end-to-end test.

The pixel-level analog of the reference ETH3D CI gate
(scripts/python/benchmark_eth3d.py + controllers/incremental_mapper_test.cc):
render a textured 3D room from known cameras, run the COMPLETE pipeline —
SIFT -> fused matcher kernel -> batched RANSAC verification ->
incremental mapping with batched-LM BA — and check per-image rotation /
projection-center errors against ground truth after Sim3 alignment.
"""

import numpy as np
import pytest

from colmap_tpu.controllers import feature_extraction as fe
from colmap_tpu.controllers import feature_matching as fm
from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu.estimators.similarity_transform import compare_reconstructions
from colmap_tpu.features import sift as sift_mod
from colmap_tpu.geometry import rotation as rot
from colmap_tpu.scene import synthetic_images as synth
from colmap_tpu.scene.database import Database
from colmap_tpu.scene.reconstruction import Camera, Image, Reconstruction


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    opts = synth.RoomDatasetOptions(num_images=6, width=320, height=240,
                                    focal=280.0, seed=5)
    images, K, Rs, ts = synth.render_room_dataset(opts)
    image_dir = str(tmp_path_factory.mktemp("room_images"))
    names = synth.write_dataset(image_dir, images)
    return dict(images=images, K=K, Rs=Rs, ts=ts, dir=image_dir,
                names=names, opts=opts)


def _gt_reconstruction(room, name_to_id):
    import jax.numpy as jnp

    gt = Reconstruction()
    K = room["K"]
    o = room["opts"]
    gt.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                         height=o.height,
                         params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])))
    for i, name in enumerate(room["names"]):
        q = np.asarray(rot.rotmat_to_quat(jnp.asarray(room["Rs"][i], np.float32)))
        img = Image(image_id=name_to_id[name], name=name, camera_id=1)
        img.cam_from_world = np.concatenate([q, room["ts"][i]]).astype(np.float64)
        gt.add_image(img)
    return gt


def test_pixels_to_poses(room, tmp_path):
    db = Database(":memory:")
    sift_opts = sift_mod.SiftExtractionOptions(
        max_image_size=640, max_num_features=2048, octave_capacity=1024)
    fe.run_feature_extraction(
        db, room["dir"],
        fe.ImageReaderOptions(camera_model="PINHOLE", single_camera=True,
                              camera_params=",".join(map(str, [
                                  room["K"][0, 0], room["K"][1, 1],
                                  room["K"][0, 2], room["K"][1, 2]]))),
        sift_opts)

    stats = fm.match_exhaustive(db, fm.FeatureMatchingOptions(
        feature_capacity=2048))
    assert stats.num_verified_pairs >= 10, f"only {stats.num_verified_pairs} verified pairs"

    pipeline = IncrementalPipeline(db, IncrementalPipelineOptions())
    rec = pipeline.run(seed=0)
    assert rec is not None, "mapping failed"
    assert rec.num_registered_images() == len(room["names"])

    name_to_id = {im["name"]: iid for iid, im in db.read_images().items()}
    gt = _gt_reconstruction(room, name_to_id)
    cmp = compare_reconstructions(rec, gt)
    assert cmp is not None, "Sim3 alignment failed"
    # reference CI gate: <= 1 deg rotation, small proj-center error
    # (benchmark_eth3d.py:168-171); room size is 4 units
    assert cmp["max_rotation_error_deg"] < 1.0, cmp
    assert cmp["max_center_error"] < 0.05 * 4.0, cmp


def test_orbit_dataset_geometry():
    """render_orbit_dataset (the 1000-image north-star scene,
    scripts/full_scale_run.py): frames must be fully textured, the GT
    depth must be consistent with the rendered geometry, and consecutive
    frames must carry real baseline (the property the arc dataset lacks
    at scale)."""
    o = synth.OrbitDatasetOptions(num_images=6, width=320, height=240,
                                  focal=280.0, texture_res=512, seed=3)
    images, K, Rs, ts, deps = synth.render_orbit_dataset(o,
                                                         return_depth=True)
    assert len(images) == 6
    for img, dep in zip(images, deps):
        assert (img > 0).mean() > 0.95          # fully textured room
        assert (dep > 0).mean() > 0.95          # surfaces everywhere
        assert float(img.std()) > 20            # feature-rich texture
        # the central box (near) and walls (far) both in frame
        assert dep[dep > 0].min() < 0.8 * o.orbit_radius
        assert dep.max() > 1.2 * o.orbit_radius
    # consecutive-camera baseline = chord of the orbit circle
    c0 = -Rs[0].T @ ts[0]
    c1 = -Rs[1].T @ ts[1]
    expected = 2 * o.orbit_radius * np.sin(np.pi * o.orbit_turns / 6)
    np.testing.assert_allclose(np.linalg.norm(c1 - c0), expected, rtol=0.1)
