"""End-to-end incremental SfM on the synthetic fixture.

The analog of the reference's controllers/incremental_mapper_test.cc:70-90:
synthesize dataset -> run pipeline -> Sim3-align to GT -> assert per-image
rotation/center errors and registration counts.
"""

import numpy as np
import pytest

from colmap_tpu.controllers.incremental_pipeline import (
    IncrementalPipeline,
    IncrementalPipelineOptions,
)
from colmap_tpu.estimators.similarity_transform import compare_reconstructions
from colmap_tpu.scene.database import Database
from colmap_tpu.scene.synthetic import SyntheticDatasetOptions, synthesize_dataset


def expect_equal_reconstructions(gt, computed, max_rot_deg, max_center, min_images=None):
    cmp = compare_reconstructions(computed, gt)
    assert cmp is not None, "alignment failed"
    if min_images is None:
        min_images = len(gt.images)
    assert computed.num_registered_images() >= min_images, (
        f"only {computed.num_registered_images()} images registered"
    )
    assert cmp["max_rotation_error_deg"] < max_rot_deg, cmp["rotation_errors_deg"]
    assert cmp["max_center_error"] < max_center, cmp["center_errors"]


def run_pipeline(opts: SyntheticDatasetOptions):
    db = Database(":memory:")
    gt = synthesize_dataset(opts, db)
    pipeline = IncrementalPipeline(db)
    rec = pipeline.run()
    assert rec is not None, "pipeline produced no model"
    return gt, rec


def test_pipeline_clean():
    gt, rec = run_pipeline(
        SyntheticDatasetOptions(num_images=8, num_points3D=120, point2D_stddev=0.0)
    )
    expect_equal_reconstructions(gt, rec, max_rot_deg=0.1, max_center=0.01)


def test_pipeline_noisy():
    gt, rec = run_pipeline(
        SyntheticDatasetOptions(num_images=8, num_points3D=150, point2D_stddev=0.5)
    )
    expect_equal_reconstructions(gt, rec, max_rot_deg=0.5, max_center=0.05)


def test_pipeline_with_outlier_matches():
    gt, rec = run_pipeline(
        SyntheticDatasetOptions(
            num_images=8, num_points3D=150, point2D_stddev=0.3, inlier_match_ratio=0.7
        )
    )
    expect_equal_reconstructions(
        gt, rec, max_rot_deg=1.0, max_center=0.1, min_images=7
    )


def test_pipeline_multi_device():
    """The PRODUCT multi-device path: mapper.num_devices=8 routes every
    global BA through the pose-sharded distributed solver over the mesh
    (reference analog: multi-GPU work distribution in the production
    controllers, mvs/patch_match.cc:193-228 / feature/sift.h:44-46).
    Accuracy gates must hold exactly as in the single-device run."""
    import dataclasses

    db = Database(":memory:")
    gt = synthesize_dataset(
        SyntheticDatasetOptions(num_images=10, num_points3D=150,
                                point2D_stddev=0.3), db)
    opts = IncrementalPipelineOptions()
    opts.mapper = dataclasses.replace(opts.mapper, num_devices=8)
    rec = IncrementalPipeline(db, opts).run()
    assert rec is not None
    expect_equal_reconstructions(gt, rec, max_rot_deg=0.5, max_center=0.05)


@pytest.mark.parametrize("stage", ["_map_round", "_global_refinement"])
def test_mapping_errors_reach_the_caller(monkeypatch, stage):
    """A fault inside a mapping round or the final refinement (a device
    error, say) propagates: the pipeline neither retries nor returns the
    model built so far."""
    db = Database(":memory:")
    synthesize_dataset(SyntheticDatasetOptions(
        num_images=8, num_points3D=120, point2D_stddev=0.0), db)

    def fail(self, *args, **kwargs):
        raise RuntimeError("device fault")

    monkeypatch.setattr(IncrementalPipeline, stage, fail)
    with pytest.raises(RuntimeError, match="device fault"):
        IncrementalPipeline(db).run()
