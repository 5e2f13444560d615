"""Feature extraction pipeline: image dir -> database.

Re-design of the reference producer/consumer pipeline
(reference: src/colmap/controllers/feature_extraction.cc:89-380 — resizer /
extractor / writer threads over JobQueues) as batched device programs: the
host reads + resizes
images and groups them into same-resolution buckets; the device extracts a
whole batch per jit call (the batch axis is the data-parallel sharding axis);
a single writer flushes to SQLite. ImageReader semantics follow
src/colmap/controllers/image_reader.h:41-97 (EXIF focal, camera inference,
single/per-image cameras).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

from colmap_tpu.features import sift as sift_mod
from colmap_tpu.scene.database import Database
from colmap_tpu.sensor import bitmap as bitmap_mod
from colmap_tpu.sensor import models as camera_models

logger = logging.getLogger("colmap_tpu")


@dataclasses.dataclass
class ImageReaderOptions:
    """Reference: ImageReaderOptions (controllers/image_reader.h)."""

    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    single_camera_per_folder: bool = False
    camera_params: str = ""  # comma-separated explicit params
    default_focal_length_factor: float = 1.2


def init_camera_params(model_name: str, width: int, height: int,
                       focal: float) -> List[float]:
    """Default params for a model: focal(s), principal point center, zeros."""
    mid = camera_models.MODEL_IDS_BY_NAME[model_name]
    n = camera_models.NUM_PARAMS[mid]
    i_fx, i_fy, i_cx, i_cy = camera_models._FXFY_CXCY[mid]
    params = [0.0] * n
    params[i_fx] = focal
    params[i_fy] = focal
    params[i_cx] = width / 2.0
    params[i_cy] = height / 2.0
    return params


def _infer_camera(options: ImageReaderOptions, bmp: bitmap_mod.Bitmap):
    """EXIF focal -> default factor fallback (reference: image_reader.cc)."""
    if options.camera_params:
        params = [float(v) for v in options.camera_params.split(",")]
        return params, True
    focal = bmp.exif_focal_px
    has_prior = focal is not None
    if focal is None:
        focal = bitmap_mod.default_focal_length(
            bmp.width, bmp.height, options.default_focal_length_factor)
    return init_camera_params(options.camera_model, bmp.width, bmp.height,
                              focal), has_prior


@dataclasses.dataclass
class FeatureExtractionResult:
    image_ids: List[int]
    num_features: Dict[int, int]


def run_feature_extraction(
    database: Database,
    image_dir: str,
    reader_options: ImageReaderOptions = ImageReaderOptions(),
    sift_options: sift_mod.SiftExtractionOptions = sift_mod.SiftExtractionOptions(),
    image_names: Optional[List[str]] = None,
    controller=None,
) -> FeatureExtractionResult:
    """Extract SIFT for every image under image_dir into the database.

    `controller` (util.controller.BaseController) injects Stop/Pause
    between images (reference: Thread stop checks in the extractor loop).
    """
    names = image_names or bitmap_mod.list_image_files(image_dir)
    if not names:
        raise ValueError(f"no images found in {image_dir}")

    existing = {im["name"]: iid for iid, im in database.read_images().items()}

    image_ids: List[int] = []
    num_features: Dict[int, int] = {}
    shared_camera_id: Optional[int] = None
    folder_camera_ids: Dict[str, int] = {}

    import os

    # pending same-bucket images accumulate and extract as ONE vmapped
    # device dispatch (uint8 upload + single packed download,
    # sift.extract_batch_packed) — batching amortizes the host-link RTT
    # the way the reference amortizes GPU dispatch over its worker queue
    # (reference: feature/extraction.cc producer/consumer pipeline)
    pending: List[tuple] = []  # (image_id, padded_u8, scale, h, w)

    def flush():
        if not pending:
            return
        # pad short batches to batch_size by repeating the last image so
        # every bucket shape compiles exactly ONE program
        bsz = max(1, sift_options.batch_size)
        stack = np.stack([p[1] for p in pending]
                         + [pending[-1][1]] * (bsz - len(pending)))
        bufs = sift_mod.extract_batch_packed(stack, sift_options)
        for (image_id, _, scale, h, w), buf in zip(pending, bufs):
            feats = sift_mod._finalize_features(
                sift_mod.unpack_features(buf), scale, h, w)
            kp6 = sift_mod.keypoints_to_affine(
                feats["xy"], feats["scale"], feats["orientation"])
            database.write_keypoints(image_id, kp6)
            database.write_descriptors(image_id, feats["descriptors"])
            num_features[image_id] = len(kp6)
            logger.info("extracted %d features for image %d",
                        len(kp6), image_id)
        pending.clear()

    for name in names:
        if controller is not None and controller.check_if_stopped():
            break
        n_existing = (database.num_keypoints(existing[name])
                      if name in existing else 0)
        if n_existing > 0:
            # resume: skip images whose features are already in the DB
            # (reference: feature_extraction.cc skips existing features)
            image_id = existing[name]
            image_ids.append(image_id)
            num_features[image_id] = n_existing
            continue
        bmp = bitmap_mod.read_bitmap(os.path.join(image_dir, name))

        if name in existing:
            image_id = existing[name]
        else:
            folder = os.path.dirname(name)
            if reader_options.single_camera and shared_camera_id is not None:
                camera_id = shared_camera_id
            elif reader_options.single_camera_per_folder and folder in folder_camera_ids:
                camera_id = folder_camera_ids[folder]
            else:
                params, _ = _infer_camera(reader_options, bmp)
                model_id = camera_models.MODEL_IDS_BY_NAME[reader_options.camera_model]
                camera_id = database.write_camera(
                    int(model_id), bmp.width, bmp.height, np.asarray(params))
                if reader_options.single_camera:
                    shared_camera_id = camera_id
                folder_camera_ids[folder] = camera_id
            image_id = database.write_image(name, camera_id)
            if bmp.gps is not None:
                # WGS84 position prior (reference: ImageReader writing
                # pose_priors from EXIF GPS, image_reader.cc)
                database.write_pose_prior(image_id, bmp.gps,
                                          coordinate_system=1)

        padded, scale, h, w = sift_mod._prepare_u8(bmp.data, sift_options)
        if pending and pending[-1][1].shape != padded.shape:
            flush()  # bucket shape changed: run the accumulated batch
        pending.append((image_id, padded, scale, h, w))
        image_ids.append(image_id)
        if len(pending) >= max(1, sift_options.batch_size):
            flush()

    flush()
    database.commit()
    return FeatureExtractionResult(image_ids=image_ids, num_features=num_features)
