"""In-memory snapshot of the database for the mapper.

Reference: src/colmap/scene/database_cache.h:53 — loads cameras, images,
keypoints and verified matches once, builds the correspondence graph.
Additionally precomputes the normalized camera rays per image (one batched
cam_from_img call per camera group) so the mapper's device batches gather
from ready arrays.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np

from colmap_tpu.scene.correspondence_graph import CorrespondenceGraph
from colmap_tpu.scene.database import Database
from colmap_tpu.scene.reconstruction import Camera
from colmap_tpu.sensor import models as camera_models


@dataclasses.dataclass
class CachedImage:
    image_id: int
    name: str
    camera_id: int
    xys: np.ndarray  # (F, 2) float32 pixels
    rays: np.ndarray  # (F, 2) float32 normalized camera coords


@functools.lru_cache(maxsize=None)
def _rays_jit(model_id: int):
    import jax

    return jax.jit(jax.vmap(
        lambda p, xy: camera_models.cam_from_img(model_id, p, xy)))


def _rays_batched(cam_xys) -> list:
    """Normalized camera rays for many images in a few jitted device calls.

    cam_from_img called eagerly per image re-traces its Newton fori_loop
    every call (~1 s/image of pure host tracing); grouping images by
    (model_id, capacity bucket) and vmapping pads each group into ONE
    compiled program (reference: the per-keypoint loop in
    src/colmap/scene/reconstruction.cc Point2D normalization).
    """
    import jax
    import jax.numpy as jnp

    out: list = [None] * len(cam_xys)
    groups: Dict[tuple, list] = {}
    for k, (cam, xys) in enumerate(cam_xys):
        mid = int(cam.model_id)
        p = np.asarray(cam.params, np.float64)
        pin = None  # (fx, fy, cx, cy) when the model is effectively pinhole
        if mid == int(camera_models.CameraModelId.SIMPLE_PINHOLE):
            pin = (p[0], p[0], p[1], p[2])
        elif mid == int(camera_models.CameraModelId.PINHOLE):
            pin = (p[0], p[1], p[2], p[3])
        elif (mid == int(camera_models.CameraModelId.SIMPLE_RADIAL)
              and len(p) >= 4 and p[3] == 0.0):
            pin = (p[0], p[0], p[1], p[2])
        elif (mid == int(camera_models.CameraModelId.RADIAL)
              and len(p) >= 5 and p[3] == 0.0 and p[4] == 0.0):
            pin = (p[0], p[0], p[1], p[2])
        if pin is not None:
            # distortion-free: rays are a closed-form host expression — no
            # device round-trip (the device path costs a compile + an
            # MB-scale download)
            fx, fy, cx, cy = pin
            out[k] = ((xys - np.array([cx, cy]))
                      / np.array([fx, fy])).astype(np.float32)
            continue
        cap = max(64, 1 << (max(len(xys), 1) - 1).bit_length())
        groups.setdefault((mid, cap), []).append(k)

    for (model_id, cap), idxs in groups.items():
        params = np.stack([cam_xys[k][0].padded_params() for k in idxs])
        xy_pad = np.zeros((len(idxs), cap, 2), np.float32)
        for row, k in enumerate(idxs):
            xy_pad[row, :len(cam_xys[k][1])] = cam_xys[k][1]
        rays = np.asarray(_rays_jit(int(model_id))(
            jnp.asarray(params.astype(np.float32)), jnp.asarray(xy_pad)))
        for row, k in enumerate(idxs):
            out[k] = rays[row, :len(cam_xys[k][1])]
    return out


class DatabaseCache:
    def __init__(self):
        self.cameras: Dict[int, Camera] = {}
        self.images: Dict[int, CachedImage] = {}
        self.pose_priors: Dict[int, dict] = {}
        self.graph = CorrespondenceGraph()

    @classmethod
    def create(cls, database: Database, min_num_matches: int = 15,
               image_names: Optional[set] = None) -> "DatabaseCache":
        cache = cls()
        for cid, cam in database.read_cameras().items():
            cache.cameras[cid] = Camera(
                camera_id=cid,
                model_id=cam["model_id"],
                width=cam["width"],
                height=cam["height"],
                params=cam["params"],
            )

        pending = []  # (iid, im, xys) — rays computed in one batched pass
        for iid, im in database.read_images().items():
            if image_names is not None and im["name"] not in image_names:
                continue
            kp = database.read_keypoints(iid)
            if kp is None:
                continue
            xys = kp[:, :2].astype(np.float32)
            pending.append((iid, im, xys))

        all_rays = _rays_batched(
            [(cache.cameras[im["camera_id"]], xys) for _, im, xys in pending])
        for (iid, im, xys), rays in zip(pending, all_rays):
            cache.images[iid] = CachedImage(
                image_id=iid,
                name=im["name"],
                camera_id=im["camera_id"],
                xys=xys,
                rays=rays,
            )
            cache.graph.add_image(iid, len(xys))

        cache.pose_priors = database.read_pose_priors()

        for (i1, i2), tvg in database.read_all_two_view_geometries().items():
            if i1 not in cache.images or i2 not in cache.images:
                continue
            m = tvg["inlier_matches"]
            if len(m) >= min_num_matches:
                cache.graph.add_correspondences(i1, i2, m)
        cache.graph.finalize()
        return cache
