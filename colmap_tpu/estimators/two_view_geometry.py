"""Two-view geometry estimation: the E/F/H decision cascade + pose recovery.

Reference: src/colmap/estimators/two_view_geometry.h:41-140 and
two_view_geometry.cc:152-408. Re-design: the three RANSACs (E-5pt,
F-7pt, H-4pt) run as one fused jitted program over fixed-capacity match
arrays; the model-class arbitration (inlier-ratio rules) is branch-free
jnp logic, so whole *batches of image pairs* verify in a single vmapped
call — this replaces the reference's per-pair verifier thread pool
(controllers/feature_matching_utils.cc:139).
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from colmap_tpu.estimators import (
    essential_matrix as em,
    fundamental_matrix as fm,
    homography_matrix as hm,
)
from colmap_tpu.geometry import rigid3
from colmap_tpu.geometry.essential import pose_from_essential_matrix
from colmap_tpu.geometry.homography import pose_from_homography
from colmap_tpu.geometry.triangulation import calculate_triangulation_angle, triangulate_point
from colmap_tpu.optim.ransac import RansacOptions, ransac


class TwoViewConfig(enum.IntEnum):
    """Matches the reference enum (scene/two_view_geometry.h:40-62)."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


@dataclasses.dataclass(frozen=True)
class TwoViewGeometryOptions:
    min_num_inliers: int = 15
    max_error_px: float = 4.0
    # reference ratio gates (two_view_geometry.cc): E/F arbitration and
    # H-degeneracy detection
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    ransac: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(num_samples=512, lo_iterations=2)
    )
    compute_relative_pose: bool = False
    # watermark detection (reference: DetectWatermark,
    # two_view_geometry.cc:559) — requires image sizes to be passed
    detect_watermark: bool = True
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1


class TwoViewGeometry(NamedTuple):
    config: jax.Array  # scalar int32
    E: jax.Array  # (3, 3)
    F: jax.Array  # (3, 3)
    H: jax.Array  # (3, 3)
    inlier_mask: jax.Array  # (N,) bool — of the winning model
    num_inliers: jax.Array  # scalar int32
    cam2_from_cam1: jax.Array  # (7,) (identity unless pose recovery ran)
    tri_angle: jax.Array  # scalar — median triangulation angle (rad)


def estimate_two_view_geometry(
    key: jax.Array,
    rays1: jax.Array,  # (N, 2) normalized camera coords (cam_from_img)
    rays2: jax.Array,
    pix1: jax.Array,  # (N, 2) pixel coords
    pix2: jax.Array,
    valid: jax.Array,  # (N,) bool
    mean_focal: jax.Array,  # scalar: geometric-mean focal of the two cams
    options: TwoViewGeometryOptions,
    sizes1: Optional[jax.Array] = None,  # (2,) [width, height] of image 1
    sizes2: Optional[jax.Array] = None,  # enables watermark detection
) -> TwoViewGeometry:
    """Calibrated two-view estimation (jittable; vmap over a pair axis).

    Runs E (normalized coords), F and H (pixels) RANSACs and arbitrates the
    model class with the reference's inlier-ratio rules.
    """
    kE, kF, kH = jax.random.split(key, 3)

    err_E = options.max_error_px / mean_focal

    res_E = _ransac_dynamic_error(
        kE, em.solve_5pt, em.residuals, em.refit, (rays1, rays2), valid, 5,
        options.ransac, err_E,
    )
    res_F = _ransac_dynamic_error(
        kF, fm.solve_7pt, fm.residuals, fm.refit, (pix1, pix2), valid, 7,
        options.ransac, options.max_error_px,
    )
    res_H = _ransac_dynamic_error(
        kH, hm.solve_4pt, hm.residuals, hm.refit, (pix1, pix2), valid, 4,
        options.ransac, options.max_error_px,
    )

    nE, nF, nH = res_E.num_inliers, res_F.num_inliers, res_H.num_inliers
    best_EF = jnp.maximum(nE, nF)
    calibrated = nE >= options.min_E_F_inlier_ratio * best_EF.astype(jnp.float32)

    config = jnp.where(calibrated, int(TwoViewConfig.CALIBRATED), int(TwoViewConfig.UNCALIBRATED))
    num_inliers = jnp.where(calibrated, nE, nF)
    inlier_mask = jnp.where(calibrated, res_E.inlier_mask, res_F.inlier_mask)

    # planar/panoramic overrides when H explains (almost) everything
    h_dominant = nH.astype(jnp.float32) > options.max_H_inlier_ratio * num_inliers.astype(jnp.float32)
    config = jnp.where(h_dominant, int(TwoViewConfig.PLANAR_OR_PANORAMIC), config)
    num_inliers = jnp.where(h_dominant, jnp.maximum(nH, num_inliers), num_inliers)
    inlier_mask = jnp.where(h_dominant, res_H.inlier_mask, inlier_mask)

    # watermark detection on the homography inliers (reference:
    # DetectWatermark — inliers concentrated in the border of BOTH images
    # that follow a pure 2D translation)
    if options.detect_watermark and sizes1 is not None and sizes2 is not None:
        wm = _detect_watermark(res_H.inlier_mask & valid, pix1, pix2,
                               sizes1, sizes2, options)
        config = jnp.where(wm, int(TwoViewConfig.WATERMARK), config)

    enough = num_inliers >= options.min_num_inliers
    config = jnp.where(enough, config, int(TwoViewConfig.DEGENERATE))
    num_inliers = jnp.where(enough, num_inliers, 0)
    inlier_mask = inlier_mask & enough

    pose = jnp.broadcast_to(rigid3.identity(rays1.dtype), (7,))
    tri_angle = jnp.asarray(0.0, rays1.dtype)
    if options.compute_relative_pose:
        pose, tri_angle = recover_relative_pose(
            config, res_E.model, res_H.model, rays1, rays2, inlier_mask, mean_focal
        )

    return TwoViewGeometry(
        config=config.astype(jnp.int32),
        E=res_E.model,
        F=res_F.model,
        H=res_H.model,
        inlier_mask=inlier_mask,
        num_inliers=num_inliers.astype(jnp.int32),
        cam2_from_cam1=pose,
        tri_angle=tri_angle,
    )


def _detect_watermark(h_inliers, pix1, pix2, sizes1, sizes2,
                      options: TwoViewGeometryOptions):
    """Jittable watermark test (reference: two_view_geometry.cc:559)."""
    n_inl = jnp.maximum(jnp.sum(h_inliers), 1)

    def outside_box(pix, sizes):
        diag = jnp.sqrt(sizes[0] ** 2 + sizes[1] ** 2)
        b = options.watermark_border_size * diag
        inside = ((pix[:, 0] > b) & (pix[:, 0] < sizes[0] - b)
                  & (pix[:, 1] > b) & (pix[:, 1] < sizes[1] - b))
        return ~inside

    both_border = outside_box(pix1, sizes1) & outside_box(pix2, sizes2)
    border_ratio = jnp.sum(h_inliers & both_border) / n_inl

    # translational-model support: robust (median) 2D shift of the inliers
    t = pix2 - pix1
    big = 1e12

    def masked_median(v):
        vv = jnp.where(h_inliers, v, big)
        sv = jnp.sort(vv)
        k = jnp.clip(jnp.sum(h_inliers) // 2, 0, v.shape[0] - 1)
        return sv[k]

    t_med = jnp.stack([masked_median(t[:, 0]), masked_median(t[:, 1])])
    close = jnp.sum((t - t_med[None]) ** 2, -1) < options.max_error_px ** 2
    trans_ratio = jnp.sum(h_inliers & close) / n_inl
    thr = options.watermark_min_inlier_ratio
    return (border_ratio >= thr) & (trans_ratio >= thr)


def _ransac_dynamic_error(key, solver, residual_fn, refit_fn, data, valid,
                          sample_size, opts: RansacOptions, max_error):
    """RANSAC where max_error is a traced scalar: rescale residuals by it."""
    scale = 1.0 / jnp.maximum(max_error, 1e-12) ** 2

    def scaled_residuals(model, d):
        return residual_fn(model, d) * scale

    return ransac(
        key,
        solver=solver,
        residual_fn=scaled_residuals,
        refit_fn=refit_fn,
        data=data,
        valid=valid,
        sample_size=sample_size,
        options=dataclasses.replace(opts, max_error=1.0),
    )


def recover_relative_pose(config, E, H, rays1, rays2, inlier_mask, mean_focal):
    """cam2_from_cam1 + median triangulation angle over inliers.

    Reference: EstimateTwoViewGeometryPose (two_view_geometry.cc:326):
    E -> cheirality-voted decomposition; H -> Malis-Vargas decomposition.
    """
    pose_E, _, _ = pose_from_essential_matrix(E, rays1, rays2, inlier_mask)
    # The pixel-space H cannot be mapped to normalized coords with the mean
    # focal alone (the principal point matters). Refit the homography
    # directly on the normalized rays over the inlier set — the exact
    # analog of the reference decomposing K2^-1 H K1
    # (geometry/homography_matrix.cc PoseFromHomographyMatrix).
    H_norm, _ = hm.refit(H, (rays1, rays2), inlier_mask.astype(rays1.dtype))
    pose_H, _, _ = pose_from_homography(H_norm, rays1, rays2, inlier_mask)
    use_H = config == int(TwoViewConfig.PLANAR_OR_PANORAMIC)
    pose = jnp.where(use_H, pose_H, pose_E)

    n = rays1.shape[0]
    identity = jnp.broadcast_to(rigid3.identity(rays1.dtype), (n, 7))
    posed = jnp.broadcast_to(pose, (n, 7))
    X = triangulate_point(identity, posed, rays1, rays2)
    c1 = jnp.zeros(3, rays1.dtype)
    c2 = rigid3.projection_center(pose)
    angles = calculate_triangulation_angle(c1, c2, X)
    z1 = X[..., 2]
    z2 = rigid3.apply(posed, X)[..., 2]
    ok = inlier_mask & (z1 > 1e-6) & (z2 > 1e-6)
    # masked median: sort angles with invalid -> +inf, take k = count/2
    a = jnp.where(ok, angles, jnp.inf)
    a_sorted = jnp.sort(a)
    k = jnp.maximum(jnp.sum(ok) // 2, 0)
    med = a_sorted[jnp.clip(k, 0, n - 1)]
    med = jnp.where(jnp.isfinite(med), med, 0.0)
    return pose, med


def _normalized_H(H_pix, mean_focal):
    """Map a pixel homography to normalized coords assuming centered pp.

    For the pose-recovery path the exact K matters less than the rotation
    structure; callers with full K should pre-normalize instead.
    """
    f = mean_focal
    one = jnp.asarray(1.0, H_pix.dtype)
    K = jnp.diag(jnp.stack([f, f, one]))
    Kinv = jnp.diag(jnp.stack([1.0 / f, 1.0 / f, one]))
    return Kinv @ H_pix @ K


def estimate_multiple_two_view_geometries(
    key: jax.Array,
    rays1: jax.Array, rays2: jax.Array,
    pix1: jax.Array, pix2: jax.Array,
    valid: jax.Array,
    mean_focal: jax.Array,
    options: TwoViewGeometryOptions,
    max_models: int = 4,
):
    """Multi-model estimation (reference: EstimateMultipleTwoViewGeometries,
    two_view_geometry.cc:235): repeatedly estimate a geometry, remove its
    inliers, and recurse until too few matches remain. Returns a list of
    TwoViewGeometry (numpy) and a combined config (MULTIPLE when >1 model).

    Host loop over the jitted single-model estimator — each round is one
    fused device program; the match capacity stays static.
    """
    import numpy as np

    geometries = []
    cur_valid = np.asarray(valid).copy()
    for _ in range(max_models):
        if cur_valid.sum() < options.min_num_inliers:
            break
        key, sub = jax.random.split(key)
        g = estimate_two_view_geometry(
            sub, rays1, rays2, pix1, pix2, jnp.asarray(cur_valid),
            mean_focal, options)
        g = jax.tree.map(np.asarray, g)
        if int(g.num_inliers) < options.min_num_inliers:
            break
        if int(g.config) in (int(TwoViewConfig.DEGENERATE),
                             int(TwoViewConfig.UNDEFINED)):
            break
        geometries.append(g)
        cur_valid &= ~np.asarray(g.inlier_mask)
    combined = (int(TwoViewConfig.MULTIPLE) if len(geometries) > 1
                else (int(geometries[0].config) if geometries
                      else int(TwoViewConfig.DEGENERATE)))
    return geometries, combined
