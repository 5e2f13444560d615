"""The 12 COLMAP camera models as vectorized JAX functions.

Parity target: src/colmap/sensor/models.h (model ids :82-96, param layouts
:255-452). Each model maps between normalized camera-ray coordinates
(u, v) = (x/z, y/z) and pixel coordinates via

    img_from_cam:  (u, v) --distort--> (du, dv) --focal/principal--> (x, y)
    cam_from_img:  inverse (iterative Newton undistortion where needed)

Design notes (batched device programs):
  - params are padded to MAX_PARAMS so cameras batch into one array;
  - every function broadcasts over leading axes; model dispatch is either
    static (host knows the model) or via `lax.switch` with `apply_model`;
  - undistortion uses a fixed 25-step Newton iteration (shape-static),
    mirroring the reference's IterativeUndistortion convergence behavior.
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp

MAX_PARAMS = 12


class CameraModelId(enum.IntEnum):
    """Model ids matching the reference enum (src/colmap/sensor/models.h:82)."""

    SIMPLE_PINHOLE = 0
    PINHOLE = 1
    SIMPLE_RADIAL = 2
    RADIAL = 3
    OPENCV = 4
    OPENCV_FISHEYE = 5
    FULL_OPENCV = 6
    FOV = 7
    SIMPLE_RADIAL_FISHEYE = 8
    RADIAL_FISHEYE = 9
    THIN_PRISM_FISHEYE = 10
    RAD_TAN_THIN_PRISM_FISHEYE = 11


MODEL_NAMES = {
    CameraModelId.SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    CameraModelId.PINHOLE: "PINHOLE",
    CameraModelId.SIMPLE_RADIAL: "SIMPLE_RADIAL",
    CameraModelId.RADIAL: "RADIAL",
    CameraModelId.OPENCV: "OPENCV",
    CameraModelId.OPENCV_FISHEYE: "OPENCV_FISHEYE",
    CameraModelId.FULL_OPENCV: "FULL_OPENCV",
    CameraModelId.FOV: "FOV",
    CameraModelId.SIMPLE_RADIAL_FISHEYE: "SIMPLE_RADIAL_FISHEYE",
    CameraModelId.RADIAL_FISHEYE: "RADIAL_FISHEYE",
    CameraModelId.THIN_PRISM_FISHEYE: "THIN_PRISM_FISHEYE",
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: "RAD_TAN_THIN_PRISM_FISHEYE",
}
MODEL_IDS_BY_NAME = {v: k for k, v in MODEL_NAMES.items()}

# Number of real parameters per model (reference param layouts).
NUM_PARAMS = {
    CameraModelId.SIMPLE_PINHOLE: 3,  # f, cx, cy
    CameraModelId.PINHOLE: 4,  # fx, fy, cx, cy
    CameraModelId.SIMPLE_RADIAL: 4,  # f, cx, cy, k
    CameraModelId.RADIAL: 5,  # f, cx, cy, k1, k2
    CameraModelId.OPENCV: 8,  # fx, fy, cx, cy, k1, k2, p1, p2
    CameraModelId.OPENCV_FISHEYE: 8,  # fx, fy, cx, cy, k1, k2, k3, k4
    CameraModelId.FULL_OPENCV: 12,  # fx, fy, cx, cy, k1..k6, p1, p2 (order below)
    CameraModelId.FOV: 5,  # fx, fy, cx, cy, omega
    CameraModelId.SIMPLE_RADIAL_FISHEYE: 4,  # f, cx, cy, k
    CameraModelId.RADIAL_FISHEYE: 5,  # f, cx, cy, k1, k2
    CameraModelId.THIN_PRISM_FISHEYE: 12,  # fx,fy,cx,cy,k1,k2,p1,p2,k3,k4,sx1,sy1
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: 12,  # fx,fy,cx,cy,k1..k6? see note
}

# Index of focal/principal-point params within the param vector, per model.
_FXFY_CXCY = {
    CameraModelId.SIMPLE_PINHOLE: (0, 0, 1, 2),
    CameraModelId.PINHOLE: (0, 1, 2, 3),
    CameraModelId.SIMPLE_RADIAL: (0, 0, 1, 2),
    CameraModelId.RADIAL: (0, 0, 1, 2),
    CameraModelId.OPENCV: (0, 1, 2, 3),
    CameraModelId.OPENCV_FISHEYE: (0, 1, 2, 3),
    CameraModelId.FULL_OPENCV: (0, 1, 2, 3),
    CameraModelId.FOV: (0, 1, 2, 3),
    CameraModelId.SIMPLE_RADIAL_FISHEYE: (0, 0, 1, 2),
    CameraModelId.RADIAL_FISHEYE: (0, 0, 1, 2),
    CameraModelId.THIN_PRISM_FISHEYE: (0, 1, 2, 3),
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: (0, 1, 2, 3),
}


def refine_mask(model_id: int, focal: bool = True,
                principal_point: bool = False, extra: bool = True):
    """Per-parameter refinement mask for bundle adjustment.

    Mirrors the reference's BundleAdjustmentOptions defaults
    (controllers/incremental_pipeline.h: ba_refine_focal_length=true,
    ba_refine_principal_point=FALSE, ba_refine_extra_params=true) — the
    principal point is held fixed unless explicitly requested; letting it
    float on small scenes trades pp against focal/point depth and bends
    the reconstruction.
    """
    import numpy as np

    mid = CameraModelId(model_id)
    fx, fy, cx, cy = _FXFY_CXCY[mid]
    m = np.zeros(MAX_PARAMS, np.float32)
    if focal:
        m[fx] = m[fy] = 1.0
    if principal_point:
        m[cx] = m[cy] = 1.0
    if extra:
        cam_idx = {fx, fy, cx, cy}
        for i in range(NUM_PARAMS[mid]):
            if i not in cam_idx:
                m[i] = 1.0
    return m


def pad_params(params, dtype=jnp.float32):
    """Pad a per-model parameter list to a fixed MAX_PARAMS vector."""
    import numpy as np

    p = np.zeros(MAX_PARAMS, dtype=dtype)
    p[: len(params)] = params
    return p


# ---------------------------------------------------------------------------
# Distortion functions: normalized (u, v) -> distorted (du, dv).
# Each takes the *full padded* param vector; focal/pp live at fixed slots.
# ---------------------------------------------------------------------------


def _distort_identity(p, uv):
    return uv


def _radial_poly(k1, k2, r2):
    return k1 * r2 + k2 * r2 * r2


def _distort_simple_radial(p, uv):
    k = p[..., 3:4]
    r2 = jnp.sum(uv * uv, axis=-1, keepdims=True)
    return uv * (1.0 + k * r2)


def _distort_radial(p, uv):
    k1, k2 = p[..., 3:4], p[..., 4:5]
    r2 = jnp.sum(uv * uv, axis=-1, keepdims=True)
    return uv * (1.0 + k1 * r2 + k2 * r2 * r2)


def _distort_opencv(p, uv):
    k1, k2 = p[..., 4:5], p[..., 5:6]
    p1, p2 = p[..., 6:7], p[..., 7:8]
    u, v = uv[..., :1], uv[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return jnp.concatenate([du, dv], axis=-1)


def _distort_full_opencv(p, uv):
    # param order: fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6
    k1, k2, p1, p2 = p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8]
    k3, k4, k5, k6 = p[..., 8:9], p[..., 9:10], p[..., 10:11], p[..., 11:12]
    u, v = uv[..., :1], uv[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return jnp.concatenate([du, dv], axis=-1)


def _fisheye_theta(uv):
    r = jnp.sqrt(jnp.sum(uv * uv, axis=-1, keepdims=True) + 1e-24)
    theta = jnp.arctan(r)
    return r, theta


def _distort_opencv_fisheye(p, uv):
    k1, k2, k3, k4 = p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8]
    r, theta = _fisheye_theta(uv)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = jnp.where(r > 1e-8, theta_d / r, 1.0)
    return uv * scale


def _distort_fov(p, uv):
    omega = p[..., 4:5]
    r = jnp.sqrt(jnp.sum(uv * uv, axis=-1, keepdims=True) + 1e-24)
    # rd = 1/omega * atan(2 r tan(omega/2)); guard omega ~ 0
    tan_half = jnp.tan(omega / 2.0)
    factor_num = jnp.arctan(2.0 * r * tan_half)
    small_omega = jnp.abs(omega) < 1e-6
    scale = jnp.where(
        small_omega,
        1.0,
        jnp.where(r > 1e-8, factor_num / jnp.maximum(omega * r, 1e-24), 2.0 * tan_half / jnp.maximum(omega, 1e-24)),
    )
    return uv * scale


def _undistort_fov(p, uv):
    """FOV model has a closed-form inverse (reference models.h FOVCameraModel)."""
    omega = p[..., 4:5]
    r = jnp.sqrt(jnp.sum(uv * uv, axis=-1, keepdims=True) + 1e-24)
    tan_half = jnp.tan(omega / 2.0)
    small_omega = jnp.abs(omega) < 1e-6
    scale = jnp.where(
        small_omega,
        1.0,
        jnp.where(
            r > 1e-8,
            jnp.tan(r * omega) / jnp.maximum(2.0 * r * tan_half, 1e-24),
            omega / jnp.maximum(2.0 * tan_half, 1e-24),
        ),
    )
    return uv * scale


def _fisheye_wrap(distort_fn):
    """Fisheye radial models distort (theta-based) the unit-sphere projection."""

    def fn(p, uv):
        r, theta = _fisheye_theta(uv)
        scale = jnp.where(r > 1e-8, theta / r, 1.0)
        duv = distort_fn(p, uv * scale)
        return duv

    return fn


def _distort_simple_radial_fisheye(p, uv):
    return _fisheye_wrap(_distort_simple_radial)(p, uv)


def _distort_radial_fisheye(p, uv):
    return _fisheye_wrap(_distort_radial)(p, uv)


def _distort_thin_prism_fisheye(p, uv):
    # fx fy cx cy k1 k2 p1 p2 k3 k4 sx1 sy1; fisheye (theta) then poly+tangential+prism
    k1, k2 = p[..., 4:5], p[..., 5:6]
    p1, p2 = p[..., 6:7], p[..., 7:8]
    k3, k4 = p[..., 8:9], p[..., 9:10]
    sx1, sy1 = p[..., 10:11], p[..., 11:12]
    r, theta = _fisheye_theta(uv)
    scale = jnp.where(r > 1e-8, theta / r, 1.0)
    x = uv * scale
    u, v = x[..., :1], x[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2 + k3 * r2**3 + k4 * r2**4
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2) + sx1 * r2
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2) + sy1 * r2
    return jnp.concatenate([u + du, v + dv], axis=-1)


def _distort_rad_tan_thin_prism_fisheye(p, uv):
    """Meta/Aria-style fisheye radial-tangential-thin-prism model.

    Reference: src/colmap/sensor/models.h RadTanThinPrismFisheyeModel. Param
    order: fx fy cx cy k1 k2 k3 k4 p1 p2 sx1 sy1 (theta-polynomial radial,
    then tangential + thin-prism on the radially-distorted coords).
    """
    k1, k2, k3, k4 = p[..., 4:5], p[..., 5:6], p[..., 6:7], p[..., 7:8]
    p1, p2 = p[..., 8:9], p[..., 9:10]
    sx1, sy1 = p[..., 10:11], p[..., 11:12]
    r, theta = _fisheye_theta(uv)
    t2 = theta * theta
    theta_d = theta * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = jnp.where(r > 1e-8, theta_d / r, 1.0)
    x = uv * scale
    u, v = x[..., :1], x[..., 1:2]
    u2, v2 = u * u, v * v
    uvp = u * v
    r2 = u2 + v2
    du = 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2) + sx1 * r2
    dv = 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2) + sy1 * r2
    return jnp.concatenate([u + du, v + dv], axis=-1)


_DISTORT_FNS = {
    CameraModelId.SIMPLE_PINHOLE: _distort_identity,
    CameraModelId.PINHOLE: _distort_identity,
    CameraModelId.SIMPLE_RADIAL: _distort_simple_radial,
    CameraModelId.RADIAL: _distort_radial,
    CameraModelId.OPENCV: _distort_opencv,
    CameraModelId.OPENCV_FISHEYE: _distort_opencv_fisheye,
    CameraModelId.FULL_OPENCV: _distort_full_opencv,
    CameraModelId.FOV: _distort_fov,
    CameraModelId.SIMPLE_RADIAL_FISHEYE: _distort_simple_radial_fisheye,
    CameraModelId.RADIAL_FISHEYE: _distort_radial_fisheye,
    CameraModelId.THIN_PRISM_FISHEYE: _distort_thin_prism_fisheye,
    CameraModelId.RAD_TAN_THIN_PRISM_FISHEYE: _distort_rad_tan_thin_prism_fisheye,
}


def focal_pp(model_id: int, params: jax.Array):
    """Return (fx, fy, cx, cy) each shaped params.shape[:-1]."""
    i_fx, i_fy, i_cx, i_cy = _FXFY_CXCY[CameraModelId(model_id)]
    return params[..., i_fx], params[..., i_fy], params[..., i_cx], params[..., i_cy]


def img_from_cam(model_id: int, params: jax.Array, uv: jax.Array) -> jax.Array:
    """Normalized camera coords (..., 2) -> pixel coords (..., 2).

    `model_id` must be a static Python int (host-known per camera group).
    """
    duv = _DISTORT_FNS[CameraModelId(model_id)](params, uv)
    fx, fy, cx, cy = focal_pp(model_id, params)
    x = fx[..., None] * duv[..., :1] + cx[..., None]
    y = fy[..., None] * duv[..., 1:2] + cy[..., None]
    return jnp.concatenate([x, y], axis=-1)


def project(model_id: int, params: jax.Array, p_cam: jax.Array) -> jax.Array:
    """3D camera-frame points (..., 3) -> pixels (..., 2) (z>0 assumed valid)."""
    z = p_cam[..., 2:3]
    uv = p_cam[..., :2] / jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    return img_from_cam(model_id, params, uv)


_NEWTON_ITERS = 25


def cam_from_img(model_id: int, params: jax.Array, xy: jax.Array) -> jax.Array:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Closed form for pinhole/FOV; otherwise a fixed-iteration Gauss-Newton
    inversion of the distortion (reference: models.h IterativeUndistortion,
    100 max iters with Jacobian solve; 25 Newton steps match to <1e-8 for
    realistic distortion magnitudes).
    """
    mid = CameraModelId(model_id)
    fx, fy, cx, cy = focal_pp(model_id, params)
    duv = jnp.stack(
        [(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], axis=-1
    )
    if mid in (CameraModelId.SIMPLE_PINHOLE, CameraModelId.PINHOLE):
        return duv
    if mid == CameraModelId.FOV:
        return _undistort_fov(params, duv)

    distort = _DISTORT_FNS[mid]

    def body(_, uv):
        # Newton step on F(uv) = distort(uv) - duv with the true 2x2 Jacobian.
        f, jvp_u = jax.jvp(lambda q: distort(params, q), (uv,), (jnp.stack([jnp.ones_like(uv[..., 0]), jnp.zeros_like(uv[..., 0])], -1),))
        _, jvp_v = jax.jvp(lambda q: distort(params, q), (uv,), (jnp.stack([jnp.zeros_like(uv[..., 0]), jnp.ones_like(uv[..., 0])], -1),))
        r = f - duv
        a, c = jvp_u[..., 0], jvp_u[..., 1]
        b, d = jvp_v[..., 0], jvp_v[..., 1]
        det = a * d - b * c
        det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
        du = (d * r[..., 0] - b * r[..., 1]) / det
        dv = (-c * r[..., 0] + a * r[..., 1]) / det
        return uv - jnp.stack([du, dv], axis=-1)

    return jax.lax.fori_loop(0, _NEWTON_ITERS, body, duv)


def apply_model(fn_table, model_ids: jax.Array, params: jax.Array, x: jax.Array):
    """Dynamic dispatch over models via lax.switch (for mixed-model batches)."""
    branches = [partial(fn, m) for m, fn in fn_table.items()]
    keys = list(fn_table.keys())
    index = jnp.searchsorted(jnp.array([int(k) for k in keys]), model_ids)
    return jax.lax.switch(index, [lambda p, u, f=f: f(p, u) for f in branches], params, x)


def default_params(model_id: int, focal: float, width: int, height: int):
    """Initialize params like the reference (focal + centered pp, zero distortion).

    Reference: src/colmap/scene/camera.cc Camera::CreateFromModelId.
    """
    cx, cy = width / 2.0, height / 2.0
    mid = CameraModelId(model_id)
    n = NUM_PARAMS[mid]
    i_fx, i_fy, i_cx, i_cy = _FXFY_CXCY[mid]
    params = [0.0] * n
    params[i_fx] = focal
    params[i_fy] = focal
    params[i_cx] = cx
    params[i_cy] = cy
    return pad_params(params)
