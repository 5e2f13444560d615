"""Image warping / resampling kernels.

Reference: src/colmap/image/warp.h (WarpImageBetweenCameras,
WarpImageWithHomography). This design expresses every warp as a dense
bilinear gather over a target pixel grid — one fused XLA program per image
(batchable over a leading axis).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def bilinear_sample(image: jax.Array, ys: jax.Array, xs: jax.Array,
                    fill: float = 0.0) -> jax.Array:
    """Sample [H, W] (or [H, W, C]) image at float coords; fill outside."""
    h, w = image.shape[:2]
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = (ys - y0)[..., None] if image.ndim == 3 else ys - y0
    fx = (xs - x0)[..., None] if image.ndim == 3 else xs - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = jnp.clip(yi, 0, h - 1)
        xc = jnp.clip(xi, 0, w - 1)
        v = image[yc, xc]
        if image.ndim == 3:
            return jnp.where(inb[..., None], v, fill)
        return jnp.where(inb, v, fill)

    return ((1 - fy) * (1 - fx) * tap(y0i, x0i)
            + (1 - fy) * fx * tap(y0i, x0i + 1)
            + fy * (1 - fx) * tap(y0i + 1, x0i)
            + fy * fx * tap(y0i + 1, x0i + 1))


@functools.partial(jax.jit, static_argnums=(2,))
def warp_with_homography(image: jax.Array, H_dst_from_src: jax.Array,
                         out_shape: tuple) -> jax.Array:
    """Warp so that out(x) = image(H^-1 x).

    H maps source pixel -> destination pixel (reference:
    WarpImageWithHomography, warp.cc).
    """
    oh, ow = out_shape
    Hinv = jnp.linalg.inv(H_dst_from_src)
    ys, xs = jnp.mgrid[0:oh, 0:ow]
    pts = jnp.stack([xs.astype(jnp.float32), ys.astype(jnp.float32),
                     jnp.ones((oh, ow), jnp.float32)], axis=-1)
    src = pts @ Hinv.T
    sz = jnp.where(jnp.abs(src[..., 2]) < 1e-12, 1e-12, src[..., 2])
    return bilinear_sample(image, src[..., 1] / sz, src[..., 0] / sz)


def warp_between_cameras(image: jax.Array,
                         src_model_id: int, src_params: jax.Array,
                         dst_model_id: int, dst_params: jax.Array,
                         out_shape: tuple) -> jax.Array:
    """out(x_dst) = image(img_from_cam_src(cam_from_img_dst(x_dst))).

    Reference: WarpImageBetweenCameras (warp.cc) — used by undistortion.
    """
    from colmap_tpu.sensor import models as cm

    oh, ow = out_shape
    ys, xs = jnp.mgrid[0:oh, 0:ow]
    xy = jnp.stack([xs, ys], axis=-1).reshape(-1, 2).astype(jnp.float32) + 0.5
    uv = cm.cam_from_img(dst_model_id, dst_params, xy)
    src_xy = cm.img_from_cam(src_model_id, src_params, uv) - 0.5
    src_xy = src_xy.reshape(oh, ow, 2)
    return bilinear_sample(image, src_xy[..., 1], src_xy[..., 0])
