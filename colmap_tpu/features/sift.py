"""SIFT feature extraction as batched, shape-static JAX programs.

Re-design of the reference SIFT stack (reference: src/colmap/feature/sift.cc:139
SiftCPUFeatureExtractor over VLFeat, src/thirdparty/SiftGPU for the GPU path;
options mirror src/colmap/feature/sift.h:37-113) as a shape-static JAX program:

- Gaussian scale space: separable Gaussian blurs expressed as banded
  matrix products, computed incrementally level-to-level exactly like
  VLFeat.
- DoG extrema: one 3x3x3 `reduce_window` max/min over the stacked DoG volume
  instead of the reference's per-pixel neighbor loop
  (src/thirdparty/VLFeat/sift.c vl_sift_detect).
- Candidate selection: `top_k` over the masked response map — fixed capacity
  per octave, so every downstream stage is shape-static (in place of the
  reference's dynamic keypoint vectors).
- Subpixel refinement: the 3x3x3 neighborhoods of ALL candidates are fetched
  with one bulk gather ([K, 27]) and the Newton steps are closed-form 3x3
  adjugate solves on [K]-vectors — no per-keypoint control flow.
- Orientation + descriptor: fixed sample grids gathered from a PACKED
  (gx, gy) gradient volume (one gather fetches both components); the
  orientation histogram samples nearest-neighbor (36 coarse bins), the
  descriptor bilinearly; histogram accumulation is expressed as one-hot
  contractions (einsum over the keypoint batch → dense GEMMs).
- Output: fixed-capacity (max_num_features) keypoint arrays + valid mask;
  descriptors L1-root normalized to uint8 exactly like the reference
  (sift.cc L1_ROOT + FeatureDescriptorsToUInt8).

The extractor is jit-compiled per (H, W) bucket; batching over images is a
vmap over the leading axis (the data-parallel sharding axis on a mesh).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32


@dataclasses.dataclass(frozen=True)
class SiftExtractionOptions:
    """Mirrors SiftExtractionOptions (reference: src/colmap/feature/sift.h:37-113)."""

    max_image_size: int = 3200
    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3  # levels per octave (S)
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    max_num_orientations: int = 2
    normalization: str = "L1_ROOT"  # or "L2"
    # affine-shape adaptation (covariant SIFT): per-keypoint second-moment
    # iteration normalizes anisotropic neighborhoods
    # (reference: sift.h estimate_affine_shape / VLFeat covdet affine
    # adaptation, thirdparty/VLFeat/covdet.c)
    estimate_affine_shape: bool = False
    affine_shape_iterations: int = 3
    # domain-size pooling (DSP-SIFT): average the descriptor over a range of
    # window scales (reference: sift.h:90-93 / CovariantSiftCPUFeatureExtractor)
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    # per-octave candidate capacity (static-shape knob, not in reference)
    octave_capacity: int = 4096
    # gradient sampling backend: "window" = per-keypoint window
    # slices + separable-matmul taps; "gather" = element
    # gathers (exact legacy path, used automatically for DSP/affine)
    sampling: str = "window"
    # images per device dispatch in the extraction controller (batching
    # amortizes per-dispatch overhead; same-bucket images share one
    # vmapped program)
    batch_size: int = 4

    def check(self):
        assert self.octave_resolution >= 1
        assert self.max_num_orientations in (1, 2)
        assert self.normalization in ("L1_ROOT", "L2")
        assert self.sampling in ("window", "gather")


# --------------------------------------------------------------------------
# Gaussian scale space
# --------------------------------------------------------------------------

_SIGMA0 = 1.6  # base blur of level 0 (VLFeat convention)
_SIGMA_N = 0.5  # nominal blur of the input image


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band_matrix(n: int, sigma: float) -> jax.Array:
    """Row-normalized Gaussian band matrix [n, n] built in-graph."""
    i = jax.lax.broadcasted_iota(_F32, (n, n), 0)
    j = jax.lax.broadcasted_iota(_F32, (n, n), 1)
    B = jnp.exp(-0.5 * ((i - j) / sigma) ** 2)
    return B / jnp.sum(B, axis=1, keepdims=True)


def _blur_axis0_blocked(img: jax.Array, sigma: float, tile: int = 512
                        ) -> jax.Array:
    """Gaussian blur along axis 0 as strip-blocked small matmuls.

    A dense (H, H) band matrix wastes H/band of its FLOPs on zeros (~99%
    at H=2176, radius<=13). Overlapping strips of `tile` rows multiply a
    (tile, tile+2r) matrix instead — the same GEMM shape, ~6x
    fewer FLOPs on the big first octaves. Edge padding stands in for the
    border renormalization of the dense row-normalized matrix.
    """
    h, w = img.shape
    r = max(1, int(math.ceil(4.0 * sigma)))
    hp_rows = ((h + tile - 1) // tile) * tile
    padded = jnp.pad(img, ((r, r + (hp_rows - h)), (0, 0)), mode="edge")
    n = hp_rows // tile
    idx = (np.arange(n) * tile)[:, None] + np.arange(tile + 2 * r)[None, :]
    strips = padded[jnp.asarray(idx)]  # [n, tile+2r, w]
    i = np.arange(tile)[:, None]
    j = np.arange(tile + 2 * r)[None, :]
    B = np.exp(-0.5 * (((i + r) - j) / sigma) ** 2)
    B = (B / B.sum(1, keepdims=True)).astype(np.float32)
    out = jnp.einsum("ij,njw->niw", jnp.asarray(B), strips,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(hp_rows, w)[:h]


def _blur(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur of a [H, W] image as matrix products.

    Banded matrices keep the blur on the GEMM units; large axes use the
    strip-blocked form. Whether cuDNN convolutions do better on the GPU is
    an open measurement (ROADMAP). Explicit HIGHEST precision: DoG peak
    thresholds (~7e-3) are below bf16 and TF32 resolution.
    """
    if sigma < 1e-6:
        return img
    h, w = img.shape
    r = max(1, int(math.ceil(4.0 * sigma)))
    tile = 512
    hp = jax.lax.Precision.HIGHEST
    if h > 2 * tile and tile >= 4 * r:
        img = _blur_axis0_blocked(img, sigma, tile)
    else:
        img = jnp.matmul(_band_matrix(h, sigma), img, precision=hp)
    if w > 2 * tile and tile >= 4 * r:
        img = _blur_axis0_blocked(img.T, sigma, tile).T
    else:
        img = jnp.matmul(img, _band_matrix(w, sigma).T, precision=hp)
    return img


def _upsample2(img: jax.Array) -> jax.Array:
    h, w = img.shape
    return jax.image.resize(img, (2 * h, 2 * w), method="bilinear")


def _downsample2(img: jax.Array) -> jax.Array:
    return img[::2, ::2]


def _num_octaves(h: int, w: int, first_octave: int, max_octaves: int) -> int:
    base = min(h, w) * (2 ** (-first_octave))
    n = 0
    while base >= 32 and n < max_octaves:
        base //= 2
        n += 1
    return max(n, 1)


def _build_octave(base: jax.Array, S: int) -> jax.Array:
    """Incremental blurs: [S+3, H, W] Gaussian levels; level s at sigma0·2^(s/S)."""
    levels = [base]
    for s in range(1, S + 3):
        prev_sigma = _SIGMA0 * (2.0 ** ((s - 1) / S))
        cur_sigma = _SIGMA0 * (2.0 ** (s / S))
        inc = math.sqrt(max(cur_sigma**2 - prev_sigma**2, 1e-8))
        levels.append(_blur(levels[-1], inc))
    return jnp.stack(levels)


# --------------------------------------------------------------------------
# Extrema detection + bulk refinement
# --------------------------------------------------------------------------


def _detect_candidates(dog: jax.Array, peak_threshold: float, cap: int):
    """Up to `cap` DoG extrema in [S+2, H, W]; returns int (s, y, x, valid)."""
    ns, h, w = dog.shape
    mx = jax.lax.reduce_window(dog, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "VALID")
    mn = jax.lax.reduce_window(dog, jnp.inf, jax.lax.min, (3, 3, 3), (1, 1, 1), "VALID")
    c = dog[1:-1, 1:-1, 1:-1]
    thr = 0.8 * peak_threshold
    is_ext = ((c >= mx) & (c > thr)) | ((c <= mn) & (c < -thr))
    resp = jnp.where(is_ext, jnp.abs(c), 0.0)
    flat = resp.reshape(-1)
    vals, idx = jax.lax.top_k(flat, min(cap, flat.shape[0]))
    hw = (h - 2) * (w - 2)
    s = idx // hw + 1
    rem = idx % hw
    y = rem // (w - 2) + 1
    x = rem % (w - 2) + 1
    return s, y, x, vals > 0.0


# 27 neighbor offsets, index = (ds+1)*9 + (dy+1)*3 + (dx+1)
_OFFS = np.array([(ds, dy, dx)
                  for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                 np.int32)


def _solve3x3_sym(a, b, c, d, e, f, g0, g1, g2):
    """Solve H·x = -g for symmetric H = [[a,b,c],[b,d,e],[c,e,f]] (bulk)."""
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = jnp.where(jnp.abs(det) > 1e-16, 1.0 / det, 0.0)
    x0 = -(co00 * g0 + co01 * g1 + co02 * g2) * inv_det
    x1 = -(co01 * g0 + co11 * g1 + co12 * g2) * inv_det
    x2 = -(co02 * g0 + co12 * g1 + co22 * g2) * inv_det
    return x0, x1, x2


def _refine_bulk(dog: jax.Array, s, y, x, peak_threshold: float, edge_threshold: float):
    """Batched Newton refinement of extrema with 3 static re-centering steps.

    Mirrors VLFeat's keypoint refinement (sift.c): each step gathers the
    3x3x3 neighborhood of every candidate in one `take` ([K, 27]) and solves
    the quadratic fit in closed form.
    """
    ns, h, w = dog.shape
    flat = dog.reshape(-1)
    doffs = jnp.asarray(_OFFS[:, 0] * h * w + _OFFS[:, 1] * w + _OFFS[:, 2])

    def P(p, ds, dy, dx):
        return p[:, (ds + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

    off_s = off_y = off_x = None
    val = edge_ok = None
    for _ in range(3):
        center = (s * h + y) * w + x
        p = jnp.take(flat, center[:, None] + doffs[None, :])  # [K, 27]
        c = P(p, 0, 0, 0)
        gs = 0.5 * (P(p, 1, 0, 0) - P(p, -1, 0, 0))
        gy = 0.5 * (P(p, 0, 1, 0) - P(p, 0, -1, 0))
        gx = 0.5 * (P(p, 0, 0, 1) - P(p, 0, 0, -1))
        hss = P(p, 1, 0, 0) + P(p, -1, 0, 0) - 2 * c
        hyy = P(p, 0, 1, 0) + P(p, 0, -1, 0) - 2 * c
        hxx = P(p, 0, 0, 1) + P(p, 0, 0, -1) - 2 * c
        hsy = 0.25 * (P(p, 1, 1, 0) - P(p, 1, -1, 0) - P(p, -1, 1, 0) + P(p, -1, -1, 0))
        hsx = 0.25 * (P(p, 1, 0, 1) - P(p, 1, 0, -1) - P(p, -1, 0, 1) + P(p, -1, 0, -1))
        hyx = 0.25 * (P(p, 0, 1, 1) - P(p, 0, 1, -1) - P(p, 0, -1, 1) + P(p, 0, -1, -1))
        os_, oy_, ox_ = _solve3x3_sym(hss, hsy, hsx, hyy, hyx, hxx, gs, gy, gx)
        os_ = jnp.clip(os_, -1.5, 1.5)
        oy_ = jnp.clip(oy_, -1.5, 1.5)
        ox_ = jnp.clip(ox_, -1.5, 1.5)
        val = c + 0.5 * (gs * os_ + gy * oy_ + gx * ox_)
        tr = hxx + hyy
        det2 = hxx * hyy - hyx * hyx
        r = edge_threshold
        edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
        off_s, off_y, off_x = os_, oy_, ox_
        # re-center in y/x when the offset leaves the pixel
        dy = jnp.where(oy_ > 0.6, 1, jnp.where(oy_ < -0.6, -1, 0))
        dx = jnp.where(ox_ > 0.6, 1, jnp.where(ox_ < -0.6, -1, 0))
        y = jnp.clip(y + dy, 1, h - 2)
        x = jnp.clip(x + dx, 1, w - 2)

    ok = (jnp.abs(val) >= peak_threshold) & edge_ok
    max_off = jnp.maximum(jnp.abs(off_s), jnp.maximum(jnp.abs(off_y), jnp.abs(off_x)))
    ok &= max_off <= 1.5
    fs = s.astype(_F32) + off_s
    fy = y.astype(_F32) + off_y
    fx = x.astype(_F32) + off_x
    ok &= (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)
    return fs, fy, fx, jnp.abs(val), ok


# --------------------------------------------------------------------------
# Gradients + bulk bilinear gather from a level volume
# --------------------------------------------------------------------------


def _gradients(gauss: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Central-difference gradients of [S, H, W] Gaussian levels."""
    gy = jnp.zeros_like(gauss)
    gx = jnp.zeros_like(gauss)
    gy = gy.at[:, 1:-1, :].set(0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :]))
    gx = gx.at[:, :, 1:-1].set(0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2]))
    return gx, gy


def _bilinear_vol2(grad_flat: jax.Array, h: int, w: int, base: jax.Array,
                   ys: jax.Array, xs: jax.Array):
    """Bilinear sample of a packed-gradient [L*H*W, 2] array.

    One gather fetches both gradient components (row of 2), halving the
    number of gather ops vs separate gx/gy volumes. base: [K] flat offsets
    (level*h*w); ys, xs: [K, P] float coords. Returns (gx, gy) [K, P].
    """
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)

    def tap(yi, xi, wgt):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base[:, None] + jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
        v = jnp.take(grad_flat, idx, axis=0)  # [K, P, 2]
        return jnp.where(inb, wgt, 0.0)[..., None] * v

    out = (tap(y0i, x0i, (1 - fy) * (1 - fx))
           + tap(y0i, x0i + 1, (1 - fy) * fx)
           + tap(y0i + 1, x0i, fy * (1 - fx))
           + tap(y0i + 1, x0i + 1, fy * fx))
    return out[..., 0], out[..., 1]


def _nearest_vol2(grad_flat: jax.Array, h: int, w: int, base: jax.Array,
                  ys: jax.Array, xs: jax.Array):
    """Nearest-neighbor packed-gradient sample — a single gather. Used by
    the orientation histogram (36 coarse bins are insensitive to sub-pixel
    sampling)."""
    yi = jnp.round(ys).astype(jnp.int32)
    xi = jnp.round(xs).astype(jnp.int32)
    inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = base[:, None] + jnp.clip(yi, 0, h - 1) * w + jnp.clip(xi, 0, w - 1)
    v = jnp.take(grad_flat, idx, axis=0)
    v = jnp.where(inb[..., None], v, 0.0)
    return v[..., 0], v[..., 1]


# --------------------------------------------------------------------------
# Window sampling: per-keypoint gradient windows + separable matmul taps
# --------------------------------------------------------------------------
#
# The [K, P] element gathers above are random-access reads. The window
# path re-expresses sampling as matrix work: slice one (WH, WW) gradient
# window per keypoint (a contiguous slice gather), then evaluate
# all P samples with separable interpolation weights:
#
#     sample[k, p] = sum_r sum_c Wy[k, p, r] * win[k, r, c] * Wx[k, p, c]
#
# i.e. one batched (P, WH) x (WH, WW) matmul per keypoint plus an
# elementwise row-contraction. The hat weights are zero outside the window, which
# exactly reproduces the zero-contribution-out-of-image semantics of the
# tap-masked gather (windows are clipped inside the image, so every
# in-image tap of every sample lies in the window).

_WIN_H = 96
_WIN_W = 128
# max descriptor sample radius the (96, 128) window covers: rows reach
# +-46 around the keypoint -> _MAGNIF * sigma * (_NBP/2) * sqrt(2) <= 46
# -> sigma <= 5.4, beyond every in-octave refined scale (sigma <= ~5.1).
# DSP's scaled windows and affine shapes can exceed it -> gather path.


def _win_eligible(h: int, w: int, shape_A) -> bool:
    return shape_A is None and h >= _WIN_H and w >= _WIN_W


def _window_vol2(grad_vol: jax.Array, lvl: jax.Array, fy: jax.Array,
                 fx: jax.Array, ys: jax.Array, xs: jax.Array,
                 nearest: bool = False):
    """Sample (gx, gy) [K, P] from [L, H, W, 2] gradients via per-keypoint
    windows. ys/xs are absolute octave coords; fy/fx the keypoint centers
    the windows are placed around."""
    L, h, w, _ = grad_vol.shape
    oy = jnp.clip(jnp.round(fy).astype(jnp.int32) - _WIN_H // 2, 0, h - _WIN_H)
    ox = jnp.clip(jnp.round(fx).astype(jnp.int32) - _WIN_W // 2, 0, w - _WIN_W)

    def slice_one(l, y0, x0):
        return jax.lax.dynamic_slice(
            grad_vol, (l, y0, x0, 0), (1, _WIN_H, _WIN_W, 2))[0]

    ry = ys - oy[:, None].astype(ys.dtype)  # [K, P] window-relative
    rx = xs - ox[:, None].astype(xs.dtype)
    rows = jnp.arange(_WIN_H, dtype=ys.dtype)
    cols = jnp.arange(_WIN_W, dtype=ys.dtype)

    def chunk_sample(args):
        lvl_c, oy_c, ox_c, ry_c, rx_c = args
        win_c = jax.vmap(slice_one)(lvl_c, oy_c, ox_c)  # [KB, WH, WW, 2]
        if nearest:
            wy = (jnp.abs(ry_c[..., None] - rows) <= 0.5).astype(_F32)
            wx = (jnp.abs(rx_c[..., None] - cols) <= 0.5).astype(_F32)
            # ties at .5: keep only the first matching row/col
            wy = wy * (jnp.cumsum(wy, axis=-1) <= 1.0)
            wx = wx * (jnp.cumsum(wx, axis=-1) <= 1.0)
        else:
            wy = jnp.maximum(0.0, 1.0 - jnp.abs(ry_c[..., None] - rows))
            wx = jnp.maximum(0.0, 1.0 - jnp.abs(rx_c[..., None] - cols))
        # A[k, p, c, d] = sum_r wy[k,p,r] * win[k,r,c,d]; contract over c.
        a = jnp.einsum("kpr,krcd->kpcd", wy, win_c,
                       preferred_element_type=_F32)
        return jnp.einsum("kpc,kpcd->kpd", wx, a)  # [KB, P, 2]

    # chunk the keypoint axis: the [KB, P, WW, 2] intermediate and the
    # [KB, WH, WW, 2] windows are the big buffers (67 + 16 MB at KB=256)
    # — unchunked they would be ~0.7 GB at K=2048
    K = ys.shape[0]
    kb = K if K <= 256 else 256
    if K % kb == 0 and K > kb:
        out = jax.lax.map(
            chunk_sample,
            (lvl.reshape(K // kb, kb), oy.reshape(K // kb, kb),
             ox.reshape(K // kb, kb), ry.reshape(K // kb, kb, -1),
             rx.reshape(K // kb, kb, -1)),
        ).reshape(K, -1, 2)
    else:
        out = chunk_sample((lvl, oy, ox, ry, rx))
    return out[..., 0], out[..., 1]


# --------------------------------------------------------------------------
# Affine shape adaptation (bulk)
# --------------------------------------------------------------------------

_SHAPE_GRID = 12


def _sqrtm_inv_2x2_sym(a, b, d):
    """Inverse square root of symmetric 2x2 [[a, b], [b, d]] (bulk),
    det-normalized so the adapted shape preserves area."""
    tr = a + d
    det = jnp.maximum(a * d - b * b, 1e-12)
    s = jnp.sqrt(det)
    t = jnp.sqrt(jnp.maximum(tr + 2.0 * s, 1e-12))
    # sqrt(M) = (M + s I) / t ; inv via 2x2 adjugate
    m00 = (a + s) / t
    m01 = b / t
    m11 = (d + s) / t
    idet = 1.0 / jnp.maximum(m00 * m11 - m01 * m01, 1e-12)
    i00 = m11 * idet
    i01 = -m01 * idet
    i11 = m00 * idet
    # normalize to unit determinant
    nd = jnp.sqrt(jnp.maximum(i00 * i11 - i01 * i01, 1e-12))
    return i00 / nd, i01 / nd, i11 / nd


def _affine_shapes_bulk(grad_flat, h, w, base, fy, fx, sigma,
                        num_iters: int):
    """Per-keypoint affine shape A [K, 2, 2] (unit determinant) via
    second-moment-matrix iteration (VLFeat covdet affine adaptation)."""
    g = _SHAPE_GRID
    lin = (np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0
    uy, ux = np.meshgrid(lin, lin, indexing="ij")
    unit = jnp.asarray(np.stack([ux.reshape(-1), uy.reshape(-1)]))  # [2, P]
    r2u = jnp.asarray((ux.reshape(-1) ** 2 + uy.reshape(-1) ** 2))
    win = jnp.exp(-r2u / (2.0 * 0.5 ** 2))  # gaussian over the unit disc

    k = fy.shape[0]
    A = jnp.broadcast_to(jnp.eye(2, dtype=_F32), (k, 2, 2))
    wrad = 3.0 * sigma  # [K]

    for _ in range(num_iters):
        # sample offsets = wrad * A @ unit
        off = jnp.einsum("kij,jp->kip", A, unit) * wrad[:, None, None]
        ys = fy[:, None] + off[:, 1, :]
        xs = fx[:, None] + off[:, 0, :]
        sgx, sgy = _nearest_vol2(grad_flat, h, w, base, ys, xs)
        # gradients transform with A^T under the warp
        wxx = jnp.sum(win[None] * sgx * sgx, axis=1)
        wxy = jnp.sum(win[None] * sgx * sgy, axis=1)
        wyy = jnp.sum(win[None] * sgy * sgy, axis=1)
        tr = wxx + wyy
        norm = jnp.maximum(tr, 1e-12)
        i00, i01, i11 = _sqrtm_inv_2x2_sym(wxx / norm, wxy / norm, wyy / norm)
        Mi = jnp.stack([jnp.stack([i00, i01], -1),
                        jnp.stack([i01, i11], -1)], -2)  # [K, 2, 2]
        A = jnp.einsum("kij,kjl->kil", A, Mi)
    return A


# --------------------------------------------------------------------------
# Orientation histograms (bulk)
# --------------------------------------------------------------------------

_NUM_ORI_BINS = 36
_ORI_GRID = 16  # fixed sample grid (SiftGPU-style sampling vs VLFeat pixel loop)


def _orientations_bulk(grad_flat, h, w, base, fy, fx, sigma, max_num: int,
                       shape_A=None, grad_vol=None, lvl=None):
    """Dominant orientations for all keypoints at once.

    fy, fx, sigma: [K]. Returns theta [K, max_num], valid [K, max_num].
    36-bin Gaussian-weighted histogram over the 3·1.5σ window, circular box
    smoothing ×6, peak pick with parabolic interpolation (reference behavior:
    VLFeat vl_sift_calc_keypoint_orientations).
    """
    g = _ORI_GRID
    lin = (np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0
    uy, ux = np.meshgrid(lin, lin, indexing="ij")
    unit = np.stack([uy.reshape(-1), ux.reshape(-1)])  # [2, P]
    r2u = jnp.asarray((unit[0] ** 2 + unit[1] ** 2))  # [P]
    unit = jnp.asarray(unit)

    wsig = 1.5 * sigma  # [K]
    wrad = 3.0 * wsig
    if shape_A is None:
        dy = unit[0][None, :] * wrad[:, None]
        dx = unit[1][None, :] * wrad[:, None]
    else:
        uv = jnp.stack([unit[1], unit[0]])  # (x, y) rows
        off = jnp.einsum("kij,jp->kip", shape_A, uv) * wrad[:, None, None]
        dx, dy = off[:, 0, :], off[:, 1, :]
    ys = fy[:, None] + dy  # [K, P]
    xs = fx[:, None] + dx
    if grad_vol is not None and _win_eligible(h, w, shape_A):
        sgx, sgy = _window_vol2(grad_vol, lvl, fy, fx, ys, xs, nearest=True)
    else:
        sgx, sgy = _nearest_vol2(grad_flat, h, w, base, ys, xs)
    mag = jnp.sqrt(sgx * sgx + sgy * sgy)
    ang = jnp.arctan2(sgy, sgx)  # [-pi, pi]
    r2 = r2u[None, :] * (wrad * wrad)[:, None]
    wgt = jnp.exp(-r2 / (2.0 * (wsig * wsig)[:, None])) * mag
    wgt = jnp.where(r2u[None, :] <= 1.0, wgt, 0.0)

    nb = _NUM_ORI_BINS
    b = (ang + jnp.pi) / (2 * jnp.pi) * nb
    b0 = jnp.floor(b - 0.5)
    f = b - 0.5 - b0
    i0 = jnp.mod(b0.astype(jnp.int32), nb)
    i1 = jnp.mod(i0 + 1, nb)
    oh0 = jax.nn.one_hot(i0, nb, dtype=_F32)  # [K, P, nb]
    oh1 = jax.nn.one_hot(i1, nb, dtype=_F32)
    hist = jnp.einsum("kp,kpb->kb", wgt * (1 - f), oh0) \
        + jnp.einsum("kp,kpb->kb", wgt * f, oh1)

    for _ in range(6):
        hist = (jnp.roll(hist, 1, axis=1) + hist + jnp.roll(hist, -1, axis=1)) / 3.0

    hp = jnp.roll(hist, 1, axis=1)
    hn = jnp.roll(hist, -1, axis=1)
    is_peak = (hist > hp) & (hist > hn) & (hist >= 0.8 * jnp.max(hist, 1, keepdims=True))
    peak_val = jnp.where(is_peak, hist, -1.0)
    vals, idx = jax.lax.top_k(peak_val, max_num)  # [K, max_num]
    hpi = jnp.take_along_axis(hp, idx, 1)
    hni = jnp.take_along_axis(hn, idx, 1)
    denom = hpi - 2 * vals + hni
    di = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (hpi - hni) / denom, 0.0)
    theta = (idx.astype(_F32) + di + 0.5) / nb * 2 * jnp.pi - jnp.pi
    return theta, vals > 0.0


# --------------------------------------------------------------------------
# Descriptors (bulk)
# --------------------------------------------------------------------------

_NBP = 4  # spatial bins per axis
_NBO = 8  # orientation bins
_DESC_GRID = 16  # sample grid per axis
_MAGNIF = 3.0


def _descriptors_bulk(grad_flat, h, w, base, fy, fx, sigma, theta,
                      shape_A=None, grad_vol=None, lvl=None):
    """128-D SIFT descriptors for all oriented keypoints at once ([K] inputs).

    Reference semantics: VLFeat vl_sift_calc_keypoint_descriptor — 4x4x8
    trilinear histogram over a 3σ-per-bin window, Gaussian-weighted, rotated
    to the keypoint frame. Accumulation = two one-hot contractions (GEMMs).
    """
    q = _DESC_GRID
    half = _NBP / 2.0
    lin = (np.arange(q, dtype=np.float32) + 0.5) / q * _NBP - half  # (-2, 2)
    vv, uu = np.meshgrid(lin, lin, indexing="ij")
    u = jnp.asarray(uu.reshape(-1))  # [P] x in bin units
    v = jnp.asarray(vv.reshape(-1))  # [P] y in bin units
    P = u.shape[0]

    sbp = _MAGNIF * sigma  # [K] pixels per bin
    ct, st = jnp.cos(theta), jnp.sin(theta)
    ox = sbp[:, None] * (ct[:, None] * u[None, :] - st[:, None] * v[None, :])
    oy = sbp[:, None] * (st[:, None] * u[None, :] + ct[:, None] * v[None, :])
    if shape_A is not None:
        # affine-normalized sampling: offsets warped by the keypoint shape
        off = jnp.stack([ox, oy], axis=1)  # [K, 2, P]
        off = jnp.einsum("kij,kjp->kip", shape_A, off)
        ox, oy = off[:, 0, :], off[:, 1, :]
    ys = fy[:, None] + oy
    xs = fx[:, None] + ox
    if grad_vol is not None and _win_eligible(h, w, shape_A):
        sgx, sgy = _window_vol2(grad_vol, lvl, fy, fx, ys, xs)
    else:
        sgx, sgy = _bilinear_vol2(grad_flat, h, w, base, ys, xs)
    mag = jnp.sqrt(sgx * sgx + sgy * sgy)
    ang = jnp.arctan2(sgy, sgx) - theta[:, None]
    ang = jnp.mod(ang + 4 * jnp.pi, 2 * jnp.pi)

    win = np.exp(-(uu.reshape(-1) ** 2 + vv.reshape(-1) ** 2) / (2.0 * half * half))
    wgt = mag * jnp.asarray(win)[None, :]  # [K, P]

    # spatial trilinear weights are keypoint-independent — precompute [P, 4]
    def axis_weights(coord):
        b0 = np.floor(coord)
        f = coord - b0
        b0i = b0.astype(np.int32)
        wm = np.zeros((coord.shape[0], _NBP), np.float32)
        for i, (bi, fi) in enumerate(zip(b0i, f)):
            if 0 <= bi < _NBP:
                wm[i, bi] = 1.0 - fi
            if 0 <= bi + 1 < _NBP:
                wm[i, bi + 1] = fi
        return wm

    wy = axis_weights(vv.reshape(-1) + half - 0.5)  # [P, 4]
    wx = axis_weights(uu.reshape(-1) + half - 0.5)
    wyx = jnp.asarray(np.einsum("py,px->pyx", wy, wx).reshape(P, _NBP * _NBP))

    ob = ang / (2 * jnp.pi) * _NBO
    ob0 = jnp.floor(ob)
    of = ob - ob0
    o0 = jnp.mod(ob0.astype(jnp.int32), _NBO)
    o1 = jnp.mod(o0 + 1, _NBO)
    wo = (jax.nn.one_hot(o0, _NBO, dtype=_F32) * (1 - of)[..., None]
          + jax.nn.one_hot(o1, _NBO, dtype=_F32) * of[..., None])  # [K, P, 8]

    # desc[k, yx, o] = sum_p wgt[k,p] * wyx[p,yx] * wo[k,p,o]
    t = wgt[:, :, None] * wo  # [K, P, 8]
    desc = jnp.einsum("pq,kpo->kqo", wyx, t)  # [K, 16, 8]
    return desc.reshape(-1, _NBP * _NBP * _NBO)


def _normalize_desc(desc: jax.Array, normalization: str) -> jax.Array:
    if normalization == "L1_ROOT":
        # reference: L1NormalizeFeatureDescriptors + sqrt (sift.cc)
        d = desc / jnp.maximum(jnp.sum(desc, 1, keepdims=True), 1e-12)
        d = jnp.sqrt(d)
    else:
        d = desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True), 1e-12)
        d = jnp.minimum(d, 0.2)
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    return d


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------


def _extract_octave(gauss: jax.Array, octave_scale: float, opts: SiftExtractionOptions,
                    coord_offset: float = 0.0, cap: int = 0):
    """Detection + description on one octave; fixed-capacity outputs.

    gauss: [S+3, H, W] at octave resolution. Octave pixel coords map to
    original-image coords as orig = octave_scale * x + coord_offset.
    `cap` scales with the octave area (keypoint counts follow pixel
    counts) so the per-keypoint gather stages don't burn full capacity on
    mostly-empty slots in the small octaves.
    """
    S = opts.octave_resolution
    ns, h, w = gauss.shape
    dog = gauss[1:] - gauss[:-1]  # [S+2, H, W]
    cap = cap or opts.octave_capacity

    s, y, x, cand_valid = _detect_candidates(dog, opts.peak_threshold, cap)
    fs, fy, fx, resp, ok = _refine_bulk(dog, s, y, x, opts.peak_threshold,
                                        opts.edge_threshold)
    ok &= cand_valid

    # compact survivors to half capacity before the orientation/descriptor
    # gathers (the expensive [K, P] stages): refinement rejects most
    # candidates, so the top half by response covers the real keypoints.
    # Only worthwhile at large capacities — small caps stay lossless.
    keep = max(1024, cap // 2)
    if keep < fs.shape[0]:
        score = jnp.where(ok, resp, -1.0)
        _, sel = jax.lax.top_k(score, keep)
        fs, fy, fx = fs[sel], fy[sel], fx[sel]
        resp, ok = resp[sel], ok[sel]

    sigma_oct = _SIGMA0 * jnp.exp2(fs / S)  # [K] at octave resolution
    gx, gy = _gradients(gauss)
    grad_flat = jnp.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    lvl = jnp.clip(jnp.round(fs).astype(jnp.int32), 0, S + 2)
    lvl_base = lvl * (h * w)
    # [L, H, W, 2] volume for the window-sampling path (matmul taps); the
    # DSP variant scales windows beyond the fixed window radius and stays
    # on the gather path
    grad_vol = None
    if not opts.domain_size_pooling and not opts.estimate_affine_shape \
            and opts.sampling == "window":
        grad_vol = jnp.stack([gx, gy], axis=-1)

    shape_A = None
    if opts.estimate_affine_shape:
        shape_A = _affine_shapes_bulk(grad_flat, h, w, lvl_base, fy, fx,
                                      sigma_oct, opts.affine_shape_iterations)

    max_ori = opts.max_num_orientations
    theta, tvalid = _orientations_bulk(grad_flat, h, w, lvl_base,
                                       fy, fx, sigma_oct, max_ori,
                                       shape_A=shape_A, grad_vol=grad_vol,
                                       lvl=lvl)

    # flatten orientations into the keypoint axis
    k = fs.shape[0]
    n = k * max_ori
    rep = lambda a: jnp.broadcast_to(a[:, None], (k, max_ori)).reshape(n)
    kp_fy, kp_fx = rep(fy), rep(fx)
    kp_sigma = rep(sigma_oct)
    kp_resp = rep(resp)
    kp_base = rep(lvl_base)
    kp_theta = theta.reshape(n)
    kp_valid = (tvalid & ok[:, None]).reshape(n)
    kp_shape = None
    if shape_A is not None:
        kp_shape = jnp.broadcast_to(shape_A[:, None], (k, max_ori, 2, 2)
                                    ).reshape(n, 2, 2)

    if opts.domain_size_pooling:
        # DSP-SIFT: pool descriptors over window scales (each scale reuses
        # the same bulk program; the pooled descriptor is the mean)
        scales = np.linspace(opts.dsp_min_scale, opts.dsp_max_scale,
                             opts.dsp_num_scales).astype(np.float32)
        kp_desc = jnp.zeros((n, _NBP * _NBP * _NBO), _F32)
        for s_fac in scales:
            kp_desc = kp_desc + _descriptors_bulk(
                grad_flat, h, w, kp_base, kp_fy, kp_fx,
                kp_sigma * float(s_fac), kp_theta, shape_A=kp_shape)
        kp_desc = kp_desc / len(scales)
    else:
        kp_lvl = rep(lvl) if grad_vol is not None else None
        kp_desc = _descriptors_bulk(grad_flat, h, w, kp_base,
                                    kp_fy, kp_fx, kp_sigma, kp_theta,
                                    shape_A=kp_shape, grad_vol=grad_vol,
                                    lvl=kp_lvl)

    kp_x = kp_fx * octave_scale + coord_offset
    kp_y = kp_fy * octave_scale + coord_offset
    kp_scale = kp_sigma * octave_scale
    return kp_x, kp_y, kp_scale, kp_theta, kp_resp, kp_valid, kp_desc


@functools.partial(jax.jit, static_argnums=(1,))
def _extract_static(image: jax.Array, opts: SiftExtractionOptions):
    """Core extractor on a [H, W] f32 image in [0, 1]. Shape-static."""
    h, w = image.shape
    S = opts.octave_resolution
    n_oct = _num_octaves(h, w, opts.first_octave, opts.num_octaves)

    if opts.first_octave < 0:
        base = _upsample2(image)
        cur_sigma = 2.0 * _SIGMA_N
        octave_scale = 0.5
        # jax.image.resize maps upsampled pixel i -> i/2 - 0.25 in original
        coord_offset = -0.25
    else:
        base = image
        cur_sigma = _SIGMA_N
        octave_scale = 1.0
        coord_offset = 0.0

    base = _blur(base, math.sqrt(max(_SIGMA0**2 - cur_sigma**2, 1e-8)))

    outs = []
    for o in range(n_oct):
        gauss = _build_octave(base, S)
        # capacity follows the octave pixel count (1/4 per octave, floored)
        cap_o = max(512, opts.octave_capacity >> (2 * o))
        outs.append(_extract_octave(gauss, octave_scale, opts, coord_offset,
                                    cap=cap_o))
        if o + 1 < n_oct:
            base = _downsample2(gauss[S])
            octave_scale *= 2.0

    kp_x = jnp.concatenate([o[0] for o in outs])
    kp_y = jnp.concatenate([o[1] for o in outs])
    kp_scale = jnp.concatenate([o[2] for o in outs])
    kp_theta = jnp.concatenate([o[3] for o in outs])
    kp_resp = jnp.concatenate([o[4] for o in outs])
    kp_valid = jnp.concatenate([o[5] for o in outs])
    kp_desc = jnp.concatenate([o[6] for o in outs])

    kp_desc = _normalize_desc(kp_desc, opts.normalization)
    desc_u8 = jnp.clip(jnp.round(512.0 * kp_desc), 0, 255).astype(jnp.uint8)

    # keep top max_num_features, ordered by scale (reference:
    # ExtractTopScaleFeatures, sift.cc) with response as tie-breaker
    cap = opts.max_num_features
    score = jnp.where(kp_valid, kp_scale * 1e3 + kp_resp, -jnp.inf)
    k = min(cap, score.shape[0])
    _, idx = jax.lax.top_k(score, k)
    return {
        "xy": jnp.stack([kp_x[idx], kp_y[idx]], axis=-1),
        "scale": kp_scale[idx],
        "orientation": kp_theta[idx],
        "response": kp_resp[idx],
        "valid": kp_valid[idx],
        "descriptors": desc_u8[idx],
    }


# --------------------------------------------------------------------------
# Host-facing API
# --------------------------------------------------------------------------


def _to_float_gray(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114], np.float32) if img.shape[-1] == 3 \
            else img[..., 0]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img, np.float32)


def _bucket_shape(h: int, w: int, quantum: int = 64) -> Tuple[int, int]:
    return -(-h // quantum) * quantum, -(-w // quantum) * quantum


def _pack_outputs(out: Dict[str, jax.Array]) -> jax.Array:
    """Pack the fixed-cap extractor outputs into ONE uint8 buffer
    [cap, 148]: 128 descriptor bytes + 5 bitcast f32 (x, y, scale,
    orientation, response masked to -inf when invalid). One buffer means
    ONE device->host transfer instead of six."""
    meta = jnp.stack([out["xy"][:, 0], out["xy"][:, 1], out["scale"],
                      out["orientation"],
                      jnp.where(out["valid"], out["response"], -jnp.inf)],
                     axis=-1)  # [cap, 5] f32; resp=-inf marks invalid rows
    meta_u8 = jax.lax.bitcast_convert_type(meta, jnp.uint8).reshape(
        meta.shape[0], 20)
    return jnp.concatenate([out["descriptors"], meta_u8], axis=-1)


def unpack_features(buf: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side inverse of _pack_outputs for one image's [cap, 148]."""
    buf = np.ascontiguousarray(buf)
    desc = buf[:, :128]
    meta = buf[:, 128:148].copy().view(np.float32).reshape(-1, 5)
    valid = np.isfinite(meta[:, 4])
    return {
        "xy": meta[:, :2],
        "scale": meta[:, 2],
        "orientation": meta[:, 3],
        "response": meta[:, 4],
        "valid": valid,
        "descriptors": desc,
    }


@functools.partial(jax.jit, static_argnums=(1,))
def _extract_packed_u8(image_u8: jax.Array, opts: SiftExtractionOptions):
    """uint8-in / packed-uint8-out extractor: the image ships over the
    host link at 1 byte/px (4x less than f32) and the result comes back
    as one buffer (_pack_outputs)."""
    img = image_u8.astype(jnp.float32) / 255.0
    return _pack_outputs(_extract_static.__wrapped__(img, opts))


def _to_u8_gray(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.ndim == 3:
        img = (img @ np.array([0.299, 0.587, 0.114], np.float32)
               if img.shape[-1] == 3 else img[..., 0])
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32) * (255.0 if img.max() <= 1.0
                                                     else 1.0), 0, 255
                      ).astype(np.uint8)
    return np.ascontiguousarray(img)


def _prepare_u8(image: np.ndarray, options: SiftExtractionOptions
                ) -> Tuple[np.ndarray, float, int, int]:
    """Grayscale + downscale + pad to the (64-quantum) shape bucket."""
    img = _to_u8_gray(image)
    h, w = img.shape
    scale = 1.0
    if max(h, w) > options.max_image_size:
        scale = options.max_image_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = np.asarray(jnp.clip(jnp.round(jax.image.resize(
            jnp.asarray(img, jnp.float32), (nh, nw), "bilinear")), 0, 255
        ).astype(jnp.uint8))
        h, w = nh, nw
    bh, bw = _bucket_shape(h, w)
    padded = np.zeros((bh, bw), np.uint8)
    padded[:h, :w] = img
    return padded, scale, h, w


def _finalize_features(feats: Dict[str, np.ndarray], scale: float,
                       h: int, w: int) -> Dict[str, np.ndarray]:
    xy = feats["xy"]
    valid = feats["valid"] & (xy[:, 0] < w) & (xy[:, 1] < h) \
        & (xy[:, 0] >= 0) & (xy[:, 1] >= 0)
    return {
        "xy": xy[valid] / scale,
        "scale": feats["scale"][valid] / scale,
        "orientation": feats["orientation"][valid],
        "response": feats["response"][valid],
        "descriptors": feats["descriptors"][valid],
    }


def extract(image: np.ndarray,
            options: SiftExtractionOptions = SiftExtractionOptions()
            ) -> Dict[str, np.ndarray]:
    """Extract SIFT features from a single image (uint8/f32, gray or RGB).

    Returns numpy dict with only the valid keypoints:
      xy [N,2], scale [N], orientation [N], response [N],
      descriptors uint8 [N,128].
    """
    options.check()
    padded, scale, h, w = _prepare_u8(image, options)
    buf = np.asarray(_extract_packed_u8(jnp.asarray(padded), options))
    return _finalize_features(unpack_features(buf), scale, h, w)


def extract_batch(images: np.ndarray,
                  options: SiftExtractionOptions = SiftExtractionOptions()):
    """Batched extraction over [B, H, W] f32 images; returns fixed-cap arrays
    (dict of [B, max_num_features, ...] + valid mask). The batch axis is the
    data-parallel sharding axis on a device mesh."""
    options.check()
    fn = jax.vmap(lambda im: _extract_static(im, options))
    return fn(jnp.asarray(images, jnp.float32))


@functools.partial(jax.jit, static_argnums=(1,))
def _extract_batch_packed_u8(images_u8: jax.Array,
                             opts: SiftExtractionOptions):
    return jax.vmap(lambda im: _extract_packed_u8.__wrapped__(im, opts))(
        images_u8)


def extract_batch_packed(padded_u8: np.ndarray,
                         options: SiftExtractionOptions
                         ) -> np.ndarray:
    """Production wall path: [B, H, W] uint8 (already bucket-padded) in,
    ONE [B, cap, 148] uint8 buffer out (see _pack_outputs). Callers unpack
    per image with unpack_features."""
    options.check()
    return np.asarray(_extract_batch_packed_u8(jnp.asarray(padded_u8),
                                               options))


def keypoints_to_affine(xy: np.ndarray, scale: np.ndarray,
                        orientation: np.ndarray) -> np.ndarray:
    """Pack keypoints in the reference 6-column layout
    (x, y, a11, a12, a21, a22) with a = scale * R(theta)
    (reference: src/colmap/feature/types.h FeatureKeypoint)."""
    c = np.cos(orientation) * scale
    s = np.sin(orientation) * scale
    return np.stack([xy[:, 0], xy[:, 1], c, -s, s, c], axis=-1).astype(np.float32)


def affine_to_keypoints(kp6: np.ndarray):
    """Inverse of keypoints_to_affine: returns (xy, scale, orientation)."""
    kp6 = np.asarray(kp6, np.float32)
    if kp6.shape[1] == 2:
        return kp6, np.ones(len(kp6), np.float32), np.zeros(len(kp6), np.float32)
    a11, a12, a21, a22 = kp6[:, 2], kp6[:, 3], kp6[:, 4], kp6[:, 5]
    scale = np.sqrt(np.maximum((a11 * a11 + a12 * a12 + a21 * a21 + a22 * a22) / 2, 0))
    ori = np.arctan2(a21, a11)
    return kp6[:, :2], scale, ori
