"""Tests for SIFT extraction.

Mirrors the reference test strategy (src/colmap/feature/sift_test.cc):
synthetic-image invariants + repeatability under known warps + (when
OpenCV is available) cross-implementation keypoint parity, the analog of
MatchSiftFeaturesCPUvsGPU (sift_test.cc:613).
"""

import dataclasses

import numpy as np
import pytest

import jax

from colmap_tpu.features import matching as matching_mod
from colmap_tpu.features import sift


OPTS = sift.SiftExtractionOptions(octave_capacity=768, max_num_features=1536)


def _textured_image(rng, h=256, w=320):
    base = rng.normal(0, 1, (h // 8, w // 8)).astype(np.float32)
    img = np.array(jax.image.resize(base, (h, w), "bicubic"))
    img = img + 0.3 * np.array(jax.image.resize(
        rng.normal(0, 1, (h // 2, w // 2)).astype(np.float32), (h, w), "bicubic"))
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def textured():
    return _textured_image(np.random.default_rng(7))


def test_window_sampling_matches_gather(textured):
    """The matmul window-sampling path must reproduce the gather path:
    identical keypoints (detection is shared) and near-identical
    descriptors (bilinear taps via separable hat-weight matmuls are the
    same arithmetic up to float association; nearest taps differ only on
    exact .5 rounding ties)."""
    win = sift.extract(textured, dataclasses.replace(OPTS, sampling="window"))
    gat = sift.extract(textured, dataclasses.replace(OPTS, sampling="gather"))
    assert len(win["xy"]) == len(gat["xy"]) > 100
    assert np.allclose(win["xy"], gat["xy"], atol=1e-4)
    dw = win["descriptors"].astype(np.int32)
    dg = gat["descriptors"].astype(np.int32)
    # uint8-quantized descriptors: allow tiny quantization flips
    frac_close = (np.abs(dw - dg) <= 1).mean()
    assert frac_close > 0.999, f"only {frac_close:.4f} of entries within 1"


def test_blob_localization():
    h, w = 192, 256
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    centers = [(60, 80, 6.0), (120, 200, 10.0), (150, 60, 4.0)]
    for cy, cx, s in centers:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    out = sift.extract(img, OPTS)
    assert len(out["xy"]) >= len(centers)
    for cy, cx, s in centers:
        d = np.hypot(out["xy"][:, 0] - cx, out["xy"][:, 1] - cy)
        i = int(np.argmin(d))
        assert d[i] < 0.5, f"blob at {(cx, cy)} localized {d[i]:.2f}px away"
        # DoG-detected scale tracks the blob sigma (ratio ~0.89)
        assert 0.6 * s < out["scale"][i] < 1.2 * s


def test_translation_repeatability(textured):
    img = textured
    shift = 8
    img2 = np.roll(img, (shift, shift), axis=(0, 1))
    f1 = sift.extract(img, OPTS)
    f2 = sift.extract(img2, OPTS)
    # match descriptors, check offsets
    b1 = matching_mod.prepare_descriptors(f1["descriptors"])
    b2 = matching_mod.prepare_descriptors(f2["descriptors"])
    idx = np.asarray(matching_mod.match_descriptors(b1, b2))
    m = matching_mod.matches_to_pairs(idx)
    assert len(m) > 100
    d = f2["xy"][m[:, 1]] - f1["xy"][m[:, 0]]
    err = np.hypot(d[:, 0] - shift, d[:, 1] - shift)
    assert (err < 1.0).mean() > 0.8


def test_rotation_scale_repeatability(textured):
    cv2 = pytest.importorskip("cv2")
    img = textured
    h, w = img.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 25, 0.85)
    img2 = cv2.warpAffine(img, M, (w, h))
    f1 = sift.extract(img, OPTS)
    f2 = sift.extract(img2, OPTS)
    b1 = matching_mod.prepare_descriptors(f1["descriptors"])
    b2 = matching_mod.prepare_descriptors(f2["descriptors"])
    m = matching_mod.matches_to_pairs(
        np.asarray(matching_mod.match_descriptors(b1, b2)))
    assert len(m) > 80
    gt = np.c_[f1["xy"][m[:, 0]], np.ones(len(m))] @ M.T
    err = np.hypot(*(f2["xy"][m[:, 1]] - gt).T)
    assert (err < 2.0).mean() > 0.75


def test_cv2_keypoint_parity(textured):
    """Location parity vs OpenCV SIFT (analog of sift_test.cc:613)."""
    cv2 = pytest.importorskip("cv2")
    from scipy.spatial import cKDTree

    f1 = sift.extract(textured, OPTS)
    det = cv2.SIFT_create(contrastThreshold=0.02, edgeThreshold=10)
    kps = det.detect(textured, None)
    cvxy = np.array([k.pt for k in kps])
    d, _ = cKDTree(f1["xy"]).query(cvxy)
    assert (d < 1.5).mean() > 0.6


def test_descriptor_normalization(textured):
    f = sift.extract(textured, OPTS)
    d = f["descriptors"].astype(np.float32) / 512.0
    # L1_ROOT: sum of squares == L1 of the pre-sqrt vector == 1
    norms = np.sum(d * d, axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=0.05)
    assert f["descriptors"].dtype == np.uint8


def test_affine_roundtrip():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (32, 2)).astype(np.float32)
    scale = rng.uniform(1, 8, 32).astype(np.float32)
    ori = rng.uniform(-np.pi, np.pi, 32).astype(np.float32)
    kp6 = sift.keypoints_to_affine(xy, scale, ori)
    xy2, s2, o2 = sift.affine_to_keypoints(kp6)
    np.testing.assert_allclose(xy2, xy, atol=1e-5)
    np.testing.assert_allclose(s2, scale, rtol=1e-5)
    np.testing.assert_allclose(o2, ori, atol=1e-5)


def test_max_num_features_cap(textured):
    opts = sift.SiftExtractionOptions(octave_capacity=768, max_num_features=64)
    f = sift.extract(textured, opts)
    assert len(f["xy"]) <= 64
    # capped selection keeps the largest scales (reference:
    # ExtractTopScaleFeatures)
    full = sift.extract(textured, OPTS)
    assert np.median(f["scale"]) >= np.median(full["scale"]) - 1e-6


def test_packed_path_matches_legacy(textured):
    """The production packed I/O path (uint8 upload, one packed uint8
    download; extract/_extract_packed_u8) must produce the same keypoint
    SET as the separately-jitted f32 program. Exact ordering may differ
    (jit-boundary fusion perturbs low-order score bits), so agreement is
    checked set-wise with descriptor equality on matched rows."""
    import jax.numpy as jnp

    o = sift.SiftExtractionOptions(max_num_features=512,
                                   octave_capacity=1024)
    packed = sift.extract(textured, o)

    padded, scale, h, w = sift._prepare_u8(textured, o)
    out = sift._extract_static(jnp.asarray(padded, jnp.float32) / 255.0, o)
    legacy = sift._finalize_features(
        {k: np.asarray(v) for k, v in out.items()}, scale, h, w)

    assert abs(len(packed["xy"]) - len(legacy["xy"])) <= 2
    # nearest-neighbour matching on (xy, scale, orientation) jointly —
    # SIFT emits up to two orientations at one location, so xy alone
    # would pair the wrong twin
    def emb(f):
        return np.concatenate([
            f["xy"], 5.0 * np.log2(f["scale"])[:, None],
            3.0 * np.cos(f["orientation"])[:, None],
            3.0 * np.sin(f["orientation"])[:, None]], axis=-1)

    d = np.linalg.norm(emb(packed)[:, None] - emb(legacy)[None], axis=-1)
    nn = d.argmin(1)
    close = d[np.arange(len(nn)), nn] < 0.5
    assert close.mean() > 0.98
    # descriptors are uint8-quantized (round(512*f32)): low-order float
    # differences across fusion flip single bytes by +-1 — compare with a
    # per-byte tolerance instead of bit equality
    diff = np.abs(packed["descriptors"][close].astype(np.int32)
                  - legacy["descriptors"][nn[close]].astype(np.int32))
    assert (diff.max(-1) <= 2).mean() > 0.95
    assert diff.mean() < 0.2


def test_unpack_features_roundtrip():
    """_pack_outputs/unpack_features: bitcast f32 meta + invalid marking
    survive the uint8 round trip exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    n = 64
    out = {
        "xy": jnp.asarray(rng.normal(size=(n, 2)) * 100, jnp.float32),
        "scale": jnp.asarray(rng.uniform(1, 8, n), jnp.float32),
        "orientation": jnp.asarray(rng.uniform(-3, 3, n), jnp.float32),
        "response": jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
        "valid": jnp.asarray(rng.random(n) > 0.3),
        "descriptors": jnp.asarray(
            rng.integers(0, 256, (n, 128)), jnp.uint8),
    }
    un = sift.unpack_features(np.asarray(sift._pack_outputs(out)))
    valid = np.asarray(out["valid"])
    assert (un["valid"] == valid).all()
    for k in ("xy", "scale", "orientation"):
        assert (un[k] == np.asarray(out[k])).all(), k
    assert (un["response"][valid] == np.asarray(out["response"])[valid]).all()
    assert (un["descriptors"] == np.asarray(out["descriptors"])).all()
