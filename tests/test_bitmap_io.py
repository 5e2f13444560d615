"""Image IO without PIL: PNG and PGM/PPM round trips, resize, errors."""

import numpy as np
import pytest

from colmap_tpu.sensor import bitmap as bm


@pytest.mark.parametrize("shape", [(31, 47), (31, 47, 3)])
@pytest.mark.parametrize("ext", [".png", ".pgm"])
def test_native_format_roundtrip(tmp_path, rng, shape, ext):
    if ext == ".pgm" and len(shape) == 3:
        ext = ".ppm"
    data = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / f"img{ext}")
    bm.write_bitmap(path, data)
    got = bm.read_png(path) if ext == ".png" else bm.read_pnm(path)
    np.testing.assert_array_equal(got, data)
    rgb = bm.read_bitmap(path, as_rgb=True).data
    assert rgb.shape == shape[:2] + (3,)
    gray = bm.read_bitmap(path).data
    want = bm.rgb_to_gray(data) if len(shape) == 3 else data
    np.testing.assert_allclose(gray, want.astype(np.float32) / 255.0)


def test_png_filters_decode(tmp_path, rng):
    """Rows written with the Sub, Up, Average and Paeth filters (as other
    encoders write them) decode to the original pixels."""
    import struct
    import zlib

    h, w, c = 6, 9, 3
    img = rng.integers(0, 256, (h, w, c)).astype(np.int32)
    raw = []
    prev = np.zeros((w, c), np.int32)
    for y in range(h):
        ftype = y % 5
        cur = img[y]
        left = np.vstack([np.zeros((1, c), np.int32), cur[:-1]])
        upleft = np.vstack([np.zeros((1, c), np.int32), prev[:-1]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw.append(bytes([ftype]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path = tmp_path / "filtered.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(bm.read_png(str(path)), img)


def test_jpeg_without_pil_fails_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr(bm, "_HAS_PIL", False)
    with pytest.raises(RuntimeError, match="needs PIL"):
        bm.read_bitmap(str(tmp_path / "a.jpg"))
    with pytest.raises(RuntimeError, match="needs PIL"):
        bm.write_bitmap(str(tmp_path / "a.jpg"), np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_bilinear(dtype):
    """Constant images stay constant; a linear ramp stays a ramp whose
    samples sit at the output pixel centres."""
    const = np.full((40, 60), 200, np.uint8).astype(dtype)
    np.testing.assert_array_equal(bm.resize(const, 17, 23), const[:17, :23])
    ramp = np.tile(np.arange(64, dtype=np.float64), (8, 1))
    out = bm.resize(ramp.astype(dtype), 8, 16)
    centres = (np.arange(16) + 0.5) * 4 - 0.5
    np.testing.assert_allclose(out[0, 1:-1], centres[1:-1], atol=0.51)
    assert out.dtype == dtype
    small, scale = bm.rescale(ramp.astype(dtype), 32)
    assert small.shape == (4, 32) and scale == 0.5
