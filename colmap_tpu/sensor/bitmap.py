"""Image IO, grayscale conversion, EXIF focal-length extraction.

Re-design of the reference Bitmap/FreeImage wrapper
(reference: src/colmap/sensor/bitmap.h:69, ExifFocalLength :146) —
host-side only; pixel data is handed to the device extractor as f32
arrays. 8-bit PNG (grey, grey+alpha, RGB, RGBA) and binary PGM/PPM are read
and written with numpy and zlib alone, which covers the renderer's and the
undistorter's output; JPEG, TIFF, BMP and EXIF metadata go through PIL
when it is installed. The camera-spec sensor-width table of the reference
(src/colmap/sensor/specs.cc, ~3k entries) is replaced by a compact table of
common sensor formats plus the EXIF FocalPlaneResolution path, with the same
fallback chain as the reference ImageReader
(src/colmap/controllers/image_reader.cc): EXIF focal -> sensor-width DB ->
default_focal_length_factor * max(width, height).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

try:
    from PIL import Image, ExifTags
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


# Sensor-width lookup: the full ~3.7k-entry make/model table
# (sensor/camera_specs.csv + camera_database.py, reference
# src/colmap/sensor/specs.cc + database.cc QuerySensorWidth).
from colmap_tpu.sensor.camera_database import query_sensor_width

_EXIF_TAGS = {v: k for k, v in ExifTags.TAGS.items()} if _HAS_PIL else {}


@dataclasses.dataclass
class Bitmap:
    """In-memory image + metadata (reference: sensor/bitmap.h)."""

    data: np.ndarray  # [H, W] gray f32 in [0,1] or [H, W, 3] uint8
    exif_focal_px: Optional[float] = None
    make: str = ""
    model: str = ""
    gps: Optional[np.ndarray] = None  # (lat deg, lon deg, alt m)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _rational(v):
    try:
        return float(v)
    except Exception:
        try:
            return v[0] / v[1]
        except Exception:
            return None


def exif_focal_length_px(pil_img, width: int) -> Tuple[Optional[float], str, str]:
    """EXIF focal in pixels (reference: Bitmap::ExifFocalLength, bitmap.cc).

    Chain: FocalLengthIn35mmFilm -> FocalLength + FocalPlaneXResolution ->
    FocalLength + sensor-width database.
    """
    make = model = ""
    try:
        exif = pil_img.getexif()
    except Exception:
        return None, make, model
    if not exif:
        return None, make, model

    def tag(name):
        tid = _EXIF_TAGS.get(name)
        if tid is None:
            return None
        v = exif.get(tid)
        if v is None:
            try:
                v = exif.get_ifd(0x8769).get(tid)  # EXIF sub-IFD
            except Exception:
                v = None
        return v

    make = str(tag("Make") or "").strip()
    model = str(tag("Model") or "").strip()

    f35 = _rational(tag("FocalLengthIn35mmFilm") or 0)
    if f35 and f35 > 0:
        return width * f35 / 36.0, make, model

    focal_mm = _rational(tag("FocalLength") or 0)
    if focal_mm and focal_mm > 0:
        fpx = _rational(tag("FocalPlaneXResolution") or 0)
        unit = tag("FocalPlaneResolutionUnit") or 2
        pix_w = _rational(tag("ExifImageWidth") or 0) or width
        if fpx and fpx > 0:
            unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(int(unit), 25.4)
            sensor_w_mm = pix_w / fpx * unit_mm
            if sensor_w_mm > 0:
                return width * focal_mm / sensor_w_mm, make, model
        sw = query_sensor_width(make, model)
        if sw:
            return width * focal_mm / sw, make, model
    return None, make, model


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples/pixel
_NATIVE_FORMATS = (".png", ".pgm", ".ppm")


def _unfilter_png(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (8-bit samples).

    None, Sub and Up are vectorized; Average and Paeth depend on the
    decoded left neighbour and run pixel by pixel (this module's own
    writer uses filter None, so its files take the fast path)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    out = np.zeros((h, w, c), np.uint8)
    prev = np.zeros((w, c), np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].reshape(w, c).astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: running sum along the row
            cur = np.cumsum(line, axis=0) & 0xFF
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # average / Paeth
            cur = np.zeros((w, c), np.int32)
            left = upleft = np.zeros(c, np.int32)
            for x in range(w):
                up = prev[x]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                left = cur[x] = (line[x] + pred) & 0xFF
                upleft = up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> uint8 [H, W] or [H, W, C]."""
    with open(path, "rb") as fp:
        blob = fp.read()
    if not blob.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNG is supported without PIL")
    c = _PNG_CHANNELS[ctype]
    data = _unfilter_png(zlib.decompress(b"".join(idat)), h, w, c)
    return data[..., 0] if c == 1 else data


def write_png(path: str, data: np.ndarray):
    """uint8 [H, W] grey or [H, W, 3] RGB -> PNG (filter type 0)."""
    arr = np.ascontiguousarray(data, np.uint8)
    h, w = arr.shape[:2]
    ctype = {2: 0, 3: 2}[arr.ndim]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(_PNG_SIGNATURE
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


def read_pnm(path: str) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) with maxval <= 255 -> uint8 array."""
    with open(path, "rb") as fp:
        blob = fp.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval; '#' comments
        while blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b"#":
            pos = blob.index(b"\n", pos)
            continue
        end = pos
        while not blob[end:end + 1].isspace():
            end += 1
        fields.append(blob[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], *map(int, fields[1:])
    if magic not in (b"P5", b"P6") or maxval > 255:
        raise ValueError(f"{path}: only binary 8-bit PGM/PPM is supported")
    c = 3 if magic == b"P6" else 1
    data = np.frombuffer(blob, np.uint8, w * h * c, pos + 1)
    return data.reshape((h, w, c) if c == 3 else (h, w))


def write_pnm(path: str, data: np.ndarray):
    arr = np.ascontiguousarray(data, np.uint8)
    magic = b"P6" if arr.ndim == 3 else b"P5"
    with open(path, "wb") as fp:
        fp.write(b"%s\n%d %d\n255\n" % (magic, arr.shape[1], arr.shape[0]))
        fp.write(arr.tobytes())


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma of uint8 RGB, rounded like PIL's convert("L")."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _read_pixels(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    data = read_png(path) if ext == ".png" else read_pnm(path)
    if data.ndim == 3 and data.shape[2] in (2, 4):  # drop alpha
        data = data[..., :-1]
        data = data[..., 0] if data.shape[2] == 1 else data
    return data


def _require_pil(path: str):
    if not _HAS_PIL:
        raise RuntimeError(
            f"{path}: reading or writing this format needs PIL (Pillow); "
            f"PNG, PGM and PPM work without it")


def read_bitmap(path: str, as_rgb: bool = False) -> Bitmap:
    """Read an image file; grayscale f32 in [0,1] by default."""
    if os.path.splitext(path)[1].lower() in _NATIVE_FORMATS:
        data = _read_pixels(path)
        if as_rgb:
            data = data if data.ndim == 3 else np.repeat(data[..., None], 3, 2)
        else:
            data = (rgb_to_gray(data) if data.ndim == 3
                    else data).astype(np.float32) / 255.0
        return Bitmap(data=data)
    _require_pil(path)
    with Image.open(path) as im:
        focal, make, model = exif_focal_length_px(im, im.width)
        gps = exif_gps_position(im)
        if as_rgb:
            data = np.asarray(im.convert("RGB"), np.uint8)
        else:
            data = np.asarray(im.convert("L"), np.float32) / 255.0
    return Bitmap(data=data, exif_focal_px=focal, make=make, model=model,
                  gps=gps)


def write_bitmap(path: str, data: np.ndarray):
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, arr)
    elif ext in (".pgm", ".ppm"):
        write_pnm(path, arr)
    else:
        _require_pil(path)
        Image.fromarray(arr).save(path)


def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a triangle (bilinear) filter whose support
    widens with the reduction factor, as PIL's BILINEAR resize does."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (np.arange(n_out) + 0.5) * scale
    x = np.arange(n_in) + 0.5
    wts = np.maximum(0.0, 1.0 - np.abs(x[None, :] - centers[:, None])
                     / support)
    return wts / wts.sum(axis=1, keepdims=True)


def resize(data: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of [H, W] or [H, W, C]; keeps uint8 or float."""
    wy = _resample_matrix(data.shape[0], height)
    wx = _resample_matrix(data.shape[1], width)
    out = np.tensordot(wy, data.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(out, wx, axes=(1, 1)), -1, 1)
    if data.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(data.dtype)


def rescale(data: np.ndarray, max_size: int) -> Tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size; returns (image, scale)."""
    h, w = data.shape[:2]
    if max(h, w) <= max_size:
        return data, 1.0
    scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return resize(data, nh, nw), scale


def default_focal_length(width: int, height: int, factor: float = 1.2) -> float:
    """Reference: ImageReaderOptions.default_focal_length_factor
    (controllers/image_reader.h)."""
    return factor * max(width, height)


def list_image_files(image_dir: str) -> list:
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}
    files = []
    for root, _, names in os.walk(image_dir):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in exts:
                files.append(os.path.relpath(os.path.join(root, n), image_dir))
    return sorted(files)


def exif_gps_position(pil_img):
    """EXIF GPS (lat deg, lon deg, alt m) or None
    (reference: Bitmap::ExifLatitude/Longitude/Altitude, bitmap.cc)."""
    try:
        exif = pil_img.getexif()
        gps = exif.get_ifd(0x8825)  # GPSInfo IFD
    except Exception:
        return None
    if not gps:
        return None

    def dms(v, ref, neg):
        try:
            d = float(v[0]) + float(v[1]) / 60.0 + float(v[2]) / 3600.0
            return -d if ref in neg else d
        except Exception:
            return None

    lat = dms(gps.get(2), str(gps.get(1, "N")), ("S",))
    lon = dms(gps.get(4), str(gps.get(3, "E")), ("W",))
    if lat is None or lon is None:
        return None
    alt = 0.0
    try:
        alt = float(gps.get(6, 0.0))
        if int(gps.get(5, 0)) == 1:
            alt = -alt
    except Exception:
        pass
    return np.array([lat, lon, alt], np.float64)
