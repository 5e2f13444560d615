"""Multi-view depth/normal fusion into a dense point cloud.

Reference: src/colmap/mvs/fusion.h:53-153 (StereoFusion::Run :145,
Fuse :377-530): BFS traversal across consistent pixels with reprojection /
depth / normal thresholds, fusing each consistent set into one point.

Re-design: the per-pixel BFS chains become DENSE consistency checks —
for one reference image, all pixels are projected into all overlapping
source views in one batched program (bilinear depth lookups, relative depth
+ normal-angle + reprojection gates), and the fused point is the average
over the consistent support set. The sequential part that remains (marking
source pixels as consumed so points are not duplicated) is a host-side
visited mask updated per reference image — O(images) host steps like the
reference's outer loop, with all pixel math on device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32


@dataclasses.dataclass(frozen=True)
class StereoFusionOptions:
    """Mirrors StereoFusionOptions (reference: mvs/fusion.h:53)."""

    max_reproj_error: float = 2.0
    max_depth_error: float = 0.01  # relative
    max_normal_error_deg: float = 10.0
    min_num_pixels: int = 3  # fused track size incl. the reference pixel
    max_num_images: int = 20  # sources checked per reference


@functools.partial(jax.jit, static_argnums=())
def _fuse_one(ref_depth, ref_normal, ref_img, K_ref, R_ref, t_ref,
              src_depths, src_normals, K_src, R_src, t_src,
              src_visited, max_reproj, max_rel_depth, min_cos):
    """Consistency + fusion for one reference image against S sources.

    All rotations/translations are world->cam. Returns per-pixel:
      xyz_mean [H,W,3] (world), normal_mean, count [H,W],
      proj coords into each src [S,H,W,2], consistent [S,H,W].
    """
    h, w = ref_depth.shape
    ys, xs = jnp.mgrid[0:h, 0:w]
    pix = jnp.stack([xs.astype(_F32) + 0.5, ys.astype(_F32) + 0.5], -1)
    Kinv = jnp.linalg.inv(K_ref)
    rays = jnp.concatenate([pix, jnp.ones((h, w, 1), _F32)], -1) @ Kinv.T
    Xc = ref_depth[..., None] * rays  # ref cam frame
    Xw = (Xc - t_ref) @ R_ref  # world: R^T (Xc - t)
    n_w = ref_normal @ R_ref  # normal to world

    def per_src(sd, sn, Ks, Rs, ts, visited):
        Xs = Xw @ Rs.T + ts  # src cam frame
        z = Xs[..., 2]
        p = Xs @ Ks.T
        pz = jnp.where(jnp.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        sx = p[..., 0] / pz
        sy = p[..., 1] / pz
        # bilinear depth sample
        hs, ws_ = sd.shape
        x0 = jnp.floor(sx - 0.5).astype(jnp.int32)
        y0 = jnp.floor(sy - 0.5).astype(jnp.int32)
        fx = sx - 0.5 - x0
        fy = sy - 0.5 - y0
        inb = (sx >= 0.5) & (sx <= ws_ - 0.5) & (sy >= 0.5) & (sy <= hs - 0.5)
        flat = sd.reshape(-1)

        def tap(yi, xi, wgt):
            yc = jnp.clip(yi, 0, hs - 1)
            xc = jnp.clip(xi, 0, ws_ - 1)
            v = jnp.take(flat, yc * ws_ + xc)
            return jnp.where(v > 0, v * wgt, 0.0), jnp.where(v > 0, wgt, 0.0)

        v00, w00 = tap(y0, x0, (1 - fy) * (1 - fx))
        v01, w01 = tap(y0, x0 + 1, (1 - fy) * fx)
        v10, w10 = tap(y0 + 1, x0, fy * (1 - fx))
        v11, w11 = tap(y0 + 1, x0 + 1, fy * fx)
        wsum = w00 + w01 + w10 + w11
        d_s = jnp.where(wsum > 0.5, (v00 + v01 + v10 + v11) / jnp.maximum(wsum, 1e-9), 0.0)

        # nearest-pixel normal + visited lookup
        xi = jnp.clip(jnp.round(sx - 0.5).astype(jnp.int32), 0, ws_ - 1)
        yi = jnp.clip(jnp.round(sy - 0.5).astype(jnp.int32), 0, hs - 1)
        n_s = sn.reshape(-1, 3)[yi * ws_ + xi]  # src cam frame
        n_s_w = n_s @ Rs
        vis = visited.reshape(-1)[yi * ws_ + xi]

        rel_err = jnp.abs(z - d_s) / jnp.maximum(d_s, 1e-9)
        cosang = jnp.sum(n_w * n_s_w, axis=-1)
        ok = (inb & (z > 0) & (d_s > 0) & (rel_err < max_rel_depth)
              & (cosang > min_cos) & (~vis) & (ref_depth > 0))

        # the src surface point (world) for averaging
        Kinv_s = jnp.linalg.inv(Ks)
        q = jnp.stack([sx, sy, jnp.ones_like(sx)], -1) @ Kinv_s.T
        Xs_hat = q * d_s[..., None]
        Xw_hat = (Xs_hat - ts) @ Rs
        return ok, Xw_hat, n_s_w, jnp.stack([sx, sy], -1)

    ok, Xw_hat, n_hat, proj = jax.vmap(per_src)(
        src_depths, src_normals, K_src, R_src, t_src, src_visited)

    cnt = jnp.sum(ok, axis=0)
    okf = ok[..., None].astype(_F32)
    xyz_sum = Xw + jnp.sum(Xw_hat * okf, axis=0)
    n_sum = n_w + jnp.sum(n_hat * okf, axis=0)
    denom = (cnt + 1).astype(_F32)[..., None]
    xyz_mean = xyz_sum / denom
    n_norm = n_sum / jnp.maximum(jnp.linalg.norm(n_sum, axis=-1, keepdims=True), 1e-9)
    return xyz_mean, n_norm, cnt, proj, ok


def fuse(model, depth_maps: Dict[int, np.ndarray],
         normal_maps: Dict[int, np.ndarray],
         images: Optional[Dict[int, np.ndarray]] = None,
         options: StereoFusionOptions = StereoFusionOptions(),
         consistency_out: Optional[Dict[int, "object"]] = None
         ) -> Dict[str, np.ndarray]:
    """Fuse per-image depth/normal maps into a point cloud.

    model: mvs.model.MVSModel. Returns dict with xyz [N,3], normal [N,3],
    color [N,3] uint8. When `consistency_out` is a dict, it is filled with
    per-reference ConsistencyGraphs (reference: mvs/consistency_graph.h).
    """
    min_cos = float(np.cos(np.radians(options.max_normal_error_deg)))
    ids = [i for i in model.images if i in depth_maps]
    visited = {i: np.zeros(depth_maps[i].shape, bool) for i in ids}

    all_xyz: List[np.ndarray] = []
    all_normal: List[np.ndarray] = []
    all_color: List[np.ndarray] = []

    for ref_id in ids:
        im = model.images[ref_id]
        srcs = [s for s in model.src_images(ref_id, options.max_num_images)
                if s in depth_maps]
        if not srcs:
            continue
        # pad sources to a common shape (usually identical)
        hs = max(depth_maps[s].shape[0] for s in srcs)
        ws = max(depth_maps[s].shape[1] for s in srcs)

        def pad2(a):
            out = np.zeros((hs, ws) + a.shape[2:], a.dtype)
            out[: a.shape[0], : a.shape[1]] = a
            return out

        sd = np.stack([pad2(depth_maps[s]) for s in srcs])
        sn = np.stack([pad2(normal_maps[s]) for s in srcs])
        sv = np.stack([pad2(visited[s]) for s in srcs])
        Ks = np.stack([model.images[s].K for s in srcs]).astype(np.float32)
        Rs = np.stack([model.images[s].R for s in srcs]).astype(np.float32)
        ts = np.stack([model.images[s].t for s in srcs]).astype(np.float32)

        ref_active = depth_maps[ref_id] * (~visited[ref_id])
        xyz, nrm, cnt, proj, ok = jax.tree.map(np.asarray, _fuse_one(
            jnp.asarray(ref_active, _F32),
            jnp.asarray(normal_maps[ref_id], _F32),
            jnp.asarray(images[ref_id] if images else np.zeros_like(ref_active), _F32),
            jnp.asarray(im.K, _F32), jnp.asarray(im.R, _F32),
            jnp.asarray(im.t, _F32),
            jnp.asarray(sd, _F32), jnp.asarray(sn, _F32),
            jnp.asarray(Ks), jnp.asarray(Rs), jnp.asarray(ts),
            jnp.asarray(sv),
            jnp.asarray(options.max_reproj_error, _F32),
            jnp.asarray(options.max_depth_error, _F32),
            jnp.asarray(min_cos, _F32)))

        accept = (cnt + 1) >= options.min_num_pixels
        accept &= ref_active > 0
        if consistency_out is not None:
            from colmap_tpu.mvs.consistency_graph import ConsistencyGraph

            consistency_out[ref_id] = ConsistencyGraph.from_masks(
                ok & accept[None], srcs)
        yy, xx = np.nonzero(accept)
        if len(yy) == 0:
            continue
        all_xyz.append(xyz[yy, xx])
        all_normal.append(nrm[yy, xx])
        if images is not None and ref_id in images:
            g = images[ref_id][yy, xx]
            g8 = (np.clip(g, 0, 1) * 255).astype(np.uint8) if g.dtype != np.uint8 else g
            all_color.append(np.stack([g8] * 3, -1) if g8.ndim == 1 else g8)
        else:
            all_color.append(np.full((len(yy), 3), 128, np.uint8))

        # mark consumed pixels in the source views
        visited[ref_id][yy, xx] = True
        for si, s in enumerate(srcs):
            m = ok[si] & accept
            py = np.clip(np.round(proj[si, ..., 1] - 0.5).astype(int), 0,
                         depth_maps[s].shape[0] - 1)
            px = np.clip(np.round(proj[si, ..., 0] - 0.5).astype(int), 0,
                         depth_maps[s].shape[1] - 1)
            visited[s][py[m], px[m]] = True

    if not all_xyz:
        return {"xyz": np.zeros((0, 3), np.float32),
                "normal": np.zeros((0, 3), np.float32),
                "color": np.zeros((0, 3), np.uint8)}
    return {"xyz": np.concatenate(all_xyz).astype(np.float32),
            "normal": np.concatenate(all_normal).astype(np.float32),
            "color": np.concatenate(all_color)}


def write_ply(path: str, xyz: np.ndarray, normal: Optional[np.ndarray] = None,
              color: Optional[np.ndarray] = None):
    """Binary little-endian PLY with optional normals/colors
    (reference: util/ply.cc WriteBinaryPlyPoints)."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    if normal is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if color is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n" + "\n".join(props) + "\nend_header\n")
    cols = [np.asarray(xyz, "<f4")]
    if normal is not None:
        cols.append(np.asarray(normal, "<f4"))
    dt = [("xyz", "<f4", 3)] + ([("n", "<f4", 3)] if normal is not None else [])
    if color is not None:
        dt.append(("c", "u1", 3))
    rec = np.zeros(n, dtype=dt)
    rec["xyz"] = xyz
    if normal is not None:
        rec["n"] = normal
    if color is not None:
        rec["c"] = color
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(tuple(line.split()[1:]))
            elif line == "end_header":
                break
        dt = []
        for typ, name in props:
            dt.append((name, "<f4" if typ == "float" else "u1"))
        rec = np.frombuffer(f.read(), dtype=dt, count=n)
    out = {"xyz": np.stack([rec["x"], rec["y"], rec["z"]], -1)}
    if "nx" in rec.dtype.names:
        out["normal"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], -1)
    if "red" in rec.dtype.names:
        out["color"] = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
    return out
