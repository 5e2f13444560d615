"""Dense MVS controllers: patch-match stereo, fusion, meshing over a
COLMAP-layout workspace.

Reference entry points: RunPatchMatchStereo (exe/mvs.cc:78), RunStereoFuser
(:136), RunPoissonMesher (:120), RunDelaunayMesher (:41); the orchestration
mirrors PatchMatchController (mvs/patch_match.cc:193-430) — per-reference
problems with '__auto__' source selection — but problems run as batched
device programs instead of per-GPU threads. Workspace layout follows
doc/format.rst:160-188:

    workspace/
      images/               undistorted images
      sparse/               undistorted PINHOLE model
      stereo/depth_maps/<image>.photometric.bin
      stereo/normal_maps/<image>.photometric.bin
      fused.ply
      meshed-poisson.ply
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from colmap_tpu.mvs import depth_map as dm
from colmap_tpu.mvs import fusion as fusion_mod
from colmap_tpu.mvs import meshing as meshing_mod
from colmap_tpu.mvs import model as model_mod
from colmap_tpu.mvs import patch_match as pm

logger = logging.getLogger("colmap_tpu")


@dataclasses.dataclass
class PatchMatchStereoOptions:
    patch_match: pm.PatchMatchOptions = dataclasses.field(
        default_factory=pm.PatchMatchOptions)
    max_num_src_images: int = 8
    geom_consistency: bool = True  # second pass like the reference default
    max_image_size: int = -1
    # multi-device: round-robin per-reference-image PatchMatch problems
    # over local devices — the exact mechanism of the reference's
    # multi-GPU PatchMatchController (mvs/patch_match.cc:193-228, one
    # worker per GPU from the comma GPU list). 0 = all local devices;
    # 1 = single-device (default). Dispatch is asynchronous: each device
    # works on its problem while the host prepares the next.
    num_devices: int = 1


def _load_workspace(workspace_path: str, max_image_size: int = -1):
    """Load the undistorted model + images; optionally downscale to
    max_image_size (reference: Workspace options max_image_size,
    mvs/workspace.h — stereo runs at the reduced resolution, with the
    calibration scaled to match)."""
    from colmap_tpu.scene import reconstruction_io
    from colmap_tpu.sensor import bitmap as bitmap_mod

    rec = reconstruction_io.read_model(os.path.join(workspace_path, "sparse"))
    model = model_mod.build_model(rec)
    images = {}
    for iid, im in model.images.items():
        path = os.path.join(workspace_path, "images", im.name)
        data = bitmap_mod.read_bitmap(path).data
        if max_image_size > 0 and max(data.shape[:2]) > max_image_size:
            s = max_image_size / max(data.shape[:2])
            nh = max(int(round(data.shape[0] * s)), 1)
            nw = max(int(round(data.shape[1] * s)), 1)
            data = bitmap_mod.resize(data, nh, nw)
            # continuous pixel coords scale exactly: K' = diag(sx, sy, 1) K
            sy, sx = nh / im.height, nw / im.width
            im.K = np.diag([sx, sy, 1.0]) @ im.K
            im.width, im.height = nw, nh
        images[iid] = data
    return rec, model, images


def _suffix_path(workspace_path: str, kind: str, name: str, suffix: str) -> str:
    return os.path.join(workspace_path, "stereo", kind, f"{name}.{suffix}.bin")


def run_patch_match_stereo(workspace_path: str,
                           options: PatchMatchStereoOptions = PatchMatchStereoOptions(),
                           seed: int = 0) -> Dict[int, np.ndarray]:
    """Compute photometric (+ geometric) depth/normal maps for all images."""
    rec, model, images = _load_workspace(workspace_path,
                                         options.max_image_size)
    key = jax.random.PRNGKey(seed)

    from colmap_tpu.sfm.incremental_mapper import resolve_num_devices

    n_dev = resolve_num_devices(options.num_devices)
    devices = jax.local_devices()[:n_dev]
    solve = jax.jit(pm.patch_match, static_argnames=("options",))

    def solve_all(geom: bool, prior: Dict[int, np.ndarray]):
        depths, normals = {}, {}
        pending = []  # (ref_id, name, device results) — round-robin queue
        for idx, (ref_id, im) in enumerate(sorted(model.images.items())):
            srcs = model.src_images(ref_id, options.max_num_src_images)
            if not srcs:
                logger.warning("image %d has no source images", ref_id)
                continue
            dmin, dmax = model.depth_ranges[ref_id]
            R_ref, t_ref = im.R, im.t
            R_rel = np.stack([model.images[s].R @ R_ref.T for s in srcs])
            t_rel = np.stack([model.images[s].t - R_rel[i] @ t_ref
                              for i, s in enumerate(srcs)])
            src_depths = None
            if geom:
                src_depths = np.stack(
                    [prior.get(s, np.zeros_like(images[s])) for s in srcs]
                ).astype(np.float32)
            # round-robin over devices (reference: one worker thread per
            # GPU, problems assigned by thread index): committing the
            # problem arrays to devices[idx % n] runs this problem's
            # program there; the async dispatch overlaps all devices
            dev = devices[idx % len(devices)]
            put = lambda x: jax.device_put(jnp.asarray(x, jnp.float32), dev)
            problem = pm.PatchMatchProblem(
                ref_image=put(images[ref_id]),
                src_images=put(np.stack([images[s] for s in srcs])),
                K_ref=put(im.K),
                K_src=put(np.stack([model.images[s].K for s in srcs])),
                R_rel=put(R_rel),
                t_rel=put(t_rel),
                depth_min=put(dmin),
                depth_max=put(dmax),
                src_depths=None if src_depths is None else put(src_depths),
            )
            po = dataclasses.replace(options.patch_match,
                                     geom_consistency=geom)
            nonlocal key
            key, sub = jax.random.split(key)
            depth, normal, cost = solve(jax.device_put(sub, dev), problem,
                                        options=po)
            pending.append((ref_id, im.name, depth, normal))
            # drain once every device has work in flight (bounds host
            # memory while keeping all devices busy)
            while len(pending) >= len(devices):
                _drain(pending.pop(0), depths, normals, geom)
        while pending:
            _drain(pending.pop(0), depths, normals, geom)
        return depths, normals

    def _drain(item, depths, normals, geom):
        ref_id, name, depth, normal = item
        depth = np.asarray(depth)
        depths[ref_id] = depth
        normals[ref_id] = np.asarray(normal)
        logger.info("patch-match %s (%s): %.0f%% estimated",
                    name, "geom" if geom else "photo",
                    100.0 * float((depth > 0).mean()))

    depths, normals = solve_all(False, {})
    if options.geom_consistency:
        depths, normals = solve_all(True, depths)

    for ref_id, im in model.images.items():
        if ref_id not in depths:
            continue
        suffix = "geometric" if options.geom_consistency else "photometric"
        dm.DepthMap(depths[ref_id]).write(
            _suffix_path(workspace_path, "depth_maps", im.name, suffix))
        dm.NormalMap(normals[ref_id]).write(
            _suffix_path(workspace_path, "normal_maps", im.name, suffix))
    return depths


def run_stereo_fusion(workspace_path: str,
                      options: fusion_mod.StereoFusionOptions = fusion_mod.StereoFusionOptions(),
                      input_type: str = "geometric",
                      output_path: Optional[str] = None,
                      max_image_size: int = -1) -> Dict[str, np.ndarray]:
    """Fuse depth/normal maps into fused.ply (reference: RunStereoFuser).

    max_image_size must match the stereo run so the scaled calibration
    lines up with the stored depth-map resolution."""
    rec, model, images = _load_workspace(workspace_path, max_image_size)
    depths, normals = {}, {}
    for iid, im in model.images.items():
        p = _suffix_path(workspace_path, "depth_maps", im.name, input_type)
        if not os.path.exists(p):
            p = _suffix_path(workspace_path, "depth_maps", im.name, "photometric")
        if not os.path.exists(p):
            continue
        depths[iid] = dm.DepthMap.read(p).data
        np_ = p.replace("depth_maps", "normal_maps")
        normals[iid] = dm.NormalMap.read(np_).data
    graphs: Dict[int, object] = {}
    cloud = fusion_mod.fuse(model, depths, normals, images, options,
                            consistency_out=graphs)
    cg_dir = os.path.join(workspace_path, "stereo", "consistency_graphs")
    os.makedirs(cg_dir, exist_ok=True)
    for iid, g in graphs.items():
        name = model.images[iid].name
        os.makedirs(os.path.dirname(os.path.join(cg_dir, name)) or cg_dir,
                    exist_ok=True)
        g.write(os.path.join(cg_dir, f"{name}.{input_type}.bin"))
    out = output_path or os.path.join(workspace_path, "fused.ply")
    fusion_mod.write_ply(out, cloud["xyz"], cloud["normal"], cloud["color"])
    logger.info("fused %d points -> %s", len(cloud["xyz"]), out)
    return cloud


def run_poisson_mesher(input_ply: str, output_ply: str,
                       options: meshing_mod.PoissonMeshingOptions = meshing_mod.PoissonMeshingOptions()):
    """reference: RunPoissonMesher (exe/mvs.cc:120)."""
    cloud = fusion_mod.read_ply(input_ply)
    verts, faces = meshing_mod.poisson_mesh(
        cloud["xyz"], cloud.get("normal", np.zeros_like(cloud["xyz"])), options)
    meshing_mod.write_mesh_ply(output_ply, verts, faces)
    logger.info("meshed %d vertices / %d faces -> %s",
                len(verts), len(faces), output_ply)
    return verts, faces


def run_delaunay_mesher(workspace_path: str, output_ply: str,
                        input_ply: Optional[str] = None):
    """reference: RunDelaunayMesher (exe/mvs.cc:41) — dense variant."""
    from colmap_tpu.scene import reconstruction_io

    cloud = fusion_mod.read_ply(
        input_ply or os.path.join(workspace_path, "fused.ply"))
    rec = reconstruction_io.read_model(os.path.join(workspace_path, "sparse"))
    model = model_mod.build_model(rec)
    centers = np.stack([im.center() for im in model.images.values()])
    # subsample for the tetrahedralization
    xyz = cloud["xyz"]
    if len(xyz) > 20000:
        sel = np.random.default_rng(0).choice(len(xyz), 20000, replace=False)
        xyz = xyz[sel]
    verts, faces = meshing_mod.delaunay_mesh(xyz, centers)
    meshing_mod.write_mesh_ply(output_ply, verts, faces)
    return verts, faces
