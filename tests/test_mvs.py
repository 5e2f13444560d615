"""MVS tests: PatchMatch depth accuracy, fusion, meshing, map IO.

Mirrors the reference's mvs tests (src/colmap/mvs/*_test.cc) plus a dense
end-to-end gate on the rendered room dataset with ground-truth depth.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from colmap_tpu.geometry import rotation as rot
from colmap_tpu.mvs import depth_map as dm
from colmap_tpu.mvs import fusion as fusion_mod
from colmap_tpu.mvs import meshing as meshing_mod
from colmap_tpu.mvs import model as model_mod
from colmap_tpu.mvs import patch_match as pm
from colmap_tpu.scene import synthetic_images as synth
from colmap_tpu.scene.reconstruction import Camera, Image, Reconstruction


@pytest.fixture(scope="module")
def room():
    opts = synth.RoomDatasetOptions(num_images=4, width=160, height=120,
                                    focal=140.0, seed=2)
    images, K, Rs, ts, depths = synth.render_room_dataset(opts, return_depth=True)
    return dict(images=images, K=K, Rs=Rs, ts=ts, depths=depths, opts=opts)


def _gt_reconstruction(room, n_points=400):
    """GT poses + a sparse sampling of surface points (for depth ranges)."""
    o = room["opts"]
    K = room["K"]
    rec = Reconstruction()
    rec.add_camera(Camera(camera_id=1, model_id=1, width=o.width,
                          height=o.height,
                          params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])))
    n = len(room["images"])
    for i in range(n):
        q = np.asarray(rot.rotmat_to_quat(jnp.asarray(room["Rs"][i], np.float32)))
        img = Image(image_id=i + 1, name=f"image{i:04d}.png", camera_id=1)
        img.cam_from_world = np.concatenate([q, room["ts"][i]]).astype(np.float64)
        img.xys = np.zeros((n_points, 2))
        img.point3D_ids = np.full(n_points, -1, np.int64)
        rec.add_image(img)
    # sparse surface points: backproject random GT-depth pixels of image 0
    rng = np.random.default_rng(0)
    gt0 = room["depths"][0]
    ys, xs = np.nonzero(gt0 > 0)
    sel = rng.choice(len(ys), n_points, replace=False)
    Kinv = np.linalg.inv(K)
    for j, s in enumerate(sel):
        y, x = ys[s], xs[s]
        ray = Kinv @ np.array([x + 0.5, y + 0.5, 1.0])
        Xc = ray * gt0[y, x]
        Xw = room["Rs"][0].T @ (Xc - room["ts"][0])
        track = []
        for i in range(n):
            Xi = room["Rs"][i] @ Xw + room["ts"][i]
            if Xi[2] <= 0:
                continue
            p = K @ Xi
            px, py = p[0] / p[2], p[1] / p[2]
            if 0 <= px < gt0.shape[1] and 0 <= py < gt0.shape[0]:
                rec.images[i + 1].xys[j] = (px, py)
                track.append((i + 1, j))
        if len(track) >= 2:
            rec.add_point3D(Xw, track)
    return rec


@pytest.fixture(scope="module")
def workspace(room, tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("mvs_ws"))
    synth.write_dataset(os.path.join(ws, "images"), room["images"])
    rec = _gt_reconstruction(room)
    from colmap_tpu.scene import reconstruction_io

    os.makedirs(os.path.join(ws, "sparse"), exist_ok=True)
    for sub in ("depth_maps", "normal_maps"):
        os.makedirs(os.path.join(ws, "stereo", sub), exist_ok=True)
    reconstruction_io.write_model(rec, os.path.join(ws, "sparse"), ext=".bin")
    return ws


def test_mat_io_roundtrip(tmp_path):
    data = np.random.default_rng(0).uniform(0, 5, (7, 9)).astype(np.float32)
    p = str(tmp_path / "d.bin")
    dm.DepthMap(data).write(p)
    back = dm.DepthMap.read(p)
    np.testing.assert_allclose(back.data, data)
    nrm = np.random.default_rng(1).normal(size=(7, 9, 3)).astype(np.float32)
    p2 = str(tmp_path / "n.bin")
    dm.NormalMap(nrm).write(p2)
    np.testing.assert_allclose(dm.NormalMap.read(p2).data, nrm)


def test_patch_match_depth_accuracy(room):
    images, K, Rs, ts, depths = (room["images"], room["K"], room["Rs"],
                                 room["ts"], room["depths"])
    ref, srcs = 1, [0, 2, 3]
    R_rel = np.stack([Rs[s] @ Rs[ref].T for s in srcs])
    t_rel = np.stack([ts[s] - R_rel[i] @ ts[ref] for i, s in enumerate(srcs)])
    gt = depths[ref]
    problem = pm.PatchMatchProblem(
        ref_image=jnp.asarray(images[ref], jnp.float32) / 255.0,
        src_images=jnp.asarray(np.stack([images[s] for s in srcs]),
                               jnp.float32) / 255.0,
        K_ref=jnp.asarray(K, jnp.float32),
        K_src=jnp.asarray(np.stack([K] * 3), jnp.float32),
        R_rel=jnp.asarray(R_rel, jnp.float32),
        t_rel=jnp.asarray(t_rel, jnp.float32),
        depth_min=jnp.asarray(gt[gt > 0].min() * 0.7, jnp.float32),
        depth_max=jnp.asarray(gt[gt > 0].max() * 1.3, jnp.float32))
    depth, normal, cost = jax.tree.map(
        np.asarray,
        pm.patch_match(jax.random.PRNGKey(0), problem, pm.PatchMatchOptions()))
    ok = (depth > 0) & (gt > 0)
    assert ok.mean() > 0.4
    rel = np.abs(depth - gt)[ok] / gt[ok]
    assert np.median(rel) < 0.05, f"median rel depth err {np.median(rel):.4f}"
    assert (rel < 0.05).mean() > 0.6
    # normals on the estimated pixels should be unit
    nn = np.linalg.norm(normal[ok], axis=-1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-3)


def test_dense_pipeline_end_to_end(room, workspace):
    from colmap_tpu.controllers import dense_reconstruction as dense

    depths = dense.run_patch_match_stereo(
        workspace,
        dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=3),
            max_num_src_images=3, geom_consistency=True))
    assert len(depths) == 4

    cloud = dense.run_stereo_fusion(
        workspace, fusion_mod.StereoFusionOptions(
            min_num_pixels=3, max_depth_error=0.03, max_normal_error_deg=25.0))
    assert len(cloud["xyz"]) > 2000
    assert os.path.exists(os.path.join(workspace, "fused.ply"))

    # fused points must lie near the GT room surfaces: back wall z=+s,
    # right wall x=+s, floor y=+s/2 (room size s=4)
    s = room["opts"].room_size
    xyz = cloud["xyz"]
    d_back = np.abs(xyz[:, 2] - s)
    d_right = np.abs(xyz[:, 0] - s)
    d_floor = np.abs(xyz[:, 1] - s / 2)
    d_surf = np.minimum(np.minimum(d_back, d_right), d_floor)
    frac_near = (d_surf < 0.05 * s).mean()
    assert frac_near > 0.7, f"only {frac_near:.2f} of fused points near GT surfaces"

    verts, faces = dense.run_poisson_mesher(
        os.path.join(workspace, "fused.ply"),
        os.path.join(workspace, "meshed-poisson.ply"),
        meshing_mod.PoissonMeshingOptions(depth=7))
    assert len(verts) > 500
    assert len(faces) > 500
    # mesh vertices near GT surfaces too
    d_back = np.abs(verts[:, 2] - s)
    d_right = np.abs(verts[:, 0] - s)
    d_floor = np.abs(verts[:, 1] - s / 2)
    d_surf = np.minimum(np.minimum(d_back, d_right), d_floor)
    assert np.median(d_surf) < 0.08 * s


def test_dense_downscale(room, workspace):
    """max_image_size: stereo at reduced resolution with scaled calibration
    (reference: Workspace max_image_size). Runs AFTER the full-res e2e test
    (module-ordered) and overwrites the photometric maps at half size."""
    from colmap_tpu.controllers import dense_reconstruction as dense

    o = room["opts"]
    target = max(o.width, o.height) // 2
    depths = dense.run_patch_match_stereo(
        workspace,
        dense.PatchMatchStereoOptions(
            patch_match=pm.PatchMatchOptions(num_iterations=3),
            max_num_src_images=3, geom_consistency=False,
            max_image_size=target))
    assert len(depths) == 4
    for d in depths.values():
        assert max(d.shape) == target
    cloud = dense.run_stereo_fusion(
        workspace, fusion_mod.StereoFusionOptions(
            min_num_pixels=3, max_depth_error=0.05, max_normal_error_deg=30.0),
        input_type="photometric", max_image_size=target)
    assert len(cloud["xyz"]) > 500
    s = o.room_size
    xyz = cloud["xyz"]
    d_surf = np.minimum(np.minimum(np.abs(xyz[:, 2] - s), np.abs(xyz[:, 0] - s)),
                        np.abs(xyz[:, 1] - s / 2))
    frac_near = (d_surf < 0.07 * s).mean()
    assert frac_near > 0.6, f"only {frac_near:.2f} of fused points near GT surfaces"


def test_surface_nets_sphere():
    n = 48
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    r = np.sqrt(((g - n / 2) ** 2).sum(0))
    field = r - n / 4
    verts, faces = meshing_mod.surface_nets(field)
    assert len(verts) > 100
    assert len(faces) >= len(verts)
    rad = np.linalg.norm(verts - n / 2, axis=1)
    np.testing.assert_allclose(rad, n / 4, atol=1.0)


def test_consistency_graph_roundtrip(tmp_path, rng):
    from colmap_tpu.mvs.consistency_graph import ConsistencyGraph

    s, h, w = 3, 12, 16
    masks = rng.uniform(size=(s, h, w)) < 0.2
    src_ids = [4, 7, 9]
    g = ConsistencyGraph.from_masks(masks, src_ids)
    # query parity with the masks
    for r in range(h):
        for c in range(w):
            expect = [src_ids[k] for k in range(s) if masks[k, r, c]]
            got = list(g.image_idxs(r, c))
            assert got == expect, (r, c, got, expect)
    p = str(tmp_path / "cg.bin")
    g.write(p)
    g2 = ConsistencyGraph.read(p)
    assert g2.width == w and g2.height == h
    np.testing.assert_array_equal(g2.data, g.data)
    assert list(g2.image_idxs(3, 5)) == list(g.image_idxs(3, 5))


def test_patch_match_vga_reference_defaults():
    """Depth accuracy at >=640x480 with the reference NCC window
    (window_radius=5 -> 11x11, sigma_spatial=window_radius): L1 bounds at
    reference-default settings (reference
    mvs/patch_match.h:71-98 defaults)."""
    opts = synth.RoomDatasetOptions(num_images=3, width=640, height=480,
                                    focal=560.0, seed=6)
    images, K, Rs, ts, depths = synth.render_room_dataset(opts,
                                                          return_depth=True)
    ref, srcs = 1, [0, 2]
    R_rel = np.stack([Rs[s] @ Rs[ref].T for s in srcs])
    t_rel = np.stack([ts[s] - R_rel[i] @ ts[ref] for i, s in enumerate(srcs)])
    gt = depths[ref]
    problem = pm.PatchMatchProblem(
        ref_image=jnp.asarray(images[ref], jnp.float32) / 255.0,
        src_images=jnp.asarray(np.stack([images[s] for s in srcs]),
                               jnp.float32) / 255.0,
        K_ref=jnp.asarray(K, jnp.float32),
        K_src=jnp.asarray(np.stack([K] * len(srcs)), jnp.float32),
        R_rel=jnp.asarray(R_rel, jnp.float32),
        t_rel=jnp.asarray(t_rel, jnp.float32),
        depth_min=jnp.asarray(gt[gt > 0].min() * 0.7, jnp.float32),
        depth_max=jnp.asarray(gt[gt > 0].max() * 1.3, jnp.float32))
    o = pm.PatchMatchOptions()  # reference defaults: radius 5, 5 iters
    assert o.window_radius == 5 and o.sigma_spatial < 0
    depth, normal, cost = jax.tree.map(
        np.asarray, pm.patch_match(jax.random.PRNGKey(0), problem, o))
    ok = (depth > 0) & (gt > 0)
    assert ok.mean() > 0.4, ok.mean()
    rel = np.abs(depth - gt)[ok] / gt[ok]
    l1 = np.abs(depth - gt)[ok]
    assert np.median(rel) < 0.03, f"median rel depth err {np.median(rel):.4f}"
    assert np.median(l1) < 0.05 * np.median(gt[gt > 0]), np.median(l1)
    assert (rel < 0.05).mean() > 0.6, (rel < 0.05).mean()
