import numpy as np
import jax
import jax.numpy as jnp

from colmap_tpu.estimators import bundle_adjustment as ba
from colmap_tpu.geometry import rigid3, rotation as rot
from colmap_tpu.sensor import models as cm


def build_synthetic_ba(rng, num_poses=8, num_points=200, noise_px=0.0,
                       model_id=int(cm.CameraModelId.SIMPLE_RADIAL)):
    """Circle-of-cameras synthetic BA problem with full visibility."""
    params = cm.pad_params([1000.0, 512.0, 384.0, 0.01])
    points = rng.uniform(-1, 1, (num_points, 3)).astype(np.float32)

    poses = []
    for i in range(num_poses):
        ang = 2 * np.pi * i / num_poses
        center = np.array([4 * np.cos(ang), 0.5 * np.sin(2 * ang), 4 * np.sin(ang)])
        z = -center / np.linalg.norm(center)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z); x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1).T
        t = -R @ center
        q = np.asarray(rot.rotmat_to_quat(jnp.asarray(R, jnp.float32)))
        poses.append(np.concatenate([q, t]).astype(np.float32))
    poses = np.stack(poses)

    obs_pose, obs_cam, obs_pt, obs_xy = [], [], [], []
    for p in range(num_poses):
        pc = np.asarray(rigid3.apply(jnp.asarray(poses[p]), jnp.asarray(points)))
        uv = pc[:, :2] / pc[:, 2:]
        xy = np.asarray(cm.img_from_cam(model_id, jnp.asarray(params), jnp.asarray(uv)))
        for m in range(num_points):
            if pc[m, 2] > 0.2:
                obs_pose.append(p)
                obs_cam.append(0)
                obs_pt.append(m)
                obs_xy.append(xy[m])
    obs_xy = np.stack(obs_xy).astype(np.float32)
    if noise_px > 0:
        obs_xy = obs_xy + rng.normal(0, noise_px, obs_xy.shape).astype(np.float32)
    return poses, params[None].astype(np.float32), points, (
        np.array(obs_pose, np.int32),
        np.array(obs_cam, np.int32),
        np.array(obs_pt, np.int32),
        obs_xy,
    ), model_id


def rms_reproj(problem, options):
    cost = float(ba.compute_cost(problem, options))
    n = float(jnp.sum(problem.obs_weight))
    return np.sqrt(2 * cost / n)


def test_ba_converges_from_perturbation(rng):
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    # perturb everything except gauge-fixing dofs
    noisy_poses = np.array(
        rigid3.exp_update(
            jnp.asarray(poses),
            jnp.asarray(rng.normal(0, 0.01, (len(poses), 6)).astype(np.float32)),
        )
    )
    noisy_points = points + rng.normal(0, 0.02, points.shape).astype(np.float32)
    noisy_poses[0] = poses[0]  # keep gauge anchors at GT
    noisy_poses[1] = poses[1]

    problem = ba.make_problem(
        noisy_poses, cams, noisy_points, *obs, fix_first_pose_and_gauge=True
    )
    options = ba.BAOptions(max_iterations=30, cg_iterations=30, camera_model_id=model_id)
    rms0 = rms_reproj(problem, options)
    state = ba.solve(problem, options)
    rms1 = rms_reproj(state.problem, options)
    assert rms0 > 1.0
    assert rms1 < 0.05, f"rms {rms0} -> {rms1}"

    # poses recovered (gauge fully fixed by two anchors at GT)
    got = np.asarray(state.problem.poses)
    for i in range(len(poses)):
        dq = np.degrees(
            2 * np.arccos(min(1.0, abs(float(np.dot(got[i, :4], poses[i, :4])))))
        )
        assert dq < 0.05, f"pose {i} rot err {dq}"
        assert np.linalg.norm(got[i, 4:] - poses[i, 4:]) < 5e-3


def test_ba_noise_robust_loss(rng):
    poses, cams, points, obs, model_id = build_synthetic_ba(rng, noise_px=0.5)
    noisy_poses = np.array(
        rigid3.exp_update(
            jnp.asarray(poses),
            jnp.asarray(rng.normal(0, 0.005, (len(poses), 6)).astype(np.float32)),
        )
    )
    noisy_poses[0] = poses[0]
    noisy_poses[1] = poses[1]
    noisy_points = points + rng.normal(0, 0.01, points.shape).astype(np.float32)
    problem = ba.make_problem(
        noisy_poses, cams, noisy_points, *obs, fix_first_pose_and_gauge=True
    )
    options = ba.BAOptions(
        max_iterations=25, cg_iterations=25, loss="cauchy", loss_scale=2.0,
        camera_model_id=model_id,
    )
    state = ba.solve(problem, options)
    rms1 = rms_reproj(state.problem, options)
    assert rms1 < 0.8  # converges to the noise floor


def test_ba_refines_intrinsics(rng):
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    bad_cams = cams.copy()
    bad_cams[0, 0] *= 1.02  # 2% focal error
    problem = ba.make_problem(
        poses, bad_cams, points, *obs,
        fix_first_pose_and_gauge=True, refine_intrinsics=True,
    )
    options = ba.BAOptions(max_iterations=30, cg_iterations=40, camera_model_id=model_id)
    state = ba.solve(problem, options)
    focal = float(state.problem.cam_params[0, 0])
    assert abs(focal - 1000.0) < 5.0, focal


def test_ba_fixed_points_stay(rng):
    poses, cams, points, obs, model_id = build_synthetic_ba(rng, num_poses=5, num_points=50)
    problem = ba.make_problem(poses, cams, points, *obs, fix_first_pose_and_gauge=True)
    problem = problem._replace(point_mask=jnp.zeros_like(problem.point_mask))
    options = ba.BAOptions(max_iterations=3, cg_iterations=10, camera_model_id=model_id)
    state = ba.solve(problem, options)
    np.testing.assert_allclose(np.asarray(state.problem.points), points, atol=1e-6)


def build_multi_camera_ba(rng, num_poses=6, num_cams=3, num_points=120):
    """Variant of build_synthetic_ba with several cameras (pose p -> cam p%C)."""
    poses, cams, points, (op, oc, opt_, oxy), model_id = build_synthetic_ba(
        rng, num_poses=num_poses, num_points=num_points)
    cam_params = np.tile(cams, (num_cams, 1))
    # distinct focals so a camera mixup would show in the solution
    for c in range(num_cams):
        cam_params[c, 0] = 1000.0 + 20.0 * c
    pose_cam = np.arange(num_poses, dtype=np.int32) % num_cams
    oc = pose_cam[op]
    # re-project under each pose's actual camera
    pc = np.asarray(rigid3.apply(jnp.asarray(poses[op]), jnp.asarray(points[opt_])))
    uv = pc[:, :2] / pc[:, 2:]
    oxy = np.asarray(cm.img_from_cam(
        model_id, jnp.asarray(cam_params[oc]), jnp.asarray(uv))).astype(np.float32)
    return poses, cam_params, points, (op, oc, opt_, oxy), model_id


def test_ba_multi_camera_gather_matches_segsum(rng):
    """The pose->camera reduction (gather layouts) must agree with the
    segment-sum fallback on a multi-camera problem with intrinsics on."""
    poses, cam_params, points, obs, model_id = build_multi_camera_ba(rng)
    noisy = np.array(
        rigid3.exp_update(
            jnp.asarray(poses),
            jnp.asarray(rng.normal(0, 0.003, (len(poses), 6)).astype(np.float32)),
        )
    )
    noisy[0], noisy[1] = poses[0], poses[1]
    problem = ba.make_problem(
        noisy, cam_params, points, *obs, fix_first_pose_and_gauge=True,
        refine_intrinsics=True, camera_model_ids=[model_id] * len(cam_params),
    )
    assert problem.pt_gather is not None
    assert problem.pose_cam_idx is not None
    options = ba.BAOptions(max_iterations=8, cg_iterations=15,
                           camera_model_id=model_id, function_tolerance=0.0)
    fast = ba.solve(problem, options)
    slow = ba.solve(
        problem._replace(pt_gather=None, pose_gather=None, pose_cam_idx=None,
                         pt_gather_ps=None, ps_point_idx=None),
        options,
    )
    np.testing.assert_allclose(float(fast.cost), float(slow.cost),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(fast.problem.poses),
                               np.asarray(slow.problem.poses), atol=2e-4)


def test_ba_layout_memory_bounded_at_scale():
    """P=1024 / C=64 / N=1M: no layout array may scale like N*C (the old
    dense one-hot was N*C = 256 MB here; the pose_cam_idx replacement is 4 KB)."""
    rng = np.random.default_rng(0)
    P, C, M, N = 1024, 64, 100_000, 1_000_000
    obs_pose = rng.integers(0, P, N).astype(np.int32)
    obs_cam = (obs_pose % C).astype(np.int32)
    # near-uniform point degrees (10 obs/point) keep the pad ratio sane
    obs_pt = np.repeat(np.arange(M, dtype=np.int32), 10)
    obs_weight = np.ones(N, np.float32)
    pt_g, pose_g, pose_cam, pt_g_ps, ps_point = ba.build_gather_layouts(
        obs_pt, obs_pose, obs_cam, obs_weight, M, P, C)
    assert pt_g is not None
    assert pose_cam.shape == (P,)
    total_bytes = sum(a.nbytes for a in (pt_g, pose_g, pose_cam, pt_g_ps, ps_point))
    # all layouts together stay within a small multiple of the obs axis
    assert total_bytes < 16 * N * 4, total_bytes
    # consistency: every pose's camera assignment matches the obs tableau
    np.testing.assert_array_equal(pose_cam, np.arange(P) % C)


def test_ba_early_exit_function_tolerance(rng):
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    problem = ba.make_problem(poses, cams, points, *obs,
                              fix_first_pose_and_gauge=True)
    options = ba.BAOptions(max_iterations=40, cg_iterations=15,
                           camera_model_id=model_id, function_tolerance=1e-6)
    state = ba.solve(problem, options)
    # the problem starts at the optimum: the solver must bail out early
    assert int(state.iteration) <= 4, int(state.iteration)

    full = ba.BAOptions(max_iterations=40, cg_iterations=15,
                        camera_model_id=model_id, function_tolerance=0.0)
    state_full = ba.solve(problem, full)
    assert int(state_full.iteration) == 40
    np.testing.assert_allclose(float(state.cost), float(state_full.cost),
                               rtol=1e-3, atol=1e-6)


def test_ba_truncated_cg_matches_fixed_trip(rng):
    """cg_tolerance (eta-style truncated CG, the mapper default) must reach
    the same optimum as fixed-trip CG — mirrors
    test_ba_early_exit_function_tolerance for the inner while_loop path."""
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    problem = ba.make_problem(poses, cams, points, *obs,
                              fix_first_pose_and_gauge=True)
    trunc = ba.BAOptions(max_iterations=20, cg_iterations=25,
                         camera_model_id=model_id, cg_tolerance=0.1)
    fixed = ba.BAOptions(max_iterations=20, cg_iterations=25,
                         camera_model_id=model_id, cg_tolerance=0.0)
    s_trunc = ba.solve(problem, trunc)
    s_fixed = ba.solve(problem, fixed)
    np.testing.assert_allclose(float(s_trunc.cost), float(s_fixed.cost),
                               rtol=1e-3, atol=1e-9)
    # truncation must not make the solution worse than a small margin
    assert float(s_trunc.cost) <= float(s_fixed.cost) * (1 + 1e-3)


def test_device_layouts_match_host(rng):
    """build_gather_layouts_traced must reproduce the host tables exactly
    (the mapper ships only the index arrays to the device and
    rebuilds the layouts on device, flatten_problem(device_layouts=True))."""
    N, M, P, C = 5000, 300, 40, 2
    r = np.random.default_rng(0)
    pt = r.integers(0, M, N)
    po = r.integers(0, P, N)
    cam = (po % C).astype(np.int32)
    w = (r.random(N) > 0.1).astype(np.float32)
    host = ba.build_gather_layouts(pt, po, cam, w, M, P, C)
    T, S = host[0].shape[1], host[1].shape[1]
    assert (T, S) == ba.layout_widths(pt, po, w, M, P)
    dev = jax.jit(lambda a, b, c, d: ba.build_gather_layouts_traced(
        a, b, c, d, M, P, T, S))(pt.astype(np.int32), po.astype(np.int32),
                                 cam, w)
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h, np.asarray(d))


def test_solve_packed_device_layouts(rng):
    """End-to-end: a perturbed BA solved through the device-layout packed
    path converges identically to the host-layout path."""
    poses, cams, points, obs, model_id = build_synthetic_ba(rng)
    problem = ba.make_problem(poses, cams, points, *obs,
                              fix_first_pose_and_gauge=True)
    problem_nl = ba.make_problem(poses, cams, points, *obs,
                                 fix_first_pose_and_gauge=True,
                                 as_numpy=True, skip_layouts=True)
    options = ba.BAOptions(max_iterations=10, cg_iterations=15,
                           camera_model_id=model_id, function_tolerance=0.0)
    ref = ba.solve(problem, options)

    fbuf, ibuf, meta = ba.flatten_problem(problem_nl, device_layouts=True)
    assert meta.dev and meta.T > 0 and meta.S > 0
    rebuilt = ba.unflatten_problem(jnp.asarray(fbuf), jnp.asarray(ibuf), meta)
    state = ba.solve(rebuilt, options)
    np.testing.assert_allclose(float(state.cost), float(ref.cost),
                               rtol=1e-5, atol=1e-9)
