"""Keyframe SLAM tests on synthetic cloud sequences with a loop."""

import dataclasses

import numpy as np

from cvo_rgbd_tpu import CvoParams, pad_cloud, se3
from cvo_rgbd_tpu.keyframes import KeyframePolicy
from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig


def make_world(rng, n=400):
    """A fixed world cloud; frames observe it from moving camera poses."""
    pos = (rng.standard_normal((n, 3)) * np.array([1.0, 0.8, 0.6])
           + np.array([0, 0, 2.5])).astype(np.float32)
    feat = (rng.random((n, 5)) * np.array([255, 255, 255, 60, 60])).astype(np.float32)
    return pos, feat


def observe(world, feat, cam_pose, cap=512):
    """Cloud as seen from cam_pose (world -> camera transform)."""
    inv = np.linalg.inv(cam_pose)
    local = world @ inv[:3, :3].T + inv[:3, 3]
    return pad_cloud(local.astype(np.float32), feat, capacity=cap)


def square_loop_poses(n_side=3, step=0.05):
    """Camera walks a small square and returns to the start."""
    poses = [np.eye(4)]
    dirs = [np.array([step, 0, 0]), np.array([0, step, 0]),
            np.array([-step, 0, 0]), np.array([0, -step, 0])]
    for d in dirs:
        for _ in range(n_side):
            T = poses[-1].copy()
            T[:3, 3] = T[:3, 3] + d
            poses.append(T)
    return poses


def test_slam_closes_loop(rng):
    world, feat = make_world(rng)
    poses_gt = square_loop_poses()
    params = CvoParams(max_iter=150)
    cfg = SlamConfig(
        keyframe=KeyframePolicy(threshold=0.995, max_span=2),
        loop_min_separation=3,
        loop_score_threshold=0.5,
        optimize_iters=15,
    )
    slam = KeyframeSlam(params, cfg)
    for i, T in enumerate(poses_gt):
        slam.process(i, observe(world, feat, T))

    # the loop should have produced at least one closure edge
    assert len(slam.loop_edges) >= 1

    # clean odometry: optimization must not degrade it materially
    odo_end_err = np.linalg.norm(
        slam.frame_poses[-1][:3, 3] - poses_gt[-1][:3, 3]
    )
    corrected, kf_nodes = slam.solve()
    slam_end_err = np.linalg.norm(corrected[-1][:3, 3] - poses_gt[-1][:3, 3])
    assert slam_end_err <= max(2.0 * odo_end_err, 1e-3)

    # now inject synthetic drift into the keyframe chain (the loop
    # edges stay measured/correct) and verify solve() pulls it back
    drift = np.eye(4)
    drift[:3, 3] = [0.004, 0.002, 0]
    cum = np.eye(4)
    for kf in slam.keyframes[1:]:
        cum = cum @ drift
        kf.pose = kf.pose @ cum
    for i in range(len(slam.frame_poses)):
        kf_id = slam.frame_keyframe[i]
        # crude: re-anchor frames to their drifted keyframes
        slam.frame_poses[i] = slam.keyframes[kf_id].pose

    drift_end_err = np.linalg.norm(
        slam.keyframes[-1].pose[:3, 3] - poses_gt[slam.keyframes[-1].index][:3, 3]
    )
    assert drift_end_err > 0.02  # visible drift

    corrected, kf_nodes = slam.solve()
    fixed_end_err = np.linalg.norm(
        np.asarray(kf_nodes)[-1][:3, 3]
        - poses_gt[slam.keyframes[-1].index][:3, 3]
    )
    assert fixed_end_err < 0.5 * drift_end_err, (drift_end_err, fixed_end_err)


def test_slam_single_frame(rng):
    world, feat = make_world(rng, n=100)
    slam = KeyframeSlam(CvoParams(max_iter=50))
    pose = slam.process(0, observe(world, feat, np.eye(4), cap=128))
    np.testing.assert_allclose(pose, np.eye(4))
    frames, kfs = slam.solve()
    assert len(frames) == 1


def test_slam_refine_map(rng):
    """BA refinement after pose-graph solve: runs, reduces cost, and
    keeps poses near the graph solution on clean data."""
    world, feat = make_world(rng, n=250)
    poses_gt = square_loop_poses(n_side=2)
    params = CvoParams(max_iter=120)
    cfg = SlamConfig(
        keyframe=KeyframePolicy(threshold=0.995, max_span=2),
        loop_min_separation=3,
    )
    slam = KeyframeSlam(params, cfg)
    for i, T in enumerate(poses_gt):
        slam.process(i, observe(world, feat, T))

    out = slam.refine_map(grid=0.4, radius=0.3, iters=6)
    assert out is not None
    poses, landmarks, costs = out
    poses = np.asarray(poses)
    assert poses.shape == (len(slam.keyframes), 4, 4)
    assert np.isfinite(poses).all() and np.isfinite(np.asarray(landmarks)).all()
    assert float(costs[-1]) <= float(costs[0])
    # clean input: refined keyframe positions stay close to ground truth
    for kf, P in zip(slam.keyframes, poses):
        assert np.linalg.norm(P[:3, 3] - poses_gt[kf.index][:3, 3]) < 0.05


def test_slam_process_batch_matches_sequential(rng):
    """process_batch with group size G produces the same per-frame
    poses as per-frame process wherever the active keyframe matches —
    and never worse end-to-end accuracy than a 2x bound.  Promotions
    may land up to G-1 frames later (decision cadence), so keyframe
    indices can differ; pose exactness per frame is the contract."""
    world, feat = make_world(rng)
    poses_gt = square_loop_poses()
    params = CvoParams(max_iter=150)
    cfg = SlamConfig(
        keyframe=KeyframePolicy(threshold=0.995, max_span=2),
        loop_min_separation=3,
        loop_score_threshold=0.5,
    )
    clouds = [observe(world, feat, T) for T in poses_gt]

    seq = KeyframeSlam(params, dataclasses.replace(cfg))
    for i, c in enumerate(clouds):
        seq.process(i, c)

    bat = KeyframeSlam(params, dataclasses.replace(cfg))
    got = []
    G = 4
    for s in range(0, len(clouds), G):
        got.extend(bat.process_batch(
            [(i, clouds[i]) for i in range(s, min(s + G, len(clouds)))]
        ))
    assert len(got) == len(clouds)
    assert len(bat.frame_poses) == len(seq.frame_poses)

    # per-frame accuracy vs ground truth must stay comparable
    err_seq = max(
        np.linalg.norm(p[:3, 3] - g[:3, 3])
        for p, g in zip(seq.frame_poses, poses_gt)
    )
    err_bat = max(
        np.linalg.norm(p[:3, 3] - g[:3, 3])
        for p, g in zip(bat.frame_poses, poses_gt)
    )
    assert err_bat <= max(2.0 * err_seq, 5e-3), (err_seq, err_bat)
    # the batched-decision run still promotes keyframes and can solve
    assert len(bat.keyframes) >= 2
    bat.solve()


def test_slam_acvo_batched(rng):
    """Adaptive-CVO SLAM (AcvoParams) through the batched-decision
    driver — the configuration bench_sequence_full's slam_acvo leg
    runs at 573 frames.  acvo's per-pair ell reset
    (adaptive_cvo.cpp:475) changes warm-start dynamics; the driver
    must still track poses and close the loop."""
    from cvo_rgbd_tpu import AcvoParams

    world, feat = make_world(rng)
    feat = (feat / 255.0).astype(np.float32)  # feature_type-0 scale
    poses_gt = square_loop_poses()
    params = AcvoParams(max_iter=150)
    cfg = SlamConfig(
        keyframe=KeyframePolicy(threshold=0.995, max_span=2),
        loop_min_separation=3,
        loop_score_threshold=0.5,
        optimize_iters=15,
    )
    slam = KeyframeSlam(params, cfg)
    buf = []
    out = []
    for i, T in enumerate(poses_gt):
        buf.append((i, observe(world, feat, T)))
        if len(buf) >= 4:
            out.extend(slam.process_batch(buf))
            buf = []
    if buf:
        out.extend(slam.process_batch(buf))

    assert len(out) == len(poses_gt)
    errs = [np.linalg.norm(out[i][:3, 3] - poses_gt[i][:3, 3])
            for i in range(len(poses_gt))]
    assert max(errs) < 0.05, max(errs)
    solved, _ = slam.solve()
    assert np.isfinite(np.stack(solved)).all()
