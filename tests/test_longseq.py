"""Sequence-scale end-to-end validation.

The reference's primary product is a 573-frame trajectory
(cvo_main.cpp:36-66 looping assoc.txt; acceptance via
evaluate_ate.py:152-162).  Real fr1/desk images are not vendored, so
this module drives a 160-frame ray-traced revisit sequence
(cvo_rgbd_tpu.synth.revisit_path: the camera's yaw/pitch/translation
are periodic — pose(i+40) == pose(i) exactly, four revisit sweeps)
through the full stack: odometry (cvo, acvo, batched), keyframe SLAM
with loop closures, pose-graph solve, and BA map refinement, asserting
ATE/RPE against the closed-form ground truth.

Drift over a hundred-plus chained pairs is observed here for the first
time: frame-to-frame odometry accumulates ~2-3 cm ATE over the 160
frames, keyframe SLAM halves it, and loop closure halves it again.

Stopping tolerances: sequence tests run the MATLAB set (eps=5e-4,
eps_2=1e-4, rkhs_se3_registration.m:18-19) with the C++ "se" kernel
parameters — for RUNTIME, not reachability: since round 4 the
difference-form flow epilogues (core/flow.py) make the C++ 5e-5/1e-5
stops converge in fp32 (tests/test_oracle_traj.py runs a chain at
them; bench.py's ref_tolerance block measures 64 reference-scale
pairs), but they roughly double iteration counts, and the measured
pose delta between the two stop sets is ~1 mm (bench
pose_delta_vs_matlab_stop_mm).
Calibration (this fixture): cvo ATE 0.0275, RPE 0.033/0.020; SLAM raw
0.0218 -> solved 0.0109 (16 loop edges); acvo(40) 0.0115; batched(100)
0.0353.
"""

import os

import numpy as np
import pytest

from cvo_rgbd_tpu.evaluation import ate_rmse
from cvo_rgbd_tpu.evaluation.rpe import rpe
from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
from cvo_rgbd_tpu.odometry import (
    load_image_pair,
    run_odometry,
    run_odometry_batched,
)
from cvo_rgbd_tpu.params import AcvoParams, CvoParams
from cvo_rgbd_tpu.synth import make_tum_dataset, revisit_path

N_FRAMES = 160
PERIOD = 40
NUM_WANT = 1024
P = CvoParams(eps=5e-4, eps_2=1e-4)
PA = AcvoParams(eps=5e-4, eps_2=1e-4)


@pytest.fixture(scope="module")
def loop_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tumloop")
    make_tum_dataset(root, revisit_path(N_FRAMES, period=PERIOD))
    return root


@pytest.fixture(scope="module")
def gt(loop_dataset):
    return read_trajectory(os.path.join(loop_dataset, "groundtruth.txt"))


@pytest.fixture(scope="module")
def clouds(loop_dataset):
    """feature_type-1 clouds for every frame, shared across tests."""
    from cvo_rgbd_tpu.frontend import make_frontend

    frontend = make_frontend(1, NUM_WANT, 1)
    entries = load_assoc(os.path.join(loop_dataset, "assoc.txt"))
    out = []
    for e in entries:
        rgb, dep = load_image_pair(loop_dataset, e)
        out.append(frontend(rgb, dep))
    return entries, out


def test_longseq_odometry_cvo(loop_dataset, gt):
    """160 chained pairs, warm-started: drift stays bounded (ATE),
    per-pair quality stays bounded (RPE at 1 s / 1 frame-step)."""
    records = run_odometry(
        str(loop_dataset), 1, params=P, num_want=NUM_WANT,
        log=lambda *a: None,
    )
    assert len(records) == N_FRAMES - 1
    assert all(not r.failed for r in records)
    est = read_trajectory(os.path.join(loop_dataset, "cvo_poses_qt.txt"))
    assert len(est) == N_FRAMES

    stats = ate_rmse(gt, est)
    assert stats["rmse"] < 0.05, stats     # calibrated 0.0275
    r = rpe(gt, est, delta=1.0, delta_unit="s")
    assert r["trans_rmse"] < 0.06, r       # calibrated 0.0333
    assert r["rot_rmse"] < 0.04, r         # calibrated 0.0195


def test_longseq_odometry_batched(loop_dataset, gt):
    """The offline batched driver stays trajectory-accurate over a
    100-frame prefix (cold per-pair starts, 8-pair device batches)."""
    out = os.path.join(loop_dataset, "cvo_batched_qt.txt")
    records = run_odometry_batched(
        str(loop_dataset), 1, params=P, num_want=NUM_WANT, batch=8,
        max_frames=100, output=out, log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    stats = ate_rmse(gt, read_trajectory(out))
    assert stats["rmse"] < 0.06, stats     # calibrated 0.0353


def test_longseq_odometry_acvo(loop_dataset, gt):
    """Adaptive variant over a 40-frame prefix (3 self-kernel Grams per
    iteration make full-length acvo the slowest CPU path here)."""
    out = os.path.join(loop_dataset, "acvo_poses_qt.txt")
    records = run_odometry(
        str(loop_dataset), 1, adaptive=True, params=PA, num_want=NUM_WANT,
        max_frames=40, output=out, log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    stats = ate_rmse(gt, read_trajectory(out))
    assert stats["rmse"] < 0.03, stats     # calibrated 0.0115


def test_longseq_slam_loop_closure(loop_dataset, gt, clouds):
    """Keyframe SLAM over all 160 frames: loop closures FIRE on the
    periodic revisits, and the pose-graph solve measurably beats the
    raw keyframe odometry; BA refinement runs on
    the solved keyframes and reduces its cost."""
    from cvo_rgbd_tpu.keyframes import KeyframePolicy
    from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig

    entries, cl = clouds
    slam = KeyframeSlam(
        P, SlamConfig(keyframe=KeyframePolicy(max_span=8))
    )
    for i, c in enumerate(cl):
        slam.process(i, c)

    assert len(slam.keyframes) >= 10
    assert len(slam.loop_edges) >= 4        # calibrated: 16

    names = [float(e.name) for e in entries]
    raw = {names[i]: slam.frame_poses[i] for i in range(len(cl))}
    raw_stats = ate_rmse(gt, raw)
    solved, kf_nodes = slam.solve()
    sol = {names[i]: solved[i] for i in range(len(cl))}
    sol_stats = ate_rmse(gt, sol)

    # keyframe odometry already beats frame-to-frame chaining; loop
    # closure then roughly halves it (calibrated 0.0218 -> 0.0109)
    assert raw_stats["rmse"] < 0.04, raw_stats
    assert sol_stats["rmse"] < 0.75 * raw_stats["rmse"], (
        raw_stats["rmse"], sol_stats["rmse"],
    )
    assert sol_stats["rmse"] < 0.02, sol_stats

    # the correction concentrates on the keyframes themselves
    kf_ts = [names[k.index] for k in slam.keyframes]
    raw_kf = ate_rmse(gt, {t: slam.keyframes[i].pose
                           for i, t in enumerate(kf_ts)})
    sol_kf = ate_rmse(gt, {t: np.asarray(kf_nodes)[i]
                           for i, t in enumerate(kf_ts)})
    assert sol_kf["rmse"] < 0.75 * raw_kf["rmse"], (
        raw_kf["rmse"], sol_kf["rmse"],
    )

    # BA refinement on the solved keyframes: runs, stays finite,
    # monotone cost decrease
    out = slam.refine_map(iters=4)
    assert out is not None
    kf_ref, landmarks, costs = out
    assert np.isfinite(np.asarray(kf_ref)).all()
    assert np.isfinite(np.asarray(landmarks)).all()
    costs = np.asarray(costs)
    assert costs[-1] <= costs[0]
