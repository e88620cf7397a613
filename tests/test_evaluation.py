"""Evaluation harness tests: associate, Horn/ATE, RPE."""

import numpy as np

from cvo_rgbd_tpu.evaluation import associate, ate_rmse, horn_align, rpe
from cvo_rgbd_tpu import se3


def test_associate_greedy():
    first = {0.0: ["a"], 1.0: ["b"], 2.0: ["c"]}
    second = {0.015: ["x"], 1.001: ["y"], 5.0: ["z"]}
    m = associate(first, second)
    assert m == [(0.0, 0.015), (1.0, 1.001)]


def test_associate_one_to_one():
    # two firsts near one second: only the closer wins
    first = {0.0: ["a"], 0.01: ["b"]}
    second = {0.009: ["x"]}
    m = associate(first, second)
    assert m == [(0.01, 0.009)]


def test_horn_align_exact(rng):
    pts = rng.standard_normal((3, 50))
    w = np.array([0.3, -0.2, 0.5], np.float32)
    R = np.asarray(se3.exp_so3(w)).astype(np.float64)
    t = np.array([[1.0], [-2.0], [0.5]])
    data = R @ pts + t
    rot, trans, err = horn_align(pts, data)
    np.testing.assert_allclose(rot, R, atol=1e-6)
    np.testing.assert_allclose(trans, t, atol=1e-6)
    assert err.max() < 1e-6  # R comes from fp32 exp_so3


def _traj_line(t, T):
    return {t: T}


def _make_traj(n, step_t, step_w, t0=100.0, dt=0.1):
    traj = {}
    T = np.eye(4)
    for i in range(n):
        traj[t0 + i * dt] = T.copy()
        dT = np.eye(4)
        dT[:3, :3] = np.asarray(se3.exp_so3(np.asarray(step_w, np.float32))).astype(np.float64)
        dT[:3, 3] = step_t
        T = T @ dT
    return traj


def test_ate_zero_for_identical():
    traj = _make_traj(20, [0.01, 0, 0.002], [0.001, 0.002, 0])
    stats = ate_rmse(traj, traj)
    assert stats["rmse"] < 1e-12
    assert stats["pairs"] == 20


def test_ate_invariant_to_global_transform():
    """ATE aligns with Horn: a global rigid offset must not change it."""
    traj = _make_traj(20, [0.01, 0, 0.002], [0.001, 0.002, 0])
    G = np.eye(4)
    G[:3, :3] = np.asarray(se3.exp_so3(np.array([0.2, -0.1, 0.4], np.float32))).astype(np.float64)
    G[:3, 3] = [5.0, -3.0, 1.0]
    moved = {t: G @ T for t, T in traj.items()}
    stats = ate_rmse(traj, moved)
    assert stats["rmse"] < 1e-8


def test_ate_detects_drift():
    traj = _make_traj(20, [0.01, 0, 0], [0, 0, 0])
    drifted = {
        t: T @ np.diag([1.0, 1, 1, 1]) for t, T in traj.items()
    }
    for i, (t, T) in enumerate(sorted(drifted.items())):
        T2 = T.copy()
        T2[0, 3] += 0.005 * i  # linear drift
        drifted[t] = T2
    stats = ate_rmse(traj, drifted)
    assert stats["rmse"] > 0.01


def test_rpe_zero_for_identical():
    traj = _make_traj(30, [0.01, 0, 0.002], [0.001, 0.002, 0])
    stats = rpe(traj, traj, delta=1, delta_unit="f")
    assert stats["trans_rmse"] < 1e-12
    assert stats["rot_rmse"] < 1e-9


def test_rpe_constant_error():
    """Estimated motion 1mm short per frame -> RPE trans ~1mm at delta=1f."""
    gt = _make_traj(30, [0.010, 0, 0], [0, 0, 0])
    est = _make_traj(30, [0.009, 0, 0], [0, 0, 0])
    stats = rpe(gt, est, delta=1, delta_unit="f")
    np.testing.assert_allclose(stats["trans_rmse"], 0.001, rtol=1e-6)


# ---------------------------------------------------------------------------
# Real-data baseline minting: the vendored fr1/desk
# artifacts are the only reference baselines mintable in this
# environment; these tests pin the parser to the REAL files and the
# minted numbers to BASELINE.md.
# ---------------------------------------------------------------------------

import os

import pytest

_DS = "/root/reference/data/rgbd_dataset/freiburg1_desk"
needs_fixture = pytest.mark.skipif(
    not os.path.exists(os.path.join(_DS, "cv_rgbd_poses.csv")),
    reason="reference dataset not vendored",
)


@needs_fixture
def test_load_relative_pose_csv_real_file():
    """The parser handles the actual vendored header + 14-column format
    (frame1, frame2, tx..tz, r11..r33 row-major)."""
    from cvo_rgbd_tpu.evaluation.plots import load_relative_pose_csv

    rels = load_relative_pose_csv(os.path.join(_DS, "cv_rgbd_poses.csv"))
    assert rels.shape == (572, 4, 4)
    # rotations are orthonormal (R R' = I) and the affine tail is exact
    for H in rels[:10]:
        np.testing.assert_allclose(H[:3, :3] @ H[:3, :3].T, np.eye(3),
                                   atol=1e-4)
        np.testing.assert_array_equal(H[3], [0, 0, 0, 1])
    # first row spot-check against the raw file (cv_rgbd_poses.csv:2)
    np.testing.assert_allclose(
        rels[0, :3, 3], [0.0025633, -0.0007702, 0.00954718]
    )
    np.testing.assert_allclose(rels[0, 0, :3], [0.99963, 0.021072, -0.0172221])
    # exactly 5 identity rows = OpenCV failure frames
    ident = sum(bool(np.allclose(H, np.eye(4))) for H in rels)
    assert ident == 5


@needs_fixture
def test_minted_fr1_desk_baselines():
    """The two in-tree baselines evaluate to the BASELINE.md numbers,
    and the documented chain conventions beat their alternatives."""
    from cvo_rgbd_tpu.evaluation import mint_fr1_desk_baselines
    from cvo_rgbd_tpu.evaluation.plots import (
        chain_relative_poses, load_relative_pose_csv,
    )
    from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory

    stats = mint_fr1_desk_baselines(_DS)
    assert abs(stats["opencv_vo"]["rmse"] - 0.3066) < 2e-3
    assert abs(stats["matlab_cvo"]["rmse"] - 0.1494) < 2e-3
    # the wrong chain direction degrades RMSE ~2x (convention check)
    stamps = [float(e.name) for e in load_assoc(os.path.join(_DS, "assoc.txt"))]
    gt = read_trajectory(os.path.join(_DS, "groundtruth.txt"))
    rels = load_relative_pose_csv(os.path.join(_DS, "cv_rgbd_poses.csv"))
    wrong = ate_rmse(gt, chain_relative_poses(rels, stamps, invert=False))
    assert wrong["rmse"] > 1.5 * stats["opencv_vo"]["rmse"]
