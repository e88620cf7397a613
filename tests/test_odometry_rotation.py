"""Rotation-rich end-to-end odometry on a ray-traced synthetic scene.

The camera ORBITS a pivot inside the banded-depth scene (yaw + a touch
of pitch), so every frame pair carries genuine rotation — the full
chain (selector -> backproject -> align -> quaternion writer -> ATE)
would fail here on any exp_sek3 / quaternion / chaining sign error,
which the pure-lateral-translation scene of test_odometry.py cannot
catch (reference acceptance evaluate_ate.py:152-162).

The scene/renderer lives in cvo_rgbd_tpu.synth (BandScene: six
horizontal depth bands with smooth textures, exact per-pixel ray/plane
intersection with z-buffering — closed-form ground truth, correct
occlusion).  Long-sequence/revisit variants are in test_longseq.py.
"""

import subprocess
import sys

import numpy as np
import pytest

from cvo_rgbd_tpu.evaluation import ate_rmse
from cvo_rgbd_tpu.io.tum import read_trajectory
from cvo_rgbd_tpu.odometry import run_odometry
from cvo_rgbd_tpu.synth import BandScene, linear_orbit_path, make_tum_dataset

N_FRAMES = 6
NUM_WANT = 1024


@pytest.fixture(scope="module")
def orbit_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tumorbit")
    scene = BandScene(u_pad=80, v_pad=16)  # margins sized for 6 frames
    path = linear_orbit_path(N_FRAMES, yaw_step_deg=0.8, pitch_step_deg=0.15)
    make_tum_dataset(root, path, scene)
    return root


def _rotation_errors_mrad(root, est):
    gt = read_trajectory(root / "groundtruth.txt")
    errs = []
    for t, T in est.items():
        k = min(gt.keys(), key=lambda g: abs(g - t))
        dR = T[:3, :3] @ gt[k][:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        errs.append(ang * 1e3)
    return errs


def _cli_ate(root, est_path):
    """Round-trip the written trajectory through the evaluate-ate CLI."""
    out = subprocess.run(
        [sys.executable, "-m", "cvo_rgbd_tpu.cli", "evaluate-ate",
         str(root / "groundtruth.txt"), str(est_path)],
        capture_output=True, text=True, check=True,
    )
    return float(out.stdout.strip())


def test_rotation_odometry_cvo(orbit_dataset):
    records = run_odometry(
        str(orbit_dataset), 1, num_want=NUM_WANT, log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    est_path = orbit_dataset / "cvo_poses_qt.txt"
    est = read_trajectory(est_path)
    assert len(est) == N_FRAMES

    gt = read_trajectory(orbit_dataset / "groundtruth.txt")
    stats = ate_rmse(gt, est)
    # total camera path ~120 mm with ~4.8 deg of accumulated rotation;
    # a sign/convention error anywhere in the rotation chain produces
    # errors at the FULL motion scale (>= 40 mm / >= 30 mrad)
    assert stats["rmse"] < 0.015, stats

    # measured drift: ~3 mrad/pair accumulating to ~15 mrad over the
    # 70 mrad of total rotation (the scene's intrinsic ~20% per-pair
    # bias, see test_odometry.py fixture note); a sign error would read
    # ~140 mrad (rotating the wrong way doubles the error)
    rot_errs = _rotation_errors_mrad(orbit_dataset, est)
    assert max(rot_errs) < 25.0, rot_errs

    # quaternion writer round-trips through the evaluate-ate CLI and
    # agrees with the library ATE (evaluate_ate.py:152-162 analog)
    cli_rmse = _cli_ate(orbit_dataset, est_path)
    np.testing.assert_allclose(cli_rmse, stats["rmse"], rtol=1e-4)


def test_rotation_odometry_acvo(orbit_dataset, tmp_path):
    out = tmp_path / "acvo_poses_qt.txt"
    records = run_odometry(
        str(orbit_dataset), 1, adaptive=True, num_want=NUM_WANT,
        output=str(out), log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    est = read_trajectory(out)
    assert len(est) == N_FRAMES

    gt = read_trajectory(orbit_dataset / "groundtruth.txt")
    stats = ate_rmse(gt, est)
    assert stats["rmse"] < 0.02, stats
    rot_errs = _rotation_errors_mrad(orbit_dataset, est)
    assert max(rot_errs) < 30.0, rot_errs
