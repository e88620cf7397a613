"""Sequence-scale oracle trajectory parity.

The reference's de-facto verification is cross-implementation
redundancy: the MATLAB class and the C++ engine implement the same
math and their trajectories agree (SURVEY.md section 4 item 3).  Here
the independent float64 numpy oracle (tests/oracle.py — a literal
dense transcription of cvo.cpp:99-308) is CHAINED over a synthetic
sequence with the production driver's warm-start semantics, and the
fp32 production trajectory must match it at mm scale — at BOTH
tolerance sets: the C++ shipped stops (eps=5e-5/1e-5, cvo.cpp:40-41,
reachable in fp32 since the difference-form flow epilogues) and the
MATLAB stops (5e-4/1e-4, rkhs_se3_registration.m:18-19).

Chain scale matters: single-pair parity (test_align_parity.py) cannot
see fp32 drift compounding over warm-started pairs; 12 chained
registrations can.
"""

import os

import numpy as np
import pytest

from cvo_rgbd_tpu.frontend import make_frontend
from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
from cvo_rgbd_tpu.odometry import load_image_pair, run_odometry
from cvo_rgbd_tpu.params import CvoParams
from cvo_rgbd_tpu.synth import make_tum_dataset, revisit_path

from oracle import odometry_oracle

N_FRAMES = 12
NUM_WANT = 512


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle_traj")
    make_tum_dataset(root, revisit_path(N_FRAMES, period=33))
    return root


@pytest.fixture(scope="module")
def clouds(dataset):
    frontend = make_frontend(1, NUM_WANT, 1)
    entries = load_assoc(os.path.join(dataset, "assoc.txt"))
    padded, raw = [], []
    for e in entries:
        rgb, dep = load_image_pair(dataset, e)
        c = frontend(rgb, dep)
        padded.append(c)
        m = np.asarray(c.mask) > 0
        raw.append((np.asarray(c.positions)[m], np.asarray(c.features)[m]))
    return entries, padded, raw


@pytest.mark.parametrize(
    "eps,eps_2,tol_mm,tol_mrad",
    [
        # C++ shipped stops (cvo.cpp:40-41): tight stop -> tight parity
        (5e-5, 1e-5, 3.0, 3.0),
        # MATLAB stops (rkhs_se3_registration.m:18-19): both solvers
        # halt anywhere inside a 10x wider tolerance ball, so chained
        # divergence is proportionally looser (the stored MATLAB run
        # itself agrees with this framework only to 2.8-4.3 mm per
        # single pair, docs/PARITY.md)
        (5e-4, 1e-4, 8.0, 10.0),
    ],
)
def test_oracle_trajectory_parity(dataset, clouds, eps, eps_2, tol_mm,
                                  tol_mrad):
    entries, _, raw = clouds
    p = CvoParams(eps=eps, eps_2=eps_2, max_iter=300)

    records = run_odometry(
        str(dataset), 1, params=p, num_want=NUM_WANT,
        output=os.path.join(dataset, f"parity_{eps:g}.txt"),
        log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    est = read_trajectory(os.path.join(dataset, f"parity_{eps:g}.txt"))
    names = [float(e.name) for e in entries]

    oracle_poses, oracle_iters = odometry_oracle(raw, p)
    # every oracle pair must itself converge within the cap, or the
    # comparison would be against a truncated solve
    assert max(oracle_iters) < p.max_iter - 1

    errs_mm = []
    for i, name in enumerate(names):
        d = est[name][:3, 3] - oracle_poses[i][:3, 3]
        errs_mm.append(np.linalg.norm(d) * 1e3)
    errs_mm = np.asarray(errs_mm)
    # mm-scale agreement along the WHOLE chain, not just the endpoint
    assert errs_mm.max() < tol_mm, errs_mm

    # rotation agreement: relative rotation angle at the endpoint
    Rd = est[names[-1]][:3, :3] @ oracle_poses[-1][:3, :3].T
    ang_mrad = np.degrees(
        np.arccos(np.clip((np.trace(Rd) - 1) / 2, -1, 1))
    ) * np.pi / 180 * 1e3
    assert ang_mrad < tol_mrad, ang_mrad
