"""Real-data pose parity against the stored reference MATLAB run.

The reference vendors a genuine MATLAB batch registration result
(freiburg1_desk_07-May-2019-02-35-00.mat, written by
rgbddataset_rkhs.m:87-88) containing 572 pairwise transforms, plus the
first 5 downsampled clouds the run consumed (pcd_ds/*.pcd).  These
tests re-register the 4 vendored fixture pairs with the same protocol
(range filter [0.8, 4] m + 0.05 gridAverage downsample + dense linear-
color-kernel align, rgbddataset_rkhs.m:34-66) and assert the resulting
transforms match the stored MATLAB output.

This is the only direct comparison available against actual reference
OUTPUT (not a re-derivation): agreement here validates the whole chain
— pcd reading, preprocessing, kernel, flow, step, integrator, stopping
rules — against an independent implementation run by the original
authors.

Tolerance calibration (loop CLOSED in round 5, docs/PARITY.md section
1): the 2.8-4.3 mm residual at the MATLAB stop set is EARLY-STOPPING
skew, not downsample semantics — perturbing every plausible
pcdownsample convention (bin clamping, uint8 color rounding) moves the
pose by <= 0.02 mm, while running the SAME clouds to the C++ shipped
stops (eps=5e-5/1e-5) lands 0.41-0.73 mm from the stored transforms on
all 4 pairs (test_converged_parity_sub_mm below).  Both implementations
stop early at eps=5e-4 but at different points along the flow; the
converged optima agree to sub-mm.
"""

import numpy as np
import pytest

from cvo_rgbd_tpu import MATLAB_PARAMS, align_jit, pad_cloud
from cvo_rgbd_tpu.io import read_pcd, read_stored_run
from cvo_rgbd_tpu.utils import grid_downsample, range_filter

DS = "/root/reference/data/rgbd_dataset/freiburg1_desk"
MAT = f"{DS}/freiburg1_desk_07-May-2019-02-35-00.mat"
STAMPS = [
    "1305031453.359684",
    "1305031453.391690",
    "1305031453.423683",
    "1305031453.459685",
    "1305031453.491698",
]

TRANS_TOL_M = 8e-3    # measured max 4.3 mm; margin for platform drift
ROT_TOL_RAD = 8e-3    # measured max 4.2e-3 rad


@pytest.fixture(autouse=True, scope="module")
def _needs_reference_data():
    """The stored run and fixture clouds are not vendored in every
    checkout; without them these tests skip (decided per test)."""
    import os

    if not os.path.exists(MAT):
        pytest.skip("reference dataset not vendored")


@pytest.fixture(scope="module")
def stored():
    return read_stored_run(MAT)


@pytest.fixture(scope="module")
def fixture_clouds():
    raw = []
    for t in STAMPS:
        d = read_pcd(f"{DS}/pcd_ds/{t}.pcd")
        pos, col = range_filter(d["positions"], d["colors"])
        pos, col = grid_downsample(pos, col, 0.05)
        raw.append((pos, col * 255.0))  # MATLAB Color is uint8-scaled
    cap = 128 * ((max(p.shape[0] for p, _ in raw) + 127) // 128)
    return [pad_cloud(p, c, capacity=cap) for p, c in raw]


def test_stored_run_structure(stored):
    """The MCOS extraction yields exactly the published run."""
    assert stored.num_pairs == 572
    assert stored.dataset_name == "freiburg1_desk"
    assert stored.registration_time.shape == (572,)
    # result{1} is the seed identity (rgbddataset_rkhs.m:41-42)
    np.testing.assert_array_equal(stored.transforms[0], np.eye(4))
    # every stored transform is a rigid motion: orthonormal R, det +1
    R = stored.transforms[1:, :3, :3]
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-6)
    assert np.all(np.linalg.det(R) > 0.999)
    # fr1/desk is a slow handheld sequence: per-pair motion is small
    t = stored.transforms[1:, :3, 3]
    assert np.all(np.linalg.norm(t, axis=1) < 0.25)


def test_pairwise_transforms_match_stored_matlab_run(stored, fixture_clouds):
    """align(MATLAB_PARAMS) on the vendored pairs reproduces the stored
    MATLAB transforms to mm / milliradian level."""
    for i in range(4):
        res = align_jit(MATLAB_PARAMS, fixture_clouds[i], fixture_clouds[i + 1])
        R = np.asarray(res.R, np.float64)
        T = np.asarray(res.T, np.float64)
        # MATLAB's final tform = tf_inv(R, T) of the final state
        # (rkhs_se3_registration.m:261)
        ours = np.eye(4)
        ours[:3, :3] = R.T
        ours[:3, 3] = -R.T @ T
        ref = stored.pair_transform(i)
        dt = np.linalg.norm(ours[:3, 3] - ref[:3, 3])
        dR = ours[:3, :3] @ ref[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        assert dt < TRANS_TOL_M, f"pair {i}: translation drift {dt*1e3:.2f} mm"
        assert ang < ROT_TOL_RAD, f"pair {i}: rotation drift {ang:.2e} rad"
        # and the solved pose is non-trivial (the test has teeth): the
        # stored motion itself is ~1 cm
        assert np.linalg.norm(ref[:3, 3]) > 5e-3


def test_converged_parity_sub_mm(stored, fixture_clouds):
    """The closed parity loop: at the C++ shipped
    stops the converged optimum agrees with the stored MATLAB
    transforms to sub-mm on every vendored pair — the registration
    math matches; the looser headline tolerance above is stopping-rule
    skew, not model error."""
    import dataclasses

    p = dataclasses.replace(MATLAB_PARAMS, eps=5e-5, eps_2=1e-5)
    for i in range(4):
        res = align_jit(p, fixture_clouds[i], fixture_clouds[i + 1])
        R = np.asarray(res.R, np.float64)
        T = np.asarray(res.T, np.float64)
        ours = np.eye(4)
        ours[:3, :3] = R.T
        ours[:3, 3] = -R.T @ T
        ref = stored.pair_transform(i)
        dt = np.linalg.norm(ours[:3, 3] - ref[:3, 3])
        dR = ours[:3, :3] @ ref[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        assert dt < 1.0e-3, f"pair {i}: {dt*1e3:.2f} mm"
        assert ang < 1.5e-3, f"pair {i}: {ang:.2e} rad"


def test_downsample_semantics_do_not_move_the_pose(stored):
    """The direct refutation of the old attribution: MATLAB-plausible
    pcdownsample variants (upper-boundary bin clamping, uint8 color
    rounding) leave the aligned pose unchanged to ~0.02 mm."""
    def variant(clamp=False, round_color=False):
        raw = []
        for t in STAMPS[:2]:
            d = read_pcd(f"{DS}/pcd_ds/{t}.pcd")
            pos, col = range_filter(d["positions"], d["colors"])
            lower = pos.min(axis=0)
            keys = np.floor((pos - lower) / 0.05).astype(np.int64)
            if clamp:
                nb = np.ceil((pos.max(axis=0) - lower) / 0.05).astype(np.int64)
                keys = np.minimum(keys, np.maximum(nb - 1, 0))
            order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
            ks, ps, cs = keys[order], pos[order], col[order]
            b = np.any(np.diff(ks, axis=0) != 0, axis=1)
            starts = np.concatenate([[0], np.nonzero(b)[0] + 1])
            counts = np.diff(np.concatenate([starts, [len(ps)]]))
            pm = (np.add.reduceat(ps, starts, axis=0)
                  / counts[:, None]).astype(np.float32)
            cm = np.add.reduceat(cs, starts, axis=0) / counts[:, None]
            if round_color:
                cm = np.round(cm * 255.0) / 255.0
            raw.append((pm, cm.astype(np.float32) * 255.0))
        cap = 128 * ((max(p_.shape[0] for p_, _ in raw) + 127) // 128)
        pads = [pad_cloud(p_, c_, capacity=cap) for p_, c_ in raw]
        res = align_jit(MATLAB_PARAMS, pads[0], pads[1])
        return np.asarray(res.tf)

    base = variant()
    for kw in ({"clamp": True}, {"round_color": True}):
        tf = variant(**kw)
        dt = np.linalg.norm(tf[:3, 3] - base[:3, 3])
        assert dt < 1e-4, (kw, dt)


def test_accumulated_chain_matches_stored(stored, fixture_clouds):
    """Chained pairwise transforms over the 5 fixture frames match the
    MATLAB accumulation (drift compounds but stays at mm level)."""
    ours_chain = np.eye(4)
    ref_chain = np.eye(4)
    for i in range(4):
        res = align_jit(MATLAB_PARAMS, fixture_clouds[i], fixture_clouds[i + 1])
        R = np.asarray(res.R, np.float64)
        T = np.asarray(res.T, np.float64)
        step = np.eye(4)
        step[:3, :3] = R.T
        step[:3, 3] = -R.T @ T
        ours_chain = ours_chain @ step
        ref_chain = ref_chain @ stored.pair_transform(i)
    dt = np.linalg.norm(ours_chain[:3, 3] - ref_chain[:3, 3])
    assert dt < 4 * TRANS_TOL_M, f"chained translation drift {dt*1e3:.2f} mm"


def test_batch_runner_matches_stored(stored, tmp_path):
    """The MATLAB-analog batch driver (batch.run_batch — the
    rgbddataset_rkhs.m re-expression) over the vendored pcd_ds/
    directory reproduces the stored .mat per-pair transforms AND the
    accumulated chain: same data as the API-level
    parity tests above, exercised through directory loading, the
    preprocessing defaults, skip-and-mark, and the npz writer."""
    from cvo_rgbd_tpu.batch import run_batch

    out = tmp_path / "batch.npz"
    results, times = run_batch(
        f"{DS}/pcd_ds", output=str(out), log=lambda *a: None
    )
    assert results.shape == (5, 4, 4)
    np.testing.assert_array_equal(results[0], np.eye(4))
    assert times.shape == (4,)

    ours_chain = np.eye(4)
    ref_chain = np.eye(4)
    for i in range(4):
        got = results[i + 1]
        ref = stored.pair_transform(i)
        dt = np.linalg.norm(got[:3, 3] - ref[:3, 3])
        dR = got[:3, :3] @ ref[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        assert dt < TRANS_TOL_M, f"pair {i}: {dt*1e3:.2f} mm"
        assert ang < ROT_TOL_RAD, f"pair {i}: {ang:.2e} rad"
        ours_chain = ours_chain @ got
        ref_chain = ref_chain @ stored.pair_transform(i)
    dt = np.linalg.norm(ours_chain[:3, 3] - ref_chain[:3, 3])
    assert dt < 4 * TRANS_TOL_M, f"chained drift {dt*1e3:.2f} mm"

    # the npz is the rgbddataset_rkhs.m .mat analog: reload and check
    dat = np.load(out, allow_pickle=False)
    np.testing.assert_array_equal(dat["results"], results)
    np.testing.assert_array_equal(dat["registration_time"], times)
