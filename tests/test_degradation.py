"""Sensor-degradation realism + the skip-and-mark failure path
.

The reference ingests real Kinect data — noisy quantized depth with
holes and texture-poor frames (pcd_generator.cpp:135-163's Canny
top-up exists for them) — and the MATLAB batch runner's NaN-on-failure
exists because pairs really fail (rgbddataset_rkhs.m:49-81).  These
tests drive degraded input through the production drivers and assert
the failure machinery actually fires: failed pairs are marked, poses
carry through (trajectory continuity), warm state resets, and bad
frames are never promoted to keyframes.
"""

import os

import numpy as np
import pytest

from cvo_rgbd_tpu.evaluation import ate_rmse
from cvo_rgbd_tpu.frontend import make_frontend
from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
from cvo_rgbd_tpu.odometry import load_image_pair, run_odometry
from cvo_rgbd_tpu.params import CvoParams
from cvo_rgbd_tpu.synth import (
    Degradation,
    make_tum_dataset,
    revisit_path,
)

N_FRAMES = 24
NUM_WANT = 512
DROP = 10            # total sensor dropout at this frame
LOW_TEX = 6          # texture contrast crushed at this frame
P = CvoParams(eps=5e-4, eps_2=1e-4)


@pytest.fixture(scope="module")
def degraded_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("degraded")
    deg = Degradation(
        depth_noise=2e-3, dropout=0.08,
        low_texture_frames=(LOW_TEX,), drop_frames=(DROP,), seed=3,
    )
    _, poses = make_tum_dataset(root, revisit_path(N_FRAMES, period=33),
                                degrade=deg)
    return root, poses


def test_degradation_model(degraded_dataset):
    """The degradation effects are actually present in the rendered
    frames: holes, noise, crushed texture, total dropout."""
    root, _ = degraded_dataset
    entries = load_assoc(os.path.join(root, "assoc.txt"))

    _, dep_drop = load_image_pair(root, entries[DROP])
    assert (dep_drop == 0).all()

    rgb_low, _ = load_image_pair(root, entries[LOW_TEX])
    rgb_ok, dep_ok = load_image_pair(root, entries[1])
    # crushed contrast: gradient energy collapses
    assert np.std(rgb_low) < 0.15 * np.std(rgb_ok)
    # dropout holes: a visible invalid fraction beyond the renderer's
    # own background pixels
    clean_root = str(root) + "_clean"
    make_tum_dataset(clean_root, revisit_path(N_FRAMES, period=33))
    _, dep_clean = load_image_pair(clean_root, entries[1])
    frac = (dep_ok == 0).mean() - (dep_clean == 0).mean()
    assert 0.04 < frac < 0.2, frac
    # noise: depth differs from clean render where both valid
    both = (dep_ok > 0) & (dep_clean > 0)
    scale = 5000.0  # camera 1 depth scale
    dz = (dep_ok[both] - dep_clean[both]) / scale
    assert 1e-4 < np.std(dz) < 0.1, np.std(dz)


def test_low_texture_frame_refill_fires(degraded_dataset):
    """The gated refill (the Canny top-up analog, selector.py:183-200)
    must engage on a texture-starved frame.  Like the reference's Canny
    scan (pcd_generator.cpp:135-163), the refill contributes at most
    ONE pixel per 8x8 block, so on the 96x128 synthetic frames its
    budget is (96//8)*(128//8) = 192 points — the assertion is that
    most of that budget is realized (the tier selection alone collapses
    on crushed contrast), and that the frame still clears the drivers'
    min_valid=64 failure gate."""
    root, _ = degraded_dataset
    entries = load_assoc(os.path.join(root, "assoc.txt"))
    frontend = make_frontend(1, NUM_WANT, 1)
    cloud = frontend(*load_image_pair(root, entries[LOW_TEX]))
    n_valid = int(np.asarray(cloud.mask).sum())
    n_blocks = (96 // 8) * (128 // 8)
    assert n_valid > 0.6 * n_blocks, n_valid
    assert n_valid >= 64  # clears cloud_ok, so the pair is not a failure


def test_odometry_failure_path_fires(degraded_dataset):
    """The two pairs touching the dropped frame are marked failed; the
    pose chain carries through and the rest of the trajectory still
    tracks ground truth."""
    root, _ = degraded_dataset
    out = os.path.join(root, "deg_poses.txt")
    records = run_odometry(str(root), 1, params=P, num_want=NUM_WANT,
                           output=out, log=lambda *a: None)
    failed = {r.index for r in records if r.failed}
    # pair DROP-1 -> DROP (moving empty) and DROP -> DROP+1 (fixed
    # empty) — exactly these, nothing else
    assert failed == {DROP, DROP + 1}, failed

    est = read_trajectory(out)
    entries = load_assoc(os.path.join(root, "assoc.txt"))
    names = [float(e.name) for e in entries]
    # continuity: the failed frames carry the previous accumulated pose
    np.testing.assert_allclose(est[names[DROP]], est[names[DROP - 1]])
    np.testing.assert_allclose(est[names[DROP + 1]], est[names[DROP - 1]])
    # the run recovers: global ATE stays bounded despite noise, holes,
    # a blind frame, and the two-frame pose freeze
    gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
    stats = ate_rmse(gt, est)
    assert stats["rmse"] < 0.08, stats


def test_odometry_nan_injection(degraded_dataset, monkeypatch):
    """A NaN-poisoned cloud (finite mask, non-finite positions — the
    align loop itself would silently converge to identity) must be
    caught by the input-sanity gate and skip-and-marked."""
    import cvo_rgbd_tpu.odometry as odom

    root, _ = degraded_dataset
    real_make = odom.make_frontend
    NAN_FRAME = 3

    def patched(seq, num_want, ft):
        f = real_make(seq, num_want, ft)
        count = [0]

        def wrap(rgb, dep):
            import jax.numpy as jnp

            c = f(rgb, dep)
            k = count[0]
            count[0] += 1
            if k == NAN_FRAME:
                c = c._replace(positions=jnp.full_like(c.positions, jnp.nan))
            return c

        return wrap

    monkeypatch.setattr(odom, "make_frontend", patched)
    records = run_odometry(str(root), 1, params=P, num_want=NUM_WANT,
                           max_frames=7, use_native=False,
                           output=os.path.join(root, "nan_poses.txt"),
                           log=lambda *a: None)
    failed = {r.index for r in records if r.failed}
    assert failed == {NAN_FRAME, NAN_FRAME + 1}, failed
    # recovery: the pair after the reset converges again
    later = [r for r in records if r.index > NAN_FRAME + 1]
    assert later and all(not r.failed for r in later)


def test_multiseq_failure_lane_isolated(degraded_dataset, tmp_path):
    """One lane's dropped frame fails only that lane's pair; the clean
    lane is untouched (per-lane skip-and-mark + warm reset)."""
    from cvo_rgbd_tpu.multiseq import run_multiseq

    root, _ = degraded_dataset
    clean = str(tmp_path / "clean")
    make_tum_dataset(clean, revisit_path(8, period=33))

    msgs = []
    outs = run_multiseq([str(root), clean], 1, params=P,
                        num_want=NUM_WANT, max_frames=12,
                        log=lambda *a: msgs.append(" ".join(map(str, a))))
    skip_msgs = [m for m in msgs if "skipping" in m]
    assert skip_msgs and all(str(root) in m for m in skip_msgs), skip_msgs
    # both trajectories written in full and finite
    t_deg = read_trajectory(outs[str(root)])
    t_clean = read_trajectory(outs[clean])
    assert len(t_deg) == 12 and len(t_clean) == 8
    for tr in (t_deg, t_clean):
        assert all(np.isfinite(v).all() for v in tr.values())


def test_batched_odometry_failure_path_fires(degraded_dataset):
    """run_odometry_batched must fire the same cloud_ok skip-and-mark
    gate as the sequential driver (ADVICE r4): the two pairs touching
    the dropped frame are failed — not silently chained as identity —
    and the pose chain carries through, in both the deferred-fetch and
    motion_prior paths."""
    from cvo_rgbd_tpu.odometry import run_odometry_batched

    root, _ = degraded_dataset
    for prior in (False, True):
        out = os.path.join(root, f"deg_batched_{int(prior)}.txt")
        records = run_odometry_batched(
            str(root), 1, params=P, num_want=NUM_WANT, batch=4,
            output=out, motion_prior=prior, log=lambda *a: None,
        )
        failed = {r.index for r in records if r.failed}
        assert failed == {DROP, DROP + 1}, (prior, failed)
        est = read_trajectory(out)
        entries = load_assoc(os.path.join(root, "assoc.txt"))
        names = [float(e.name) for e in entries]
        np.testing.assert_allclose(est[names[DROP]], est[names[DROP - 1]])
        np.testing.assert_allclose(est[names[DROP + 1]], est[names[DROP - 1]])


def test_slam_degenerate_first_frame_defers_seeding(degraded_dataset):
    """A degenerate frame 0 must not become the anchor keyframe
    (ADVICE r4): seeding is deferred to the first frame that passes
    cloud_ok, and the skipped frame holds the identity pose."""
    from cvo_rgbd_tpu.keyframes import KeyframePolicy
    from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig

    root, _ = degraded_dataset
    entries = load_assoc(os.path.join(root, "assoc.txt"))
    frontend = make_frontend(1, NUM_WANT, 1)
    slam = KeyframeSlam(P, SlamConfig(keyframe=KeyframePolicy(max_span=6)))
    # feed the dropped frame FIRST, then good frames
    order = [DROP, 1, 2, 3]
    for i, j in enumerate(order):
        slam.process(i, frontend(*load_image_pair(root, entries[j])))
    # frame 0 (degenerate) was skip-and-marked at identity, not seeded
    assert slam.keyframes[0].index == 1, [k.index for k in slam.keyframes]
    np.testing.assert_allclose(slam.frame_poses[0], np.eye(4))
    assert slam.keyframes[0].self_fip > 0
    # subsequent frames register normally off the deferred anchor
    assert np.isfinite(slam.frame_poses[-1]).all()
    poses, kf_poses = slam.solve()
    assert len(poses) == len(order)


def test_slam_failure_no_keyframe_from_bad_frame(degraded_dataset):
    """KeyframeSlam skip-and-marks the degenerate frame, repeats the
    pose, and never promotes the bad frame to a keyframe."""
    from cvo_rgbd_tpu.keyframes import KeyframePolicy
    from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig

    root, _ = degraded_dataset
    entries = load_assoc(os.path.join(root, "assoc.txt"))
    frontend = make_frontend(1, NUM_WANT, 1)
    slam = KeyframeSlam(P, SlamConfig(keyframe=KeyframePolicy(max_span=6)))
    for i, e in enumerate(entries[:DROP + 4]):
        slam.process(i, frontend(*load_image_pair(root, e)))
    # the dropped frame's pose equals its predecessor's
    np.testing.assert_allclose(slam.frame_poses[DROP],
                               slam.frame_poses[DROP - 1])
    assert DROP not in {k.index for k in slam.keyframes}
    # frames after the dropout keep registering (finite, moving again)
    assert np.isfinite(slam.frame_poses[-1]).all()
