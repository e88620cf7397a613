"""Multi-sequence batched odometry: same trajectories as per-sequence runs."""

import numpy as np

from cvo_rgbd_tpu.io.tum import read_trajectory
from cvo_rgbd_tpu.multiseq import run_multiseq
from cvo_rgbd_tpu.odometry import run_odometry
from cvo_rgbd_tpu.params import CvoParams

from test_odometry import synth_dataset, NUM_WANT  # noqa: F401  (fixture)


def test_multiseq_matches_single(synth_dataset, tmp_path):
    p = CvoParams(max_iter=100)
    # single-sequence reference
    out_single = tmp_path / "single.txt"
    run_odometry(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                 output=str(out_single), warm_start=False,
                 log=lambda *a: None)

    # the same folder twice, in lockstep batch (cold vs cold)
    outs = run_multiseq([str(synth_dataset), str(synth_dataset)], 1,
                        params=p, num_want=NUM_WANT, warm_start=False,
                        log=lambda *a: None)
    single = read_trajectory(out_single)
    for path in set(outs.values()):
        batched = read_trajectory(path)
        assert set(batched) == set(single)
        # vmap changes fp32 reduction order; near knife-edge stopping
        # thresholds the iteration count (and thus the pose) drifts a
        # little.  Require trajectory-level agreement, not bit parity.
        for t in single:
            np.testing.assert_allclose(batched[t], single[t], atol=5e-3)

    # and the batched trajectory is as accurate as the single one
    from cvo_rgbd_tpu.evaluation import ate_rmse

    gt = read_trajectory(synth_dataset / "groundtruth.txt")
    ate_b = ate_rmse(gt, read_trajectory(path))["rmse"]
    ate_s = ate_rmse(gt, single)["rmse"]
    assert ate_b < max(2 * ate_s, 0.012)


def test_multiseq_warm_start_matches_sequential_warm(synth_dataset, tmp_path):
    """Each multiseq lane is its own sequence, so the per-lane warm
    start is EXACTLY the sequential driver's across-pair warm start —
    the trajectories must agree (up to vmap reduction-order drift) and
    the lockstep steps converge in fewer iterations than cold."""
    p = CvoParams(max_iter=100)
    out_single = tmp_path / "single.txt"
    run_odometry(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                 output=str(out_single), warm_start=True,
                 log=lambda *a: None)
    outs = run_multiseq([str(synth_dataset)], 1, params=p,
                        num_want=NUM_WANT, warm_start=True,
                        log=lambda *a: None)
    (path,) = set(outs.values())
    single = read_trajectory(out_single)
    warm = read_trajectory(path)
    assert set(warm) == set(single)
    for t in single:
        np.testing.assert_allclose(warm[t], single[t], atol=5e-3)


def test_batched_motion_prior_matches(synth_dataset, tmp_path):
    """run_odometry_batched(motion_prior=True): same trajectory as the
    default batched run within tolerance (the prior only changes the
    starting point, not the optimum)."""
    from cvo_rgbd_tpu.odometry import run_odometry_batched

    p = CvoParams(max_iter=100)
    out_plain = tmp_path / "plain.txt"
    run_odometry_batched(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                         output=str(out_plain), batch=2,
                         log=lambda *a: None)
    out_prior = tmp_path / "prior.txt"
    run_odometry_batched(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                         output=str(out_prior), batch=2, motion_prior=True,
                         log=lambda *a: None)
    plain = read_trajectory(out_plain)
    prior = read_trajectory(out_prior)
    assert set(prior) == set(plain)
    for t in plain:
        np.testing.assert_allclose(prior[t], plain[t], atol=5e-3)


def test_multiseq_ragged_lanes(synth_dataset, tmp_path):
    """Lanes of different lengths: the short lane retires when its
    sequence ends — its trajectory matches a solo
    run and stops at its own length, while the long lane's full
    trajectory is unaffected by sharing a batch with a retired lane."""
    import os

    short = tmp_path / "short"
    os.makedirs(short)
    os.symlink(synth_dataset / "rgb", short / "rgb")
    os.symlink(synth_dataset / "depth", short / "depth")
    entries = (synth_dataset / "assoc.txt").read_text().splitlines()
    (short / "assoc.txt").write_text("\n".join(entries[:2]) + "\n")

    p = CvoParams(max_iter=100)
    out_long = tmp_path / "long_solo.txt"
    run_odometry(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                 output=str(out_long), warm_start=False,
                 log=lambda *a: None)
    outs = run_multiseq([str(synth_dataset), str(short)], 1, params=p,
                        num_want=NUM_WANT, warm_start=False,
                        log=lambda *a: None)

    long_solo = read_trajectory(out_long)
    long_batch = read_trajectory(outs[str(synth_dataset)])
    short_batch = read_trajectory(outs[str(short)])

    assert len(short_batch) == 2
    assert set(long_batch) == set(long_solo)
    for t in long_solo:
        np.testing.assert_allclose(long_batch[t], long_solo[t], atol=5e-3)
    # the short lane's 2 poses agree with the long run's first 2
    for t in short_batch:
        np.testing.assert_allclose(short_batch[t], long_solo[t], atol=5e-3)


def test_empty_lane_converges_instantly(synth_dataset):
    """The retirement mechanism itself: an all-masked moving cloud
    converges at iteration 0 with a finite transform, so a retired lane
    cannot gate the lockstep batch's while_loop trip count."""
    import jax
    import numpy as np

    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.frontend import make_frontend
    from cvo_rgbd_tpu.io.tum import load_assoc
    from cvo_rgbd_tpu.odometry import load_image_pair
    from cvo_rgbd_tpu.parallel import align_batched

    frontend = make_frontend(1, NUM_WANT, 1)
    entries = load_assoc(str(synth_dataset / "assoc.txt"))
    c0 = frontend(*load_image_pair(str(synth_dataset), entries[0]))
    c1 = frontend(*load_image_pair(str(synth_dataset), entries[1]))
    empty = jax.tree_util.tree_map(np.zeros_like, c0)

    p = CvoParams(max_iter=100)
    res = align_batched(p, stack_clouds([c0, c0]), stack_clouds([c1, empty]))
    iters = np.asarray(res.iterations)
    assert iters[1] == 0, iters
    assert iters[0] > 0, iters
    assert np.isfinite(np.asarray(res.tf)).all()


def test_multiseq_adaptive_matches_single(synth_dataset, tmp_path):
    """acvo through multiseq."""
    from cvo_rgbd_tpu.params import AcvoParams

    p = AcvoParams(max_iter=100)
    out_single = tmp_path / "single.txt"
    run_odometry(str(synth_dataset), 1, adaptive=True, params=p,
                 num_want=NUM_WANT, output=str(out_single), max_frames=4,
                 warm_start=False, log=lambda *a: None)

    outs = run_multiseq([str(synth_dataset)], 1, adaptive=True, params=p,
                        num_want=NUM_WANT, max_frames=4, warm_start=False,
                        log=lambda *a: None)
    (path,) = set(outs.values())
    assert path.endswith("acvo_poses_qt_batch.txt")
    single = read_trajectory(out_single)
    batched = read_trajectory(path)
    assert set(batched) == set(single)
    for t in single:
        np.testing.assert_allclose(batched[t], single[t], atol=5e-3)


def test_multiseq_fetch_cadence_invariant(synth_dataset, tmp_path):
    """fetch_every only batches the device->host flushes; the per-lane
    warm chain runs on device either way (multiseq._compiled_lane_post)
    and pose chaining happens on the host from the same transforms —
    trajectories must be bit-identical across cadences."""
    import shutil

    p = CvoParams(max_iter=100)
    trajs = {}
    for fe in (1, 3):
        # copy the dataset so each cadence writes its own trajectory
        root = tmp_path / f"fe{fe}"
        shutil.copytree(synth_dataset, root)
        outs = run_multiseq([str(root)], 1, params=p, num_want=NUM_WANT,
                            fetch_every=fe, log=lambda *a: None)
        (path,) = set(outs.values())
        trajs[fe] = read_trajectory(path)
    assert set(trajs[1]) == set(trajs[3])
    for t in trajs[1]:
        np.testing.assert_array_equal(trajs[1][t], trajs[3][t])
