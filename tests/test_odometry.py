"""End-to-end odometry on a synthetic TUM-format dataset.

A camera translating laterally in front of depth-banded textured
planes produces exact per-band integer image shifts (parallax with no
occlusion), giving closed-form ground truth — the 5-frame integration
test SURVEY.md section 4 calls for.
"""

import os

import numpy as np
import pytest
from PIL import Image

from cvo_rgbd_tpu.evaluation import ate_rmse
from cvo_rgbd_tpu.io.tum import read_trajectory
from cvo_rgbd_tpu.odometry import run_odometry

H, W = 96, 128
FX = 517.3         # fr1 intrinsics (camera registry key 1)
N_FRAMES = 6
DEPTHS = [1.0, 2.0, 4.0]       # 16-row bands cycle these depths
DX_M = 4.0 / FX                # camera translation/frame: 4px@1m, 2px@2m, 1px@4m
NUM_WANT = 1024

# NOTE: a single fronto-parallel plane is *degenerate* for CVO (no
# spatial signal for lateral motion; the RKHS landscape becomes
# multi-modal and the float64 oracle of the reference math lands on the
# same wrong optimum).  The scene therefore interleaves depth bands
# (parallax everywhere) and uses three independent smooth texture
# channels.  Residual per-pair bias of ~15-20% on this scene is
# intrinsic to the algorithm (oracle-verified), not an implementation
# artifact — thresholds below account for it.


def _smooth_field(seed, h, w):
    from scipy.ndimage import gaussian_filter, zoom

    r = np.random.default_rng(seed)
    b = zoom(gaussian_filter(r.normal(0, 1, (h // 4 + 2, w // 4 + 2)), 1.2), 4.05)
    b = b[:h, :w]
    return (b - b.min()) / (b.max() - b.min())


@pytest.fixture(scope="module")
def synth_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tumsynth")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    wb = W + 4 * N_FRAMES + 8
    big = np.stack(
        [40 + 200 * _smooth_field(s, H, wb) for s in (1, 2, 3)], axis=-1
    ).astype(np.float32)

    lines = []
    gt_lines = ["# ground truth"]
    for i in range(N_FRAMES):
        t = 100.0 + 0.1 * i
        name = f"{t:.6f}"
        rgb = np.zeros((H, W, 3), np.float32)
        dep = np.zeros((H, W), np.float32)
        for b in range(6):
            z = DEPTHS[b % 3]
            s = int(round(FX * DX_M / z)) * i
            rows = slice(b * 16, (b + 1) * 16)
            rgb[rows] = big[rows, s : s + W]
            dep[rows] = z * 5000.0
        Image.fromarray(rgb.astype(np.uint8)).save(root / "rgb" / f"{name}.png")
        Image.fromarray(dep.astype(np.uint16)).save(root / "depth" / f"{name}.png")
        lines.append(f"{name} rgb/{name}.png {name} depth/{name}.png")
        gt_lines.append(f"{name} {i * DX_M:.9f} 0 0 0 0 0 1")
    (root / "assoc.txt").write_text("\n".join(lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(gt_lines) + "\n")
    return root


def test_odometry_end_to_end(synth_dataset):
    records = run_odometry(
        str(synth_dataset),
        1,  # fr1 intrinsics
        num_want=NUM_WANT,
        log=lambda *a: None,
    )
    assert len(records) == N_FRAMES - 1
    assert all(not r.failed for r in records)

    est = read_trajectory(synth_dataset / "cvo_poses_qt.txt")
    assert len(est) == N_FRAMES
    gt = read_trajectory(synth_dataset / "groundtruth.txt")
    stats = ate_rmse(gt, est)
    # total motion is 38.7mm; the intrinsic per-pair bias (~20%, see
    # fixture note) accumulates to at most ~8mm trajectory error
    assert stats["rmse"] < 0.012, stats

    # the accumulated pose moves dominantly along +x
    last = est[max(est.keys())]
    expect = (N_FRAMES - 1) * DX_M
    assert last[0, 3] > 0.55 * expect
    assert abs(last[1, 3]) < 0.35 * last[0, 3]
    assert abs(last[2, 3]) < 0.35 * last[0, 3]


def test_odometry_warm_start(synth_dataset, tmp_path):
    """Across-pair warm start (reference semantics: R/T/ell members
    persist between run_cvo calls, cvo.cpp:43-45, 398-399, 408-410).
    The warm path must converge in no more iterations than the cold
    path on average and stay accurate."""
    out_cold = tmp_path / "cold.txt"
    rec_cold = run_odometry(
        str(synth_dataset), 1, num_want=NUM_WANT, output=str(out_cold),
        warm_start=False, log=lambda *a: None,
    )
    out_warm = tmp_path / "warm.txt"
    rec_warm = run_odometry(
        str(synth_dataset), 1, num_want=NUM_WANT, output=str(out_warm),
        warm_start=True, log=lambda *a: None,
    )
    assert all(not r.failed for r in rec_warm)
    it_cold = np.mean([r.iterations for r in rec_cold])
    it_warm = np.mean([r.iterations for r in rec_warm])
    # constant per-frame motion: the previous transform is a near-exact
    # prior, so warm convergence is at least as fast
    assert it_warm <= it_cold + 1, (it_warm, it_cold)
    gt = read_trajectory(synth_dataset / "groundtruth.txt")
    warm_stats = ate_rmse(gt, read_trajectory(out_warm))
    cold_stats = ate_rmse(gt, read_trajectory(out_cold))
    assert warm_stats["rmse"] < 0.012, warm_stats
    assert warm_stats["rmse"] <= cold_stats["rmse"] * 1.5


def test_odometry_checkpoint_resume(synth_dataset, tmp_path):
    out_full = tmp_path / "full.txt"
    run_odometry(
        str(synth_dataset), 1, num_want=NUM_WANT, output=str(out_full),
        log=lambda *a: None,
    )

    out_resumed = tmp_path / "resumed.txt"
    ckpt = tmp_path / "ckpt.json"
    run_odometry(
        str(synth_dataset), 1, num_want=NUM_WANT, output=str(out_resumed),
        checkpoint=str(ckpt), max_frames=3, log=lambda *a: None,
    )
    assert ckpt.exists()
    run_odometry(
        str(synth_dataset), 1, num_want=NUM_WANT, output=str(out_resumed),
        checkpoint=str(ckpt), log=lambda *a: None,
    )
    full = read_trajectory(out_full)
    resumed = read_trajectory(out_resumed)
    assert set(full.keys()) == set(resumed.keys())
    for t in full:
        np.testing.assert_allclose(resumed[t], full[t], atol=1e-5)


def test_odometry_adaptive_smoke(synth_dataset, tmp_path):
    """acvo path: runs, converges, produces a finite trajectory."""
    out = tmp_path / "acvo.txt"
    records = run_odometry(
        str(synth_dataset), 1, adaptive=True, num_want=NUM_WANT,
        output=str(out), max_frames=3, log=lambda *a: None,
    )
    assert len(records) == 2
    assert all(not r.failed for r in records)
    est = read_trajectory(out)
    assert len(est) == 3
    for T in est.values():
        assert np.isfinite(T).all()


def test_odometry_batched_matches_sequential(synth_dataset, tmp_path):
    from cvo_rgbd_tpu.odometry import run_odometry_batched
    from cvo_rgbd_tpu.params import CvoParams

    p = CvoParams(max_iter=100)
    out_seq = tmp_path / "seq.txt"
    # batched mode registers pairs independently (no across-pair warm
    # start), so compare against the cold sequential path
    run_odometry(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                 output=str(out_seq), warm_start=False, log=lambda *a: None)
    out_bat = tmp_path / "bat.txt"
    run_odometry_batched(str(synth_dataset), 1, params=p, num_want=NUM_WANT,
                         output=str(out_bat), batch=4, log=lambda *a: None)
    seq = read_trajectory(out_seq)
    bat = read_trajectory(out_bat)
    assert set(seq) == set(bat)
    # vmap reduction-order drift only (see multiseq test)
    for t in seq:
        np.testing.assert_allclose(bat[t], seq[t], atol=5e-3)


def test_odometry_batched_adaptive_matches_sequential(synth_dataset, tmp_path):
    """acvo through the batched driver: same
    trajectory as the sequential acvo driver."""
    from cvo_rgbd_tpu.odometry import run_odometry_batched
    from cvo_rgbd_tpu.params import AcvoParams

    p = AcvoParams(max_iter=100)
    out_seq = tmp_path / "seq.txt"
    run_odometry(str(synth_dataset), 1, adaptive=True, params=p,
                 num_want=NUM_WANT, output=str(out_seq), max_frames=4,
                 warm_start=False, log=lambda *a: None)
    out_bat = tmp_path / "bat.txt"
    records = run_odometry_batched(
        str(synth_dataset), 1, adaptive=True, params=p, num_want=NUM_WANT,
        output=str(out_bat), max_frames=4, batch=3, log=lambda *a: None,
    )
    assert all(not r.failed for r in records)
    seq = read_trajectory(out_seq)
    bat = read_trajectory(out_bat)
    assert set(seq) == set(bat)
    for t in seq:
        np.testing.assert_allclose(bat[t], seq[t], atol=5e-3)


def test_odometry_fetch_cadence_invariant(synth_dataset, tmp_path):
    """fetch_every only changes WHEN results cross device->host, never
    the values: the warm chain and failure reset run on device and the
    fp64 pose chaining happens on the host from the same per-pair
    transforms (odometry._compiled_odom_step).  Trajectories and
    iteration counts must be bit-identical across cadences."""
    outs = {}
    iters = {}
    for fe in (1, 3):
        out = tmp_path / f"fe{fe}.txt"
        recs = run_odometry(
            str(synth_dataset), 1, num_want=NUM_WANT, output=str(out),
            fetch_every=fe, log=lambda *a: None,
        )
        outs[fe] = read_trajectory(out)
        iters[fe] = [r.iterations for r in recs]
    assert iters[1] == iters[3]
    assert set(outs[1]) == set(outs[3])
    for t in outs[1]:
        np.testing.assert_array_equal(outs[1][t], outs[3][t])
