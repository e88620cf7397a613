"""CLI argument parsing and evaluation subcommand smoke tests."""

import numpy as np
import pytest

from cvo_rgbd_tpu import cli

from test_odometry import synth_dataset, NUM_WANT  # noqa: F401  (fixture)


def test_help_lists_subcommands(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for cmd in ["run", "batch", "stitch", "evaluate-ate", "evaluate-rpe", "associate"]:
        assert cmd in out


def test_evaluate_ate_cli(tmp_path, capsys):
    gt = tmp_path / "gt.txt"
    est = tmp_path / "est.txt"
    lines = []
    for i in range(10):
        lines.append(f"{100 + i * 0.1:.6f} {0.01 * i:.6f} 0 0 0 0 0 1")
    gt.write_text("\n".join(lines) + "\n")
    est.write_text("\n".join(lines) + "\n")
    cli.main(["evaluate-ate", str(gt), str(est)])
    out = capsys.readouterr().out.strip()
    assert float(out) < 1e-10


def test_associate_cli(tmp_path, capsys):
    a = tmp_path / "rgb.txt"
    b = tmp_path / "depth.txt"
    a.write_text("# rgb\n1.00 rgb/1.png\n2.00 rgb/2.png\n")
    b.write_text("# depth\n1.01 depth/1.png\n2.015 depth/2.png\n")  # < 0.02 strictly
    cli.main(["associate", str(a), str(b)])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2
    assert "rgb/1.png" in out[0] and "depth/1.png" in out[0]


def test_generate_pointclouds_cli(synth_dataset, tmp_path, capsys):
    """generate-pointclouds: assoc frames -> per-frame cloud files
    (generate_pointcloud.py / util/generate_pointclouds.m analog)."""
    from cvo_rgbd_tpu.io import read_pcd

    out = tmp_path / "pcd_full"
    cli.main([
        "generate-pointclouds", str(synth_dataset), "1",
        "--out", str(out), "--stride", "4", "--max-frames", "2",
    ])
    files = sorted(out.glob("*.pcd"))
    assert len(files) == 2
    d = read_pcd(str(files[0]))
    assert d["positions"].shape[0] > 50
    # synth depth planes are at DEPTHS meters; z must land there
    assert 0.5 < float(np.median(d["positions"][:, 2])) < 4.0
    assert d["colors"].max() > 0


def test_registered_cloud_cli(synth_dataset, tmp_path, capsys):
    """registered-cloud: frames + groundtruth trajectory -> one PLY
    (generate_registered_pointcloud.py analog)."""
    out = tmp_path / "scene.ply"
    cli.main([
        "registered-cloud", str(synth_dataset), "1",
        str(synth_dataset / "groundtruth.txt"),
        "--output", str(out), "--stride", "6", "--max-frames", "3",
        "--downsample", "0.05",
    ])
    text = out.read_text().splitlines()
    n = int(next(l for l in text if l.startswith("element vertex")).split()[-1])
    assert n > 100
    assert "end_header" in text


def test_plot_trajectory_cli(synth_dataset, tmp_path, capsys):
    """plot-trajectory: trajectory projected into a frame image."""
    from PIL import Image

    # poses share the frames' timestamps (so associate matches frame 0)
    # but trace a path in FRONT of frame 0's camera (+z) so they project
    # fr1 intrinsics have cx=318.6/cy=255.3 but the synth image is only
    # 128x96, so pick a bearing (x,y)/z = (-0.5, -0.4) that projects to
    # u=60, v=48 — inside the small frame
    traj = tmp_path / "fwd.txt"
    lines = ["100.000000 0 0 0 0 0 0 1\n"]
    for i in range(1, 4):
        z = 1.0 + 0.2 * i
        lines.append(
            f"{100.0 + 0.1 * i:.6f} {-0.5 * z:.6f} {-0.4 * z:.6f} "
            f"{z:.6f} 0 0 0 1\n"
        )
    traj.write_text("".join(lines))
    out = tmp_path / "traj.png"
    cli.main([
        "plot-trajectory", str(synth_dataset), "1", str(traj),
        "--output", str(out), "--frame", "0",
    ])
    img = np.asarray(Image.open(out))
    assert img.ndim == 3 and img.shape[2] == 3
    # the marker color (255,40,40) must appear: later camera positions are
    # in front of frame 0 along +x and project into view
    red = (img[..., 0] == 255) & (img[..., 1] == 40) & (img[..., 2] == 40)
    assert red.sum() >= 1


def test_unknown_command_errors():
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


def test_run_profile_dir(synth_dataset, tmp_path, capsys):
    """run --profile-dir captures a jax.profiler trace of the drive."""
    prof = tmp_path / "trace"
    cli.main([
        "run", str(synth_dataset), "1", "--num-want", str(NUM_WANT),
        "--max-frames", "2", "--profile-dir", str(prof),
        "--output", str(tmp_path / "poses.txt"),
    ])
    assert (tmp_path / "poses.txt").exists()
    # the profiler writes plugins/profile/<ts>/*.xplane.pb under logdir
    assert any(prof.rglob("*.xplane.pb")), list(prof.rglob("*"))


def test_multiseq_cli(synth_dataset, capsys):
    """multiseq subcommand: lockstep batched odometry over folders."""
    cli.main([
        "multiseq", "1", str(synth_dataset), "--num-want", str(NUM_WANT),
        "--max-frames", "3",
    ])
    traj = synth_dataset / "cvo_poses_qt_batch.txt"
    assert traj.exists()
    lines = traj.read_text().strip().splitlines()
    assert len(lines) >= 2
    assert all(len(l.split()) == 8 for l in lines)


def test_slam_cli(tmp_path, capsys, rng):
    """slam subcommand: synthetic pcd dir -> TUM trajectory file."""
    from cvo_rgbd_tpu.io.export import write_pcd

    world = (rng.standard_normal((300, 3)) * 0.5 + [0, 0, 2.0]).astype(np.float32)
    col = (rng.random((300, 3)) * 255).astype(np.float32)
    for i in range(3):
        T = np.eye(4); T[:3, 3] = [0.02 * i, 0, 0]
        local = (world - T[:3, 3]) @ T[:3, :3]
        write_pcd(str(tmp_path / f"10{i}.500000.pcd"), local, col)
    out = tmp_path / "traj.txt"
    cli.main(["slam", str(tmp_path), "--output", str(out), "--grid", "0.3"])
    printed = capsys.readouterr().out
    assert "keyframes" in printed
    lines = out.read_text().strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("100.500000 ")
    # 8 TUM fields per line
    assert all(len(l.split()) == 8 for l in lines)


def test_run_tolerance_flags(synth_dataset, tmp_path, capsys):
    """--matlab-tol / --eps overrides build the right params: the
    MATLAB stop set roughly halves iteration counts vs the shipped C++
    stops (PERF.md stop-set equivalence)."""
    from cvo_rgbd_tpu.cli import _make_params

    import argparse

    ns = argparse.Namespace(adaptive=False, backend="xla",
                            matlab_tol=True, eps=None, eps_2=None)
    p = _make_params(ns)
    assert p.eps == 5e-4 and p.eps_2 == 1e-4
    ns2 = argparse.Namespace(adaptive=True, backend="pallas",
                             matlab_tol=False, eps=1e-3, eps_2=None)
    p2 = _make_params(ns2)
    assert p2.eps == 1e-3 and p2.backend == "pallas" and p2.eps_2 == 1e-5
    assert _make_params(argparse.Namespace(
        adaptive=False, backend="xla", matlab_tol=False,
        eps=None, eps_2=None)) is None

    out = tmp_path / "mt.txt"
    cli.main([
        "run", str(synth_dataset), "1", "--num-want", str(NUM_WANT),
        "--max-frames", "3", "--matlab-tol", "--output", str(out),
    ])
    assert out.exists()
