"""Command-line interface.

`python -m cvo_rgbd_tpu.cli run <folder> <seq> [--adaptive]` mirrors the
reference executables (`./cvo $data_path $tum_seq`, README.md:49-59),
plus evaluation subcommands replacing evaluate_ate.py / evaluate_rpe.py
and an `associate` subcommand replacing assoc.sh.
"""

from __future__ import annotations

import argparse
import json


def _make_params(args):
    """Params from CLI flags; None = library defaults (the C++
    constants, incl. the shipped stops eps=5e-5/1e-5 — reachable in
    fp32, see PERF.md).  `--matlab-tol` switches to the MATLAB stop
    set (5e-4/1e-4, rkhs_se3_registration.m:18-19) for ~half the
    iterations at a ~1 mm pose delta; `--eps/--eps-2` set the
    thresholds directly."""
    from cvo_rgbd_tpu.params import AcvoParams, CvoParams

    cls = AcvoParams if getattr(args, "adaptive", False) else CvoParams
    kw = {}
    if getattr(args, "backend", "xla") != "xla":
        kw["backend"] = args.backend
    if getattr(args, "matlab_tol", False):
        kw["eps"], kw["eps_2"] = 5e-4, 1e-4
    if getattr(args, "eps", None) is not None:
        kw["eps"] = args.eps
    if getattr(args, "eps_2", None) is not None:
        kw["eps_2"] = args.eps_2
    return cls(**kw) if kw else None


def _cmd_run(args):
    import contextlib

    seq = int(args.seq) if args.seq.isdigit() else args.seq
    params = _make_params(args)
    trace = contextlib.nullcontext()
    if args.profile_dir:
        # device-level tracing (SURVEY.md section 5): view the captured
        # trace with tensorboard/xprof pointed at --profile-dir
        from cvo_rgbd_tpu.utils.timing import profiler_trace

        trace = profiler_trace(args.profile_dir)
    with trace:
        return _run_odometry_cmd(args, seq, params)


def _run_odometry_cmd(args, seq, params):
    from cvo_rgbd_tpu.odometry import run_odometry

    if args.batch > 1:
        if args.checkpoint:
            raise SystemExit("--batch does not support checkpointing")
        from cvo_rgbd_tpu.odometry import run_odometry_batched

        return run_odometry_batched(
            args.folder, seq, adaptive=args.adaptive, params=params,
            output=args.output,
            max_frames=args.max_frames, num_want=args.num_want,
            batch=args.batch, use_native=not args.no_native_io,
            motion_prior=args.motion_prior,
        )
    return run_odometry(
        args.folder,
        seq,
        adaptive=args.adaptive,
        params=params,
        output=args.output,
        max_frames=args.max_frames,
        checkpoint=args.checkpoint,
        num_want=args.num_want,
        use_native=not args.no_native_io,
        warm_start=not args.cold_start,
        fetch_every=args.fetch_every,
    )


def _cmd_multiseq(args):
    from cvo_rgbd_tpu.multiseq import run_multiseq

    seq = int(args.seq) if args.seq.isdigit() else args.seq
    params = _make_params(args)
    run_multiseq(
        args.folders, seq, adaptive=args.adaptive, params=params,
        num_want=args.num_want, max_frames=args.max_frames,
        warm_start=not args.cold_start,
    )


def _cmd_batch(args):
    from cvo_rgbd_tpu.batch import run_batch

    run_batch(args.directory, grid=args.grid, output=args.output)


def _cmd_stitch(args):
    import numpy as np

    from cvo_rgbd_tpu import MATLAB_PARAMS, align_jit, pad_cloud
    from cvo_rgbd_tpu.batch import load_pcd_dir
    from cvo_rgbd_tpu.core.cloud import round_up
    from cvo_rgbd_tpu.io.export import merge_clouds, transform_points, write_ply

    clouds = load_pcd_dir(args.directory, grid=args.grid)
    cap = round_up(max(c[1].shape[0] for c in clouds))
    padded = [pad_cloud(p, c, capacity=cap) for _, p, c in clouds]
    # pairs are independent cold-start aligns: dispatch them all, then
    # ONE device->host drain (a per-pair fetch would wait on each align)
    import jax

    tfs = jax.device_get([
        align_jit(MATLAB_PARAMS, padded[k - 1], padded[k]).tf
        for k in range(1, len(clouds))
    ])
    accum = np.eye(4)
    placed = [(clouds[0][1], clouds[0][2])]
    for k in range(1, len(clouds)):
        accum = accum @ tfs[k - 1]
        placed.append((transform_points(accum, clouds[k][1]), clouds[k][2]))
    pos, col = merge_clouds(placed, grid=args.merge_grid)
    write_ply(args.output, pos, col)
    print(f"{pos.shape[0]} points -> {args.output}")


def _cmd_slam(args):
    import numpy as np

    from cvo_rgbd_tpu import MATLAB_PARAMS, pad_cloud
    from cvo_rgbd_tpu.batch import load_pcd_dir
    from cvo_rgbd_tpu.core.cloud import round_up
    from cvo_rgbd_tpu.io.tum import write_trajectory_line
    from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig

    clouds = load_pcd_dir(args.directory, grid=args.grid)
    if not clouds:
        raise SystemExit(f"no .pcd files in {args.directory}")
    cap = round_up(max(p.shape[0] for _, p, _ in clouds))
    slam = KeyframeSlam(MATLAB_PARAMS, SlamConfig())
    for i, (_, p_, c_) in enumerate(clouds):
        slam.process(i, pad_cloud(p_, c_, capacity=cap))
    poses, kf_nodes = slam.solve()
    print(f"{len(clouds)} frames, {len(slam.keyframes)} keyframes, "
          f"{len(slam.loop_edges)} loop closures")
    if args.refine:
        out = slam.refine_map(kf_poses=kf_nodes)
        if out is None:
            print("refine: too few correspondences, skipped")
        else:
            kf_ba, landmarks, costs = out
            print(f"refine: BA cost {float(costs[0]):.3e} -> "
                  f"{float(costs[-1]):.3e}, {landmarks.shape[0]} landmarks")
            corr = {k.index: np.asarray(kf_ba[i]) @ np.linalg.inv(
                np.asarray(kf_nodes[i])) for i, k in enumerate(slam.keyframes)}
            poses = [
                corr.get(slam.keyframes[slam.frame_keyframe[i]].index,
                         np.eye(4)) @ pose
                for i, pose in enumerate(poses)
            ]
    with open(args.output, "w") as fh:
        for (name, _, _), pose in zip(clouds, poses):
            write_trajectory_line(fh, name.removesuffix(".pcd"), pose)
    print(f"trajectory -> {args.output}")


def _seq_key(seq):
    return int(seq) if seq.isdigit() else seq


def _cmd_generate_pointclouds(args):
    """Batch RGB-D -> cloud-file export (generate_pointcloud.py and
    util/generate_pointclouds.m:1-47: same assoc manifest walk, depth
    scale from the per-camera registry, PLY/PCD output)."""
    import os

    from cvo_rgbd_tpu.frontend.camera import get_camera
    from cvo_rgbd_tpu.io.export import depth_to_cloud, write_pcd, write_ply
    from cvo_rgbd_tpu.io.tum import load_assoc
    from cvo_rgbd_tpu.odometry import load_image_pair

    cam = get_camera(_seq_key(args.seq))
    entries = load_assoc(os.path.join(args.folder, "assoc.txt"))
    if args.max_frames is not None:
        entries = entries[: args.max_frames]
    os.makedirs(args.out, exist_ok=True)
    write = write_ply if args.format == "ply" else write_pcd
    for e in entries:
        rgb, dep = load_image_pair(args.folder, e)
        pos, col = depth_to_cloud(rgb, dep, cam, stride=args.stride)
        write(os.path.join(args.out, f"{e.name}.{args.format}"), pos, col)
    print(f"{len(entries)} clouds -> {args.out}")


def _cmd_registered_cloud(args):
    """World-frame scene export along a trajectory
    (generate_registered_pointcloud.py: associate frame timestamps to
    trajectory poses, backproject, transform, merge)."""
    import os

    from cvo_rgbd_tpu.evaluation.associate import associate
    from cvo_rgbd_tpu.frontend.camera import get_camera
    from cvo_rgbd_tpu.io.export import merge_clouds, write_ply
    from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_tpu.odometry import load_image_pair
    from cvo_rgbd_tpu.visualize import export_registered_clouds

    cam = get_camera(_seq_key(args.seq))
    entries = {float(e.name): e for e in
               load_assoc(os.path.join(args.folder, "assoc.txt"))}
    traj = read_trajectory(args.trajectory)
    matches = associate(entries, traj, 0.0, args.max_difference)
    if not matches:
        raise SystemExit("no frame matches the trajectory timestamps")
    # stride first, THEN the frame cap, so --max-frames K --frame-stride S
    # exports K frames spaced S apart (not K/S frames)
    matches = matches[:: args.frame_stride]
    if args.max_frames is not None:
        matches = matches[: args.max_frames]
    frames = []
    for ft, tt in matches:
        rgb, dep = load_image_pair(args.folder, entries[ft])
        frames.append((tt, rgb, dep))
    pos, col = export_registered_clouds(frames, traj, cam, stride=args.stride)
    if args.downsample > 0:
        pos, col = merge_clouds([(pos, col)], grid=args.downsample)
    write_ply(args.output, pos, col)
    print(f"{pos.shape[0]} points from {len(frames)} frames -> {args.output}")


def _cmd_plot_trajectory(args):
    """Project a trajectory into one frame's image
    (plot_trajectory_into_image.py analog)."""
    import os

    import numpy as np
    from PIL import Image

    from cvo_rgbd_tpu.evaluation.associate import associate
    from cvo_rgbd_tpu.frontend.camera import get_camera
    from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_tpu.odometry import load_image_pair
    from cvo_rgbd_tpu.visualize import draw_trajectory_into_image

    cam = get_camera(_seq_key(args.seq))
    entries = {float(e.name): e for e in
               load_assoc(os.path.join(args.folder, "assoc.txt"))}
    traj = read_trajectory(args.trajectory)
    matches = associate(entries, traj, 0.0, args.max_difference)
    if not matches:
        raise SystemExit("no frame matches the trajectory timestamps")
    if args.frame < 0:
        raise SystemExit(f"--frame must be >= 0 (got {args.frame})")
    if args.frame >= len(matches):
        print(
            f"--frame {args.frame} out of range; using last matched "
            f"frame {len(matches) - 1}"
        )
    ft, tt = matches[min(args.frame, len(matches) - 1)]
    rgb, _ = load_image_pair(args.folder, entries[ft])
    img = draw_trajectory_into_image(
        np.asarray(rgb), cam, traj[tt], traj, radius=args.radius
    )
    Image.fromarray(img).save(args.output)
    print(f"frame {entries[ft].name} + {len(traj)} poses -> {args.output}")


def _cmd_ate(args):
    from cvo_rgbd_tpu.evaluation import ate_rmse
    from cvo_rgbd_tpu.io.tum import read_trajectory

    stats = ate_rmse(
        read_trajectory(args.groundtruth),
        read_trajectory(args.estimate),
        max_difference=args.max_difference,
    )
    if args.verbose:
        print(json.dumps(stats, indent=2))
    else:
        print(f"{stats['rmse']:.6f}")


def _cmd_rpe(args):
    from cvo_rgbd_tpu.evaluation import rpe
    from cvo_rgbd_tpu.io.tum import read_trajectory

    stats = rpe(
        read_trajectory(args.groundtruth),
        read_trajectory(args.estimate),
        delta=args.delta,
        delta_unit=args.delta_unit,
        fixed_delta=True,
    )
    print(json.dumps(stats, indent=2))


def _cmd_associate(args):
    from cvo_rgbd_tpu.evaluation.associate import associate, read_file_list

    first = read_file_list(args.first)
    second = read_file_list(args.second)
    for a, b in associate(first, second, args.offset, args.max_difference):
        print(f"{a:f} {' '.join(first[a])} {b:f} {' '.join(second[b])}")


def main(argv=None):
    from cvo_rgbd_tpu.params import BACKENDS
    from cvo_rgbd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="cvo_rgbd_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run odometry on a TUM-format folder")
    pr.add_argument("folder")
    pr.add_argument("seq", help="camera key: 0..5 or realsense/fr1/fr2/fr3/kitti15/kitti05")
    pr.add_argument("--adaptive", action="store_true")
    pr.add_argument("--output")
    pr.add_argument("--max-frames", type=int)
    pr.add_argument("--checkpoint")
    pr.add_argument("--num-want", type=int, default=3000)
    pr.add_argument("--matlab-tol", action="store_true",
                    help="MATLAB stop set (eps=5e-4/1e-4): ~half the "
                    "iterations of the C++ default 5e-5/1e-5 at a "
                    "~1 mm pose delta (PERF.md)")
    pr.add_argument("--eps", type=float, help="flow-norm stop override")
    pr.add_argument("--eps-2", type=float, dest="eps_2",
                    help="se3-distance stop override")
    pr.add_argument("--backend", default="xla", choices=BACKENDS)
    pr.add_argument("--no-native-io", action="store_true",
                    help="disable the C++ prefetch loader")
    pr.add_argument("--batch", type=int, default=1,
                    help="register this many pairs per device step (offline mode)")
    pr.add_argument("--cold-start", action="store_true",
                    help="start every pair from identity at ell_init "
                    "instead of the reference's across-pair R/T/ell "
                    "warm start (cvo.cpp:43-45, 398-399)")
    pr.add_argument("--profile-dir",
                    help="capture a jax.profiler device trace of the run "
                    "into this directory (view with tensorboard/xprof)")
    pr.add_argument("--fetch-every", type=int, default=8,
                    help="frames between device->host result flushes in "
                    "the sequential driver (trajectory output is "
                    "identical for any value; larger batches the "
                    "device->host transfers, a crash loses up to "
                    "N-1 frames of checkpoint progress)")
    pr.add_argument("--motion-prior", action="store_true",
                    help="with --batch: warm-start each chunk with the "
                    "previous chunk's last relative transform "
                    "(constant-velocity approximation)")
    pr.set_defaults(fn=_cmd_run)

    pm = sub.add_parser(
        "multiseq",
        help="batched odometry over several TUM folders in lockstep "
        "(one device batch registers one pair from every sequence)",
    )
    pm.add_argument("seq", help="camera key shared by all folders")
    pm.add_argument("folders", nargs="+")
    pm.add_argument("--adaptive", action="store_true")
    pm.add_argument("--num-want", type=int, default=3000)
    pm.add_argument("--max-frames", type=int)
    pm.add_argument("--matlab-tol", action="store_true",
                    help="MATLAB stop set (see `run --matlab-tol`)")
    pm.add_argument("--eps", type=float)
    pm.add_argument("--eps-2", type=float, dest="eps_2")
    pm.add_argument("--backend", default="xla", choices=BACKENDS)
    pm.add_argument("--cold-start", action="store_true",
                    help="disable the per-lane across-pair warm start")
    pm.set_defaults(fn=_cmd_multiseq)

    pb = sub.add_parser("batch", help="pairwise registration over a pcd dir")
    pb.add_argument("directory")
    pb.add_argument("--grid", type=float, default=0.05)
    pb.add_argument("--output")
    pb.set_defaults(fn=_cmd_batch)

    pst = sub.add_parser("stitch", help="register + merge a pcd dir into a PLY scene")
    pst.add_argument("directory")
    pst.add_argument("--output", default="scene.ply")
    pst.add_argument("--grid", type=float, default=0.05)
    pst.add_argument("--merge-grid", type=float, default=0.01)
    pst.set_defaults(fn=_cmd_stitch)

    psl = sub.add_parser(
        "slam", help="keyframe SLAM (loop closure + pose graph) over a pcd dir"
    )
    psl.add_argument("directory")
    psl.add_argument("--output", default="slam_poses_qt.txt")
    psl.add_argument("--grid", type=float, default=0.05)
    psl.add_argument("--refine", action="store_true",
                     help="bundle-adjust the keyframe map after the pose graph")
    psl.set_defaults(fn=_cmd_slam)

    pg = sub.add_parser(
        "generate-pointclouds",
        help="export every assoc.txt frame as a .pcd/.ply cloud",
    )
    pg.add_argument("folder")
    pg.add_argument("seq", help="camera key (intrinsics + depth scale)")
    pg.add_argument("--out", default="pcd_full")
    pg.add_argument("--format", default="pcd", choices=["pcd", "ply"])
    pg.add_argument("--stride", type=int, default=1,
                    help="pixel subsampling stride")
    pg.add_argument("--max-frames", type=int)
    pg.set_defaults(fn=_cmd_generate_pointclouds)

    prc = sub.add_parser(
        "registered-cloud",
        help="merge frames along a trajectory into one world-frame PLY",
    )
    prc.add_argument("folder")
    prc.add_argument("seq")
    prc.add_argument("trajectory", help="TUM-format pose file")
    prc.add_argument("--output", default="registered.ply")
    prc.add_argument("--stride", type=int, default=4,
                     help="pixel subsampling stride per frame")
    prc.add_argument("--frame-stride", type=int, default=1)
    prc.add_argument("--max-frames", type=int)
    prc.add_argument("--downsample", type=float, default=0.0,
                     help="grid size for a final merge downsample (m)")
    prc.add_argument("--max-difference", type=float, default=0.02)
    prc.set_defaults(fn=_cmd_registered_cloud)

    ppt = sub.add_parser(
        "plot-trajectory",
        help="project a trajectory into one frame's image (png)",
    )
    ppt.add_argument("folder")
    ppt.add_argument("seq")
    ppt.add_argument("trajectory")
    ppt.add_argument("--output", default="trajectory.png")
    ppt.add_argument("--frame", type=int, default=0,
                     help="index of the matched frame to draw into")
    ppt.add_argument("--radius", type=int, default=2)
    ppt.add_argument("--max-difference", type=float, default=0.02)
    ppt.set_defaults(fn=_cmd_plot_trajectory)

    pa = sub.add_parser("evaluate-ate", help="ATE RMSE of a trajectory")
    pa.add_argument("groundtruth")
    pa.add_argument("estimate")
    pa.add_argument("--max-difference", type=float, default=0.02)
    pa.add_argument("--verbose", action="store_true")
    pa.set_defaults(fn=_cmd_ate)

    pp = sub.add_parser("evaluate-rpe", help="RPE of a trajectory")
    pp.add_argument("groundtruth")
    pp.add_argument("estimate")
    pp.add_argument("--delta", type=float, default=1.0)
    pp.add_argument("--delta-unit", default="s", choices=["s", "m", "rad", "deg", "f"])
    pp.set_defaults(fn=_cmd_rpe)

    ps = sub.add_parser("associate", help="match rgb.txt and depth.txt timestamps")
    ps.add_argument("first")
    ps.add_argument("second")
    ps.add_argument("--offset", type=float, default=0.0)
    ps.add_argument("--max-difference", type=float, default=0.02)
    ps.set_defaults(fn=_cmd_associate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
