"""Benchmark: frames/s registering the vendored fr1/desk fixture pairs.

Protocol mirrors the stored MATLAB batch run whose per-pair
registration_time array is the minted baseline
(data/rgbd_dataset/freiburg1_desk/freiburg1_desk_07-May-2019-02-35-00.mat,
written by rgbddataset_rkhs.m:62-88): same clouds, same preprocessing
(range filter [0.8, 4] m + 0.05 grid downsample, rgbddataset_rkhs.m:40-47),
same dense-kernel algorithm (MATLAB parameter set).

Prints ONE JSON line:
  {"metric": ..., "value": fps, "unit": "frames/s", "vs_baseline": x}
vs_baseline is the speedup over the MATLAB CPU mean of 7.954 s/pair.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

MATLAB_MEAN_S_PER_PAIR = 7.953976  # mean of the stored registration_time
DS = "/root/reference/data/rgbd_dataset/freiburg1_desk"
STAMPS = [
    "1305031453.359684",
    "1305031453.391690",
    "1305031453.423683",
    "1305031453.459685",
    "1305031453.491698",
]


def load_clouds():
    from cvo_rgbd_tpu import pad_cloud
    from cvo_rgbd_tpu.io import read_pcd
    from cvo_rgbd_tpu.utils import grid_downsample, range_filter

    raw = []
    for t in STAMPS:
        d = read_pcd(f"{DS}/pcd_ds/{t}.pcd")
        pos, col = range_filter(d["positions"], d["colors"])
        pos, col = grid_downsample(pos, col, 0.05)
        raw.append((pos, col * 255.0))  # MATLAB Color is uint8-scaled
    cap = 128 * ((max(p.shape[0] for p, _ in raw) + 127) // 128)
    return [pad_cloud(p, c, capacity=cap) for p, c in raw]


def synth_reference_scale(n_pairs=64, n_points=3000, cap=3072, seed=7,
                          hsv_scale=False):
    """DISTINCT pairs at the reference workload shape (num_want=3000,
    pcd_generator.cpp:22) with EXACT known ground truth, synthesized
    from the vendored fixture clouds (disclosed):

    - each pair takes a CONSECUTIVE fixture pair (real frame-to-frame
      camera motion) and samples n_points REAL points from each frame's
      raw pcd_ds cloud (~16k points) without replacement — no synthetic
      jitter (round 2 added independent 1.5 mm resampling noise, which
      put a floor under the flow norms and pushed 59/64 lanes into the
      iteration cap; real surface points behave like the real
      workload);
    - the moving cloud is displaced by a known random small SE(3) `E`,
      so the true registration is stored_matlab_relpose @ inv(E) (the
      stored MATLAB transforms agree with our own registration of the
      same pairs to 2.8-4.3 mm — docs/PARITY.md — and anchor the truth
      to real camera motion);
    - features are the real colors plus two smooth position-dependent
      gradient channels (5-dim, cvo.cpp feature layout); `hsv_scale`
      normalizes them to [0,1] (the acvo feature_type-0 scale,
      adaptive_cvo.cpp:451 — its color length-scale c_ell=0.5 expects
      unit-range features).

    Returns (fixed, moving, truth [n_pairs,4,4])."""
    from cvo_rgbd_tpu import pad_cloud, se3
    from cvo_rgbd_tpu.io import read_pcd, read_stored_run
    from cvo_rgbd_tpu.utils import range_filter

    rng = np.random.default_rng(seed)
    raw = []
    for t in STAMPS:
        d = read_pcd(f"{DS}/pcd_ds/{t}.pcd")
        pos, col = range_filter(d["positions"], d["colors"])
        raw.append((pos, col * 255.0))

    def sample(pos, col):
        idx = rng.choice(pos.shape[0], n_points, replace=False)
        p = pos[idx].astype(np.float32)
        c = col[idx]
        dx = 30 + 25 * np.sin(4 * p[:, 0] + 2 * p[:, 1])
        dy = 30 + 25 * np.cos(3 * p[:, 2] + 2 * p[:, 0])
        feat = np.concatenate([c, dx[:, None], dy[:, None]], 1)
        if hsv_scale:
            feat = feat / 255.0
        return p, feat.astype(np.float32)

    stored = read_stored_run(f"{DS}/freiburg1_desk_07-May-2019-02-35-00.mat")
    fixed, moving, truth = [], [], []
    for k in range(n_pairs):
        pi = k % (len(raw) - 1)
        fp, ff = sample(*raw[pi])
        mp, mf = sample(*raw[pi + 1])
        axis = rng.normal(size=3)
        axis *= rng.uniform(0.002, 0.008) / np.linalg.norm(axis)
        R = np.asarray(se3.exp_so3(axis.astype(np.float32)), np.float64)
        t = rng.uniform(-0.008, 0.008, 3)
        mp = (mp @ R.T + t).astype(np.float32)
        E = np.eye(4)
        E[:3, :3] = R
        E[:3, 3] = t
        truth.append(stored.pair_transform(pi) @ np.linalg.inv(E))
        fixed.append(pad_cloud(fp, ff, capacity=cap))
        moving.append(pad_cloud(mp, mf, capacity=cap))
    return fixed, moving, np.stack(truth)


def _per_iteration_slope(params, fixed, moving, b8=8, lo=10, hi=60):
    """ms/align-iteration as the slope between two fixed iteration
    counts (tolerances zeroed so every lane runs exactly max_iter), over
    a batch of 8 pairs."""
    import dataclasses
    import functools

    import jax

    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.core.registration import align

    fb8 = stack_clouds(fixed[:b8])
    mb8 = stack_clouds(moving[:b8])
    slope_times = {}
    for it in (lo, hi):
        pi = dataclasses.replace(params, eps=0.0, eps_2=0.0, max_iter=it)
        f2 = jax.jit(jax.vmap(functools.partial(align, pi)))
        jax.block_until_ready(f2(fb8, mb8).tf)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f2(fb8, mb8).tf)
            ts.append(time.perf_counter() - t0)
        # min, not median: host-side dispatch noise is positive-only;
        # the fastest run is the one closest to pure device time
        slope_times[it] = float(np.min(ts))
    return (slope_times[hi] - slope_times[lo]) / (hi - lo) / b8


def _pose_errors(tfs, truth):
    """(translation mm [B], rotation mrad [B]) vs the known truth.

    The angle comes from the antisymmetric part of R_est R_truth^T
    (||skew||/2 = sin(theta)) — well-conditioned for the sub-mrad
    errors here, where acos(trace) collapses to exactly 0 in fp32."""
    tfs = np.asarray(tfs, np.float64)
    terr = np.linalg.norm(tfs[:, :3, 3] - truth[:, :3, 3], axis=1) * 1e3
    Rd = np.einsum("bij,bkj->bik", tfs[:, :3, :3], truth[:, :3, :3])
    skew = 0.5 * np.stack([
        Rd[:, 2, 1] - Rd[:, 1, 2],
        Rd[:, 0, 2] - Rd[:, 2, 0],
        Rd[:, 1, 0] - Rd[:, 0, 1],
    ], axis=1)
    ang = np.arcsin(np.clip(np.linalg.norm(skew, axis=1), 0.0, 1.0)) * 1e3
    return terr, ang


def bench_reference_scale():
    """Reference-workload benchmark: N=M=3072, 64 distinct pairs with
    exact known ground truth, single-pass moment-kernel backend, BOTH
    variants (cvo and acvo); reports fps, convergence, pose error vs
    truth and ms/iteration (fixed-iteration slope).

    The HEADLINE blocks run the MATLAB stopping set (eps=5e-4,
    eps_2=1e-4, rkhs_se3_registration.m:18-19) for round-over-round
    comparability; the difference-form flow epilogues
    (core/flow.py) make the C++ shipped stops (5e-5/1e-5) reachable in
    fp32, and the `ref_tolerance` block below measures exactly that —
    including the pose delta the MATLAB override costs (median
    sub-mm), which is what justifies keeping it in the long sequence
    benches where the ~2x iteration count would dominate wall time."""
    import dataclasses
    import functools

    import jax

    from cvo_rgbd_tpu import CvoParams
    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.core.registration import align
    from cvo_rgbd_tpu.params import AcvoParams

    out = {}
    for tag, make_params, hsv in (
        ("cvo", lambda: CvoParams(backend="pallas", max_iter=200,
                                  eps=5e-4, eps_2=1e-4), False),
        ("acvo", lambda: AcvoParams(backend="pallas", max_iter=200,
                                    eps=5e-4, eps_2=1e-4), True),
    ):
        fixed, moving, truth = synth_reference_scale(hsv_scale=hsv)
        fb, mb = stack_clouds(fixed), stack_clouds(moving)
        n_pairs = len(fixed)
        p = make_params()

        fn = jax.jit(jax.vmap(functools.partial(align, p)))
        res = fn(fb, mb)
        jax.block_until_ready(res.tf)  # compile + warmup
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(fb, mb).tf)
            times.append(time.perf_counter() - t0)
        per_pair = float(np.median(times)) / n_pairs
        iters = np.asarray(res.iterations)
        terr, rerr = _pose_errors(res.tf, truth)
        per_iter = _per_iteration_slope(p, fixed, moving)

        block = {
            "n": 3072,
            "pairs": n_pairs,
            "fps": round(1.0 / per_pair, 1),
            "ms_per_pair": round(per_pair * 1e3, 3),
            "ms_per_iteration": round(per_iter * 1e3, 4),
            "mean_iterations": round(float(np.mean(iters)), 1),
            "max_iterations": int(np.max(iters)),
            "converged": int(np.sum(np.asarray(res.converged))),
            "pose_err_vs_truth": {
                "median_translation_mm": round(float(np.median(terr)), 2),
                "max_translation_mm": round(float(np.max(terr)), 2),
                "median_rotation_mrad": round(float(np.median(rerr)), 2),
                "max_rotation_mrad": round(float(np.max(rerr)), 2),
            },
        }
        if tag == "acvo":
            # the opt-in Chebyshev self-sweep tables (params.self_mode)
            # collapse the acvo-over-cvo per-iteration cost; measured
            # alongside so the artifact carries both configurations
            p_cheb = dataclasses.replace(p, self_mode="cheb")
            block["ms_per_iteration_cheb"] = round(
                _per_iteration_slope(p_cheb, fixed, moving) * 1e3, 4
            )
        out[tag] = block
    out["mode"] = (
        "64 distinct pairs of real fixture surface points (3000 sampled "
        "per frame from the raw pcd_ds clouds, consecutive-frame motion "
        "+ known injected SE(3); truth anchored to the stored MATLAB "
        "transforms — see synth_reference_scale), MATLAB stopping "
        "tolerances (disclosed in bench_reference_scale), single-pass "
        "moment-kernel backend, batch-64 vmap"
    )

    # --- convergence at the reference's OWN shipped tolerances -------
    # eps=5e-5, eps_2=1e-5 (cvo.cpp:40-41).  The
    # difference-form flow epilogues (core/flow.py, core/moments.py)
    # push the fp32 flow noise floor to ~1e-8 at N=3072, so the same 64
    # pairs now converge at the C++ stops — the float64 oracle needs 66
    # iterations on this workload, fp32 lands within a few of that.
    rt = {"eps": 5e-5, "eps_2": 1e-5}
    for tag, make_params, hsv in (
        ("cvo", lambda: CvoParams(backend="pallas", max_iter=400), False),
        ("acvo", lambda: AcvoParams(backend="pallas", max_iter=400), True),
    ):
        fixed, moving, truth = synth_reference_scale(hsv_scale=hsv)
        fb, mb = stack_clouds(fixed), stack_clouds(moving)
        p = make_params()  # C++ defaults: eps=5e-5, eps_2=1e-5
        fn = jax.jit(jax.vmap(functools.partial(align, p)))
        res = fn(fb, mb)
        jax.block_until_ready(res.tf)
        t0 = time.perf_counter()
        res = fn(fb, mb)
        jax.block_until_ready(res.tf)
        dt = time.perf_counter() - t0
        iters = np.asarray(res.iterations)
        terr, rerr = _pose_errors(res.tf, truth)
        # pose equivalence of the MATLAB-stop override on the SAME
        # pairs: where the headline blocks (and the sequence benches,
        # for runtime) still use eps=5e-4/1e-4, this measures the pose
        # delta that override actually costs vs the C++ stops
        pm = dataclasses.replace(p, eps=5e-4, eps_2=1e-4)
        res_m = jax.jit(jax.vmap(functools.partial(align, pm)))(fb, mb)
        delta_mm, delta_mrad = _pose_errors(res_m.tf, np.asarray(res.tf,
                                                                 np.float64))
        rt[tag] = {
            "converged": int(np.sum(np.asarray(res.converged))),
            "pairs": len(fixed),
            "mean_iterations": round(float(np.mean(iters)), 1),
            "max_iterations": int(np.max(iters)),
            "median_translation_mm": round(float(np.median(terr)), 2),
            "median_rotation_mrad": round(float(np.median(rerr)), 2),
            "fps": round(len(fixed) / dt, 1),
            "pose_delta_vs_matlab_stop_mm": round(
                float(np.median(delta_mm)), 2),
            "pose_delta_vs_matlab_stop_mrad": round(
                float(np.median(delta_mrad)), 2),
        }
    out["ref_tolerance"] = rt
    return out


def _run_lockstep(fbs, mbs, rounds=3):
    """Time a warm-started lockstep chain over prebuilt per-step lane
    batches; returns (per_pair_s, max-iterations-per-step)."""
    import time as _time

    import jax

    from cvo_rgbd_tpu import MATLAB_PARAMS
    from cvo_rgbd_tpu.parallel import align_batched

    n_steps = len(fbs)
    lanes = int(np.asarray(fbs[0].positions).shape[0])

    def run_chain():
        # warm state STAYS ON DEVICE and each step dispatches
        # asynchronously — the whole chain pipelines behind one host
        # wait instead of a device->host->device transfer per step
        warm = None
        ress = []
        for s in range(n_steps):
            kw = {} if warm is None else dict(
                R0=warm[0], T0=warm[1], ell0=warm[2]
            )
            res = align_batched(MATLAB_PARAMS, fbs[s], mbs[s], **kw)
            warm = (res.R, res.T, res.ell)
            ress.append(res)
        jax.block_until_ready(ress[-1].tf)
        return ress

    ress = run_chain()  # compile + warmup both signatures
    times = []
    for _ in range(rounds):
        t0 = _time.perf_counter()
        ress = run_chain()
        times.append(_time.perf_counter() - t0)
    its = [int(np.max(np.asarray(r.iterations))) for r in ress]
    per_pair = float(np.median(times)) / (lanes * n_steps)
    return per_pair, its


def synth_multiseq_lanes(lanes=64, n_points=768, seed=11):
    """`lanes` DISTINCT 5-frame sequences from the fixture surfaces:
    each lane samples its own n_points real-point subset of every raw
    frame cloud (no two lanes share a sampling), so each lane's 4
    chained pairs are distinct registration problems carrying the real
    inter-frame camera motion.  MATLAB protocol features (colors,
    uint8-scaled).  Returns per-step (fixed_batch, moving_batch)."""
    from cvo_rgbd_tpu import pad_cloud
    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.io import read_pcd
    from cvo_rgbd_tpu.utils import range_filter

    rng = np.random.default_rng(seed)
    raw = []
    for t in STAMPS:
        d = read_pcd(f"{DS}/pcd_ds/{t}.pcd")
        pos, col = range_filter(d["positions"], d["colors"])
        raw.append((pos, col * 255.0))

    # lane l's cloud for frame k: its own subset of frame k's surface
    lane_clouds = []
    for _ in range(lanes):
        frames = []
        for pos, col in raw:
            idx = rng.choice(pos.shape[0], n_points, replace=False)
            frames.append(pad_cloud(
                pos[idx].astype(np.float32), col[idx].astype(np.float32),
                capacity=n_points,
            ))
        lane_clouds.append(frames)

    n_steps = len(raw) - 1
    fbs = [stack_clouds([lc[s] for lc in lane_clouds])
           for s in range(n_steps)]
    mbs = [stack_clouds([lc[s + 1] for lc in lane_clouds])
           for s in range(n_steps)]
    return fbs, mbs


def bench_warm_lockstep(clouds, lanes=64, rounds=3):
    """Production multiseq throughput: `lanes` sequences advance in
    lockstep, each lane warm-started with ITS OWN previous pair's
    converged R/T/ell (the reference's across-pair persistence,
    cvo.cpp:43-45, 398-399 — exactly what multiseq.run_multiseq does).

    Headline = 64 DISTINCT sequences (per-lane fixture-surface
    subsets, synth_multiseq_lanes); the
    replicated-fixture-chain variant is kept as a secondary disclosed
    metric (its lanes are copies, so lockstep convergence is
    unrealistically uniform)."""
    from cvo_rgbd_tpu.core.cloud import stack_clouds

    fbs_d, mbs_d = synth_multiseq_lanes(lanes=lanes)
    per_pair_d, its_d = _run_lockstep(fbs_d, mbs_d, rounds)

    n_steps = len(clouds) - 1
    fbs_r = [stack_clouds([clouds[i]] * lanes) for i in range(n_steps)]
    mbs_r = [stack_clouds([clouds[i + 1]] * lanes) for i in range(n_steps)]
    per_pair_r, its_r = _run_lockstep(fbs_r, mbs_r, rounds)

    return {
        "fps": round(1.0 / per_pair_d, 1),
        "ms_per_pair": round(per_pair_d * 1e3, 3),
        "lanes": lanes,
        "steps": len(fbs_d),
        "max_iterations_per_step": its_d,
        "mode": "lockstep multiseq, per-lane across-pair warm start "
        "(pair 1 cold, pairs 2..4 warm); 64 DISTINCT sequences — one "
        "fixture-surface subset per lane (synth_multiseq_lanes)",
        "replicated_chain_secondary": {
            "fps": round(1.0 / per_pair_r, 1),
            "ms_per_pair": round(per_pair_r * 1e3, 3),
            "max_iterations_per_step": its_r,
            "mode": "lanes replicate the 4-pair fixture chain "
            "(round-2 headline, kept for comparability)",
        },
    }


def bench_sequence(n_frames=100):
    """Sequence-scale driver benchmark: render an
    exact-ground-truth 100-frame revisit sequence (synth.revisit_path —
    the same generator as tests/test_longseq.py), run the production
    odometry drivers end-to-end (frontend -> align -> pose chain ->
    TUM writer), and report trajectory ATE/RPE + frames/s.

    The batched driver registers 16 pairs per dispatch.  MATLAB
    stopping tolerances as in bench_reference_scale."""
    import shutil
    import tempfile

    from cvo_rgbd_tpu import CvoParams
    from cvo_rgbd_tpu.evaluation import ate_rmse
    from cvo_rgbd_tpu.evaluation.rpe import rpe
    from cvo_rgbd_tpu.io.tum import read_trajectory
    from cvo_rgbd_tpu.odometry import run_odometry, run_odometry_batched
    from cvo_rgbd_tpu.synth import make_tum_dataset, revisit_path

    root = tempfile.mkdtemp(prefix="cvo_seq_bench_")
    try:
        make_tum_dataset(root, revisit_path(n_frames, period=33))
        gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
        p = CvoParams(eps=5e-4, eps_2=1e-4)

        t0 = time.perf_counter()
        recs = run_odometry(root, 1, params=p, num_want=1024,
                            log=lambda *a: None)
        dt_seq = time.perf_counter() - t0
        # steady-state rate: the median per-frame time excludes the
        # one-time jit compile the first frame pays and host stalls
        frame_s = float(np.median([x.seconds for x in recs[1:]]))
        est = read_trajectory(os.path.join(root, "cvo_poses_qt.txt"))
        stats = ate_rmse(gt, est)
        r = rpe(gt, est, delta=1.0, delta_unit="s")

        out_b = os.path.join(root, "cvo_batched_qt.txt")
        t0 = time.perf_counter()
        recs_b = run_odometry_batched(root, 1, params=p, num_want=1024,
                                      batch=16, output=out_b,
                                      log=lambda *a: None)
        dt_bat = time.perf_counter() - t0
        # exclude the first flush group's compile from the steady-state
        # rate (the driver drains 4 chunks of 16 pairs per fetch, so the
        # first 64 records share the compile-inflated group time)
        bat_s = float(np.median([x.seconds for x in recs_b[64:]]))
        stats_b = ate_rmse(gt, read_trajectory(out_b))

        n_pairs = n_frames - 1
        return {
            "frames": n_frames,
            "ate_rmse_m": round(stats["rmse"], 4),
            "rpe_trans_rmse_m": round(r["trans_rmse"], 4),
            "rpe_rot_rmse_rad": round(r["rot_rmse"], 4),
            "fps_sequential_warm": round(1.0 / frame_s, 1),
            "wall_s_incl_compile": round(dt_seq, 1),
            "mean_iterations": round(
                float(np.mean([x.iterations for x in recs])), 1
            ),
            "failed_pairs": int(sum(x.failed for x in recs)),
            "batched": {
                "ate_rmse_m": round(stats_b["rmse"], 4),
                # steady-state ALIGN rate (the batched driver fronts all
                # frames first; chunk timing excludes frontend+compile)
                "fps_align_steady": round(1.0 / bat_s, 1),
                "wall_s_incl_compile": round(dt_bat, 1),
                "batch": 16,
            },
            "mode": "100-frame ray-traced revisit sequence "
            "(synth.revisit_path, exact GT), full driver incl. "
            "host frontend + trajectory IO; MATLAB stopping tolerances",
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_sequence_full(n_frames=573, period=33):
    """Full-length validation at the reference's primary-artifact scale:
    cvo_main.cpp:36-66 loops exactly 573 assoc.txt entries to produce
    the fr1/desk trajectory.  This renders a 573-frame exact-GT revisit
    sequence (same generator as bench_sequence / tests/test_longseq.py)
    and drives BOTH production paths end-to-end:

    - warm-started frame-to-frame odometry (the reference's own mode),
      reporting ATE/RPE of the 573-pose trajectory;
    - keyframe SLAM with batched loop-closure search + pose-graph
      solve, reporting raw-vs-solved ATE and the loop-edge count.

    Drift over 572 chained registrations and loop-closure behavior at
    ~17 revisit sweeps is exactly what a 6-frame test cannot see."""
    import shutil
    import tempfile

    from cvo_rgbd_tpu import CvoParams
    from cvo_rgbd_tpu.evaluation import ate_rmse
    from cvo_rgbd_tpu.evaluation.rpe import rpe
    from cvo_rgbd_tpu.frontend import make_frontend
    from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_tpu.keyframes import KeyframePolicy
    from cvo_rgbd_tpu.odometry import load_image_pair, run_odometry
    from cvo_rgbd_tpu.slam import KeyframeSlam, SlamConfig
    from cvo_rgbd_tpu.synth import make_tum_dataset, revisit_path

    root = tempfile.mkdtemp(prefix="cvo_seq573_")
    try:
        make_tum_dataset(root, revisit_path(n_frames, period=period))
        gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
        p = CvoParams(eps=5e-4, eps_2=1e-4)

        t0 = time.perf_counter()
        recs = run_odometry(root, 1, params=p, num_want=1024,
                            log=lambda *a: None)
        dt = time.perf_counter() - t0
        frame_s = float(np.median([x.seconds for x in recs[1:]]))
        est = read_trajectory(os.path.join(root, "cvo_poses_qt.txt"))
        stats = ate_rmse(gt, est)
        r = rpe(gt, est, delta=1.0, delta_unit="s")

        # adaptive variant at the same scale (adaptive_cvo_main.cpp is
        # the other half of the reference product): acvo odometry over
        # the same 573 frames, feature_type-0 frontend
        from cvo_rgbd_tpu import AcvoParams

        pa = AcvoParams(eps=5e-4, eps_2=1e-4)
        out_a = os.path.join(root, "acvo_poses_qt.txt")
        t0 = time.perf_counter()
        recs_a = run_odometry(root, 1, adaptive=True, params=pa,
                              num_want=1024, output=out_a,
                              log=lambda *a: None)
        dt_a = time.perf_counter() - t0
        frame_s_a = float(np.median([x.seconds for x in recs_a[1:]]))
        stats_a = ate_rmse(gt, read_trajectory(out_a))

        entries = load_assoc(os.path.join(root, "assoc.txt"))
        frontend = make_frontend(1, 1024, 1)
        slam = KeyframeSlam(p, SlamConfig(keyframe=KeyframePolicy(max_span=8)))
        t0 = time.perf_counter()
        for i, e in enumerate(entries):
            slam.process(i, frontend(*load_image_pair(root, e)))
        names = [float(e.name) for e in entries]
        raw_stats = ate_rmse(
            gt, {names[i]: slam.frame_poses[i] for i in range(n_frames)}
        )
        solved, kf_nodes = slam.solve()
        dt_slam = time.perf_counter() - t0
        sol_stats = ate_rmse(
            gt, {names[i]: solved[i] for i in range(n_frames)}
        )

        # map refinement: distributed-BA chain (slam -> pose graph ->
        # Schur-complement bundle adjustment) at sequence scale
        kf_idx = [k.index for k in slam.keyframes]
        t0 = time.perf_counter()
        ref = slam.refine_map(kf_poses=np.asarray(kf_nodes), iters=8)
        dt_ba = time.perf_counter() - t0
        ba_block = None
        if ref is not None:
            ba_poses, landmarks, costs = ref
            ba_poses = np.asarray(ba_poses)
            kf_before = ate_rmse(gt, {
                names[i]: np.asarray(kf_nodes)[k]
                for k, i in enumerate(kf_idx)
            })
            kf_after = ate_rmse(gt, {
                names[i]: ba_poses[k] for k, i in enumerate(kf_idx)
            })
            costs = np.asarray(costs)
            ba_block = {
                "landmarks": int(np.asarray(landmarks).shape[0]),
                # the quantity BA optimizes: total squared map
                # residual (landmark vs observed point), before/after
                "map_cost_before": round(float(costs[0]), 4),
                "map_cost_after": round(float(costs[-1]), 4),
                "kf_ate_before_m": round(kf_before["rmse"], 4),
                "kf_ate_after_m": round(kf_after["rmse"], 4),
                "wall_s": round(dt_ba, 1),
                "note": "map consistency improves (the residual BA "
                "minimizes); kf_ate_before/after records the "
                "trajectory effect — the round-5 feature-weighted "
                "association (parallel.ba.ba_from_keyframes, "
                "feature_weight=2.0) pins correspondences to the same "
                "textured spot across views, which on the 80-frame "
                "calibration scene turned BA from ATE-degrading "
                "(sliding bias) to ATE-improving",
            }

        # acvo SLAM at the same scale: the adaptive
        # variant's per-pair ell reset (adaptive_cvo.cpp:475) changes
        # warm-start and loop-closure dynamics; measured with the
        # feature_type-0 frontend (adaptive_cvo.cpp:451) + AcvoParams
        # through the batched-decision driver.
        frontend_a = make_frontend(1, 1024, 0)
        slam_a = KeyframeSlam(
            pa, SlamConfig(keyframe=KeyframePolicy(max_span=8))
        )
        t0 = time.perf_counter()
        buf = []
        for i, e in enumerate(entries):
            buf.append((i, frontend_a(*load_image_pair(root, e))))
            if len(buf) >= 8:
                slam_a.process_batch(buf)
                buf = []
        if buf:
            slam_a.process_batch(buf)
        raw_a2 = ate_rmse(
            gt, {names[i]: slam_a.frame_poses[i] for i in range(n_frames)}
        )
        solved_a, _ = slam_a.solve()
        dt_slam_a = time.perf_counter() - t0
        sol_a = ate_rmse(
            gt, {names[i]: solved_a[i] for i in range(n_frames)}
        )

        # batched-decision SLAM: one device fetch per 8-frame group
        # (slam.process_batch) — poses stay exact per frame, promotion
        # decisions land at group cadence
        slam_b = KeyframeSlam(p, SlamConfig(keyframe=KeyframePolicy(max_span=8)))
        t0 = time.perf_counter()
        buf = []
        for i, e in enumerate(entries):
            buf.append((i, frontend(*load_image_pair(root, e))))
            if len(buf) >= 8:
                slam_b.process_batch(buf)
                buf = []
        if buf:
            slam_b.process_batch(buf)
        raw_b = ate_rmse(
            gt, {names[i]: slam_b.frame_poses[i] for i in range(n_frames)}
        )
        solved_b, _ = slam_b.solve()
        dt_slam_b = time.perf_counter() - t0
        sol_b = ate_rmse(
            gt, {names[i]: solved_b[i] for i in range(n_frames)}
        )

        # ---- FULL reference workload: the same
        # 573-frame trajectory rendered at 320x240 so the selector can
        # deliver num_want=3000 points/frame (pcd_generator.cpp:22),
        # registered at the C++ shipped stops (cvo.cpp:40-41) on the
        # production pallas backend — cvo AND acvo, ATE/RPE/fps.
        from cvo_rgbd_tpu.synth import BandScene

        root_fw = tempfile.mkdtemp(prefix="cvo_seq573_fw_")
        fw_blocks = {}
        try:
            make_tum_dataset(
                root_fw, revisit_path(n_frames, period=period),
                scene=BandScene(h=240, w=320),
            )
            gt_fw = read_trajectory(os.path.join(root_fw, "groundtruth.txt"))
            for tag, adaptive_, p_fw in (
                ("cvo", False, CvoParams(backend="pallas")),
                ("acvo", True, AcvoParams(backend="pallas")),
            ):
                out_fw = os.path.join(root_fw, f"{tag}_poses_qt.txt")
                t0 = time.perf_counter()
                recs_fw = run_odometry(
                    root_fw, 1, adaptive=adaptive_, params=p_fw,
                    num_want=3000, output=out_fw, log=lambda *a: None,
                )
                dt_fw = time.perf_counter() - t0
                est_fw = read_trajectory(out_fw)
                st_fw = ate_rmse(gt_fw, est_fw)
                rp_fw = rpe(gt_fw, est_fw, delta=1.0, delta_unit="s")
                fw_blocks[tag] = {
                    "ate_rmse_m": round(st_fw["rmse"], 4),
                    "rpe_trans_rmse_m": round(rp_fw["trans_rmse"], 4),
                    "rpe_rot_rmse_rad": round(rp_fw["rot_rmse"], 4),
                    "fps_warm": round(1.0 / float(np.median(
                        [x.seconds for x in recs_fw[1:]]
                    )), 1),
                    "wall_s": round(dt_fw, 1),
                    "mean_iterations": round(float(np.mean(
                        [x.iterations for x in recs_fw]
                    )), 1),
                    "failed_pairs": int(sum(x.failed for x in recs_fw)),
                }
            fw_blocks["mode"] = (
                "num_want=3000 (cap 3072, pcd_generator.cpp:22), C++ "
                "shipped stops eps=5e-5/1e-5 (cvo.cpp:40-41), pallas "
                "backend, 320x240 render of the same 573-frame revisit "
                "trajectory"
            )
        finally:
            shutil.rmtree(root_fw, ignore_errors=True)

        return {
            "frames": n_frames,
            "full_workload": fw_blocks,
            "odometry": {
                "ate_rmse_m": round(stats["rmse"], 4),
                "rpe_trans_rmse_m": round(r["trans_rmse"], 4),
                "rpe_rot_rmse_rad": round(r["rot_rmse"], 4),
                "fps_warm": round(1.0 / frame_s, 1),
                "wall_s": round(dt, 1),
                "mean_iterations": round(
                    float(np.mean([x.iterations for x in recs])), 1
                ),
                "failed_pairs": int(sum(x.failed for x in recs)),
            },
            "odometry_acvo": {
                "ate_rmse_m": round(stats_a["rmse"], 4),
                "fps_warm": round(1.0 / frame_s_a, 1),
                "wall_s": round(dt_a, 1),
                "mean_iterations": round(
                    float(np.mean([x.iterations for x in recs_a])), 1
                ),
                "failed_pairs": int(sum(x.failed for x in recs_a)),
            },
            "slam": {
                "keyframes": len(slam.keyframes),
                "loop_edges": len(slam.loop_edges),
                "ate_rmse_raw_m": round(raw_stats["rmse"], 4),
                "ate_rmse_solved_m": round(sol_stats["rmse"], 4),
                "wall_s": round(dt_slam, 1),
                "bundle_adjustment": ba_block,
            },
            "slam_acvo": {
                "keyframes": len(slam_a.keyframes),
                "loop_edges": len(slam_a.loop_edges),
                "ate_rmse_raw_m": round(raw_a2["rmse"], 4),
                "ate_rmse_solved_m": round(sol_a["rmse"], 4),
                "wall_s": round(dt_slam_a, 1),
                "mode": "AcvoParams + feature_type-0 frontend, batched-"
                "decision driver (process_batch, group 8)",
            },
            "slam_batched_decisions": {
                "group": 8,
                "keyframes": len(slam_b.keyframes),
                "loop_edges": len(slam_b.loop_edges),
                "ate_rmse_raw_m": round(raw_b["rmse"], 4),
                "ate_rmse_solved_m": round(sol_b["rmse"], 4),
                "wall_s": round(dt_slam_b, 1),
                "mode": "slam.process_batch: ONE device fetch per "
                "8-frame group (the sequential driver's only blocking "
                "sync is the per-frame promotion decision); poses stay "
                "exact, promotions land at group cadence",
            },
            "mode": "573-frame ray-traced revisit sequence (the "
            "reference's own trajectory length, cvo_main.cpp:36-66), "
            "exact closed-form GT; full production drivers",
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_oracle_traj(n_frames=16, num_want=512):
    """Sequence-scale oracle trajectory parity: the
    production fp32 driver's accumulated trajectory vs an INDEPENDENT
    float64 numpy oracle (tests/oracle.py, a literal dense
    transcription of cvo.cpp:99-308) chained with the same warm-start
    semantics — the cross-implementation redundancy the reference
    itself relies on (SURVEY.md section 4 item 3), at the chain scale
    where fp32 drift would show.  Run at the C++ shipped tolerances."""
    import shutil
    import sys
    import tempfile

    from cvo_rgbd_tpu import CvoParams
    from cvo_rgbd_tpu.frontend import make_frontend
    from cvo_rgbd_tpu.io.tum import load_assoc, read_trajectory
    from cvo_rgbd_tpu.odometry import load_image_pair, run_odometry
    from cvo_rgbd_tpu.synth import make_tum_dataset, revisit_path

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    from oracle import odometry_oracle

    root = tempfile.mkdtemp(prefix="cvo_oracle_traj_")
    try:
        make_tum_dataset(root, revisit_path(n_frames, period=33))
        p = CvoParams(max_iter=300)  # C++ stops: eps=5e-5, eps_2=1e-5
        out = os.path.join(root, "parity.txt")
        run_odometry(root, 1, params=p, num_want=num_want, output=out,
                     log=lambda *a: None)
        est = read_trajectory(out)

        entries = load_assoc(os.path.join(root, "assoc.txt"))
        frontend = make_frontend(1, num_want, 1)
        raw = []
        for e in entries:
            c = frontend(*load_image_pair(root, e))
            m = np.asarray(c.mask) > 0
            raw.append((np.asarray(c.positions)[m],
                        np.asarray(c.features)[m]))
        oracle_poses, oracle_iters = odometry_oracle(raw, p)
        names = [float(e.name) for e in entries]
        errs = [
            float(np.linalg.norm(est[names[i]][:3, 3]
                                 - oracle_poses[i][:3, 3])) * 1e3
            for i in range(n_frames)
        ]
        return {
            "frames": n_frames,
            "oracle_traj_err_mm": round(max(errs), 3),
            "final_err_mm": round(errs[-1], 3),
            "oracle_mean_iters": round(float(np.mean(oracle_iters)), 1),
            "tolerances": "C++ shipped (eps=5e-5, eps_2=1e-5)",
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_degraded(n_frames=100, drop_frame=50):
    """Degraded-sensor sequence: Kinect-model depth
    noise + correlated dropout holes + periodic low-texture frames + one
    TOTAL dropout frame, through the production sequential driver.  The
    failure path must FIRE (failed_pairs = the two pairs touching the
    blind frame) and the run must recover (bounded ATE)."""
    import shutil
    import tempfile

    from cvo_rgbd_tpu import CvoParams
    from cvo_rgbd_tpu.evaluation import ate_rmse
    from cvo_rgbd_tpu.io.tum import read_trajectory
    from cvo_rgbd_tpu.odometry import run_odometry
    from cvo_rgbd_tpu.synth import Degradation, make_tum_dataset, revisit_path

    root = tempfile.mkdtemp(prefix="cvo_degraded_")
    try:
        deg = Degradation(
            depth_noise=2e-3, dropout=0.08,
            low_texture_frames=tuple(range(12, n_frames, 25)),
            drop_frames=(drop_frame,), seed=3,
        )
        make_tum_dataset(root, revisit_path(n_frames, period=33),
                         degrade=deg)
        gt = read_trajectory(os.path.join(root, "groundtruth.txt"))
        p = CvoParams(eps=5e-4, eps_2=1e-4)
        t0 = time.perf_counter()
        recs = run_odometry(root, 1, params=p, num_want=1024,
                            log=lambda *a: None)
        dt = time.perf_counter() - t0
        est = read_trajectory(os.path.join(root, "cvo_poses_qt.txt"))
        stats = ate_rmse(gt, est)
        return {
            "frames": n_frames,
            "failed_pairs": int(sum(r.failed for r in recs)),
            "failed_indices": [r.index for r in recs if r.failed],
            "ate_rmse_m": round(stats["rmse"], 4),
            "mean_iterations": round(
                float(np.mean([r.iterations for r in recs])), 1),
            "wall_s": round(dt, 1),
            "mode": "depth noise sigma=2e-3*z^2, 8% correlated dropout "
            "holes, low-texture frames every 25, total dropout at frame "
            f"{drop_frame} (skip-and-mark must fire on its two pairs)",
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    import jax

    from cvo_rgbd_tpu import MATLAB_PARAMS, align_jit
    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.parallel import align_batched

    from cvo_rgbd_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    clouds = load_clouds()
    pairs = list(zip(clouds[:-1], clouds[1:]))
    # batched mode: the 4 distinct fixture pairs REPLICATED 16x to fill
    # a 64-pair batch (the vmapped XLA while_loop; every lane runs the
    # full align loop, so replication does not reduce per-pair work)
    REPLICATE = 16
    fixed_b = stack_clouds([f for f, _ in pairs], repeat=REPLICATE)
    moving_b = stack_clouds([m for _, m in pairs], repeat=REPLICATE)
    nbatch = len(pairs) * REPLICATE

    # warmup / compile both paths
    for f, m in pairs:
        jax.block_until_ready(align_jit(MATLAB_PARAMS, f, m).tf)
    jax.block_until_ready(align_batched(MATLAB_PARAMS, fixed_b, moving_b).tf)

    # per-call timing with a median statistic (robust to host stalls)
    rounds = 5
    iters = []
    times = []          # sequential per-pair latency
    batched_times = []  # batched per-pair throughput (deployment mode of
                        # the offline odometry driver, run_odometry_batched)
    for _ in range(rounds):
        for f, m in pairs:
            t0 = time.perf_counter()
            res = align_jit(MATLAB_PARAMS, f, m)
            jax.block_until_ready(res.tf)
            times.append(time.perf_counter() - t0)
            iters.append(int(res.iterations))
        t0 = time.perf_counter()
        resb = align_batched(MATLAB_PARAMS, fixed_b, moving_b)
        jax.block_until_ready(resb.tf)
        batched_times.append((time.perf_counter() - t0) / nbatch)

    # pose parity vs the genuine stored MATLAB output: the same .mat the timing baseline comes from stores the 4 fixture-pair
    # transforms; compare what we just registered against them
    from cvo_rgbd_tpu.io import read_stored_run

    stored = read_stored_run(f"{DS}/freiburg1_desk_07-May-2019-02-35-00.mat")
    trans_err_mm, rot_err_mrad = [], []
    for i, (f, m) in enumerate(pairs):
        res = align_jit(MATLAB_PARAMS, f, m)
        R = np.asarray(res.R, np.float64)
        T = np.asarray(res.T, np.float64)
        ours = np.eye(4)
        ours[:3, :3] = R.T
        ours[:3, 3] = -R.T @ T
        ref = stored.pair_transform(i)
        trans_err_mm.append(
            float(np.linalg.norm(ours[:3, 3] - ref[:3, 3])) * 1e3
        )
        dR = ours[:3, :3] @ ref[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        rot_err_mrad.append(float(ang) * 1e3)

    per_pair_seq = float(np.median(times))
    per_pair = float(np.median(batched_times))
    fps = 1.0 / per_pair

    # Full verbose record -> disk; stdout gets compact lines only.  A
    # snapshot prints after EVERY heavy leg so a mid-run kill still
    # leaves a complete parseable line in the tail; the final line
    # supersedes the earlier ones.
    full = {
        "metric": "fr1desk_pair_registration_rate_batched",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps * MATLAB_MEAN_S_PER_PAIR, 2),
        "fps_sequential": round(1.0 / per_pair_seq, 3),
        "fps_batched": round(fps, 3),
        "pose_err_vs_stored_matlab": {
            "max_translation_mm": round(max(trans_err_mm), 2),
            "max_rotation_mrad": round(max(rot_err_mrad), 2),
            "per_pair_translation_mm": [
                round(e, 2) for e in trans_err_mm
            ],
            "per_pair_rotation_mrad": [
                round(e, 2) for e in rot_err_mrad
            ],
        },
        "detail": {
            "mode": "batched XLA align (align_batched, vmapped "
            "while_loop): 4 distinct fixture pairs replicated "
            f"{REPLICATE}x to fill a {nbatch}-pair batch; every "
            "lane runs the full align loop",
            "per_pair_ms_batched": round(per_pair * 1e3, 3),
            "per_pair_ms_sequential": round(per_pair_seq * 1e3, 3),
            "sequential_fps": round(1.0 / per_pair_seq, 3),
            "mean_iterations": round(float(np.mean(iters)), 1),
            "pairs": len(pairs),
            "batch": nbatch,
            "rounds": rounds,
            "device": str(jax.devices()[0]),
            "baseline": "MATLAB CPU mean 7.954 s/pair "
            "(stored registration_time, fr1/desk)",
        },
    }

    def checkpoint():
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "bench_full.json"), "w") as f:
            json.dump(full, f, indent=1)
        print(json.dumps(compact_line(full), separators=(",", ":")),
              flush=True)

    checkpoint()
    warm_lockstep = bench_warm_lockstep(clouds)
    full["fps_multiseq_warm"] = warm_lockstep["fps"]
    full["warm_lockstep"] = warm_lockstep
    checkpoint()
    ref_scale = bench_reference_scale()
    full["ref_tolerance"] = ref_scale.pop("ref_tolerance")
    full["reference_scale"] = ref_scale
    checkpoint()
    full["oracle_traj"] = bench_oracle_traj()
    full["degraded"] = bench_degraded()
    checkpoint()
    full["sequence"] = bench_sequence()
    checkpoint()
    full["sequence_573"] = bench_sequence_full()
    checkpoint()


def compact_line(full):
    """Headline scalars only, guaranteed << 2000 chars; prose and
    per-pair arrays live in bench_full.json.  Tolerates missing
    sections: main() prints a snapshot after every heavy leg so a
    mid-run kill still leaves the driver's stdout tail a complete,
    parseable line with everything measured so far."""

    def _ref(b):
        pe = b["pose_err_vs_truth"]
        out = {
            "fps": b["fps"],
            "ms_it": b["ms_per_iteration"],
            "it": b["mean_iterations"],
            "conv": f'{b["converged"]}/{b["pairs"]}',
            "t_mm": pe["median_translation_mm"],
            "r_mrad": pe["median_rotation_mrad"],
        }
        if "ms_per_iteration_cheb" in b:
            out["ms_it_cheb"] = b["ms_per_iteration_cheb"]
        return out

    c = {
        "metric": full["metric"],
        "value": full.get("value"),
        "unit": full["unit"],
        "vs_baseline": full.get("vs_baseline"),
        "full": "bench_full.json",
    }
    for k in ("fps_sequential", "fps_batched", "fps_multiseq_warm"):
        if k in full:
            c[k] = full[k]
    if "reference_scale" in full:
        rs = full["reference_scale"]
        c["ref_scale"] = {
            "n": rs["cvo"]["n"],
            "pairs": rs["cvo"]["pairs"],
            "cvo": _ref(rs["cvo"]),
            "acvo": _ref(rs["acvo"]),
        }
    if "sequence" in full:
        seq = full["sequence"]
        c["seq100"] = {
            "ate_m": seq["ate_rmse_m"],
            "rpe_t_m": seq["rpe_trans_rmse_m"],
            "fps_seq": seq["fps_sequential_warm"],
            "fps_batch": seq["batched"]["fps_align_steady"],
            "fail": seq["failed_pairs"],
        }
    if "sequence_573" in full:
        s573 = full["sequence_573"]
        c["seq573"] = {
            "odom": {
                "ate_m": s573["odometry"]["ate_rmse_m"],
                "fps": s573["odometry"]["fps_warm"],
                "fail": s573["odometry"]["failed_pairs"],
            },
            "acvo": {
                "ate_m": s573["odometry_acvo"]["ate_rmse_m"],
                "fps": s573["odometry_acvo"]["fps_warm"],
            },
            "slam": {
                "kf": s573["slam"]["keyframes"],
                "loops": s573["slam"]["loop_edges"],
                "raw_m": s573["slam"]["ate_rmse_raw_m"],
                "solved_m": s573["slam"]["ate_rmse_solved_m"],
            },
        }
        fw = s573.get("full_workload") or {}
        if "cvo" in fw:
            c["seq573"]["full3000"] = {
                t: {
                    "ate_m": fw[t]["ate_rmse_m"],
                    "fps": fw[t]["fps_warm"],
                    "it": fw[t]["mean_iterations"],
                    "fail": fw[t]["failed_pairs"],
                }
                for t in ("cvo", "acvo") if t in fw
            }
        ba = s573["slam"].get("bundle_adjustment")
        if ba:
            c["seq573"]["ba"] = {
                "cost0": ba["map_cost_before"],
                "cost1": ba["map_cost_after"],
            }
        if "slam_acvo" in s573:
            sa = s573["slam_acvo"]
            c["seq573"]["slam_acvo"] = {
                "kf": sa["keyframes"], "loops": sa["loop_edges"],
                "raw_m": sa["ate_rmse_raw_m"],
                "solved_m": sa["ate_rmse_solved_m"],
            }
    if "pose_err_vs_stored_matlab" in full:
        c["matlab_parity_max_mm"] = (
            full["pose_err_vs_stored_matlab"]["max_translation_mm"]
        )
    if "ref_tolerance" in full:
        rt = full["ref_tolerance"]
        c["ref_tol"] = {"eps": rt["eps"], "eps_2": rt["eps_2"]}
        for t in ("cvo", "acvo"):
            if t in rt:
                c["ref_tol"][t] = {
                    "conv": f'{rt[t]["converged"]}/{rt[t]["pairs"]}',
                    "it": rt[t]["mean_iterations"],
                    "t_mm": rt[t]["median_translation_mm"],
                }
    if "oracle_traj" in full:
        c["oracle_traj_err_mm"] = full["oracle_traj"]["oracle_traj_err_mm"]
    if "degraded" in full:
        d = full["degraded"]
        c["degraded"] = {"frames": d["frames"], "fail": d["failed_pairs"],
                         "ate_m": d["ate_rmse_m"]}
    return c


if __name__ == "__main__":
    main()
