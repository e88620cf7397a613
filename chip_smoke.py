"""Smoke run of the main path on one NVIDIA GPU, in one process.

    python chip_smoke.py           one card
    python chip_smoke.py --four    four cards: the multi-device paths only

One card: render a TUM-layout sequence from --seed, run the odometry
CLI on it (cvo, then acvo) at num_want=3000 and the C++ stops, check
the numerics canaries at N=M=3072 against the float64 oracle, and
compare the moment kernel with its plain reference and with the XLA
align.  Four cards: the dp-batched and sp-sharded aligns against the
same work on one card.  Every phase raises on failure, so the script
exits non-zero; the last line of a passing run is one JSON object with
the device JAX reports.  Readings printed here are smoke readings,
not benchmark numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cvo_rgbd_tpu import (  # noqa: E402
    MATLAB_PARAMS, AcvoParams, CvoParams, align_jit, pad_cloud,
)
from cvo_rgbd_tpu.utils.compile_cache import (  # noqa: E402
    CacheCounter, enable_compile_cache,
)

CAP = 3072              # cloud capacity at num_want=3000
NUM_WANT = 3000
FRAMES = 12
# The selector delivers 1325-2710 of num_want=3000 on this scene at
# 320x240 (ROADMAP R3); far fewer means the frontend broke.
MIN_POINTS = 1200
PAIR = (10, 11)         # the frames with the most points: the N=M=3072 pair
ATE_BOUND_M = 0.02      # ATE RMSE bound over the short smoke sequence
POSE_TOL = 3e-4         # stop-skew band of poses at the C++ stops
MOM_RTOL = 1e-5         # kernel vs reference: summation order only
LANE_TOL = 1e-3         # 768-point lanes at the C++ stops: 2.8e-4-3.3e-4 seen


def card_line() -> str:
    """The card's name and power limit, read by a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu(devices=None, count=1):
    """Phase 1: the run happens on the GPU or not at all."""
    devices = jax.devices() if devices is None else devices
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found platform {platform!r}, not a GPU; "
            "there is no CPU fallback"
        )
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: need {count} GPUs, JAX found {len(devices)}"
        )
    return devices


def render(root, seed):
    """Phase 2: a TUM-layout sequence at 320x240, the geometry of the
    full-workload sequence leg (bench.py)."""
    from cvo_rgbd_tpu.synth import BandScene, make_tum_dataset, revisit_path

    scene = BandScene(h=240, w=320, texture_seeds=(seed, seed + 1, seed + 2))
    make_tum_dataset(root, revisit_path(FRAMES, period=40), scene=scene)


def frame_clouds(root, feature_type):
    """Every frame's cloud through the production frontend."""
    from cvo_rgbd_tpu.frontend import make_frontend
    from cvo_rgbd_tpu.io.tum import load_assoc
    from cvo_rgbd_tpu.odometry import load_image_pair

    frontend = make_frontend(1, NUM_WANT, feature_type)
    entries = load_assoc(os.path.join(root, "assoc.txt"))
    return [frontend(*load_image_pair(root, e)) for e in entries]


def run_main_path(root, adaptive, card, fetch_every=4):
    """Phase 3: `cvo_rgbd_tpu.cli run` in-process, then ATE against
    the rendered ground truth."""
    from cvo_rgbd_tpu import cli
    from cvo_rgbd_tpu.evaluation import ate_rmse
    from cvo_rgbd_tpu.io.tum import read_trajectory

    tag = "acvo" if adaptive else "cvo"
    out = os.path.join(root, f"{tag}_poses.txt")
    argv = ["run", root, "1", "--num-want", str(NUM_WANT), "--output", out,
            "--fetch-every", str(fetch_every)]
    if adaptive:
        argv.append("--adaptive")
    records = cli.main(argv)
    failed = sum(r.failed for r in records)
    ate = ate_rmse(read_trajectory(os.path.join(root, "groundtruth.txt")),
                   read_trajectory(out))["rmse"]
    warm = records[fetch_every:]
    fps = len(warm) / sum(r.seconds for r in warm) if warm else float("nan")
    iters = float(np.mean([r.iterations for r in records]))
    print(f"[main path] {tag}: {len(records)} pairs, {failed} failed, "
          f"ATE RMSE {ate:.5f} m (bound {ATE_BOUND_M} m), "
          f"mean iterations/pair {iters:.1f}")
    print(f"[main path] {tag} smoke reading (not a benchmark): warm "
          f"{fps:.2f} frames/s over {len(warm)} pairs on {card}")
    if failed:
        raise AssertionError(f"{tag}: {failed} failed pairs")
    if not ate < ATE_BOUND_M:
        raise AssertionError(f"{tag}: ATE {ate} m >= {ATE_BOUND_M} m")
    return dict(ate=ate, fps=fps, iters=iters)


def _known_motion(cloud, seed):
    """Moving cloud = fixed cloud under a small known SE(3)."""
    from cvo_rgbd_tpu import se3

    r = np.random.default_rng(seed)
    R = np.asarray(se3.exp_so3(r.normal(0, 0.01, 3).astype(np.float32)))
    t = r.normal(0, 0.02, 3).astype(np.float32)
    pos = np.asarray(cloud.positions) @ R.T + t
    return cloud._replace(positions=jnp.asarray(pos, jnp.float32)), R, t


def canaries(cloud, seed):
    """Phase 4: self-registration, known-transform recovery against
    the float64 oracle, and an all-masked moving cloud."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle import align_oracle

    for p in (CvoParams(), AcvoParams()):
        res = align_jit(p, cloud, cloud)
        tf = np.asarray(res.tf)
        ok = int(res.iterations) == 0 and np.array_equal(
            tf, np.eye(4, dtype=np.float32))
        print(f"[canary] self-registration {type(p).__name__}: iteration "
              f"{int(res.iterations)}, tf == I exactly: {ok}")
        if not ok:
            raise AssertionError("self-registration moved: a reduced-"
                                 "precision contraction is back")

    p = CvoParams()
    moving, R, t = _known_motion(cloud, seed)
    res = align_jit(p, cloud, moving)
    valid = np.asarray(cloud.mask) > 0
    t0 = time.perf_counter()
    tf_o, it_o = align_oracle(
        np.asarray(cloud.positions)[valid], np.asarray(cloud.features)[valid],
        np.asarray(moving.positions)[valid],
        np.asarray(moving.features)[valid], p,
    )
    d_oracle = float(np.abs(np.asarray(res.tf) - tf_o).max())
    truth = np.eye(4)
    truth[:3, :3], truth[:3, 3] = R.T, -R.T @ t
    d_truth = float(np.abs(np.asarray(res.tf) - truth).max())
    print(f"[canary] known transform N=M={cloud.capacity}: align "
          f"{int(res.iterations)} iterations, oracle {it_o} "
          f"({time.perf_counter() - t0:.0f} s on the host); max|tf - "
          f"oracle| {d_oracle:.2e} (tol {POSE_TOL}), max|tf - truth| "
          f"{d_truth:.2e}")
    if not d_oracle < POSE_TOL:
        raise AssertionError(f"align vs float64 oracle {d_oracle}")

    empty = cloud._replace(mask=jnp.zeros_like(cloud.mask))
    res = align_jit(p, cloud, empty)
    ok = int(res.iterations) == 0 and bool(np.isfinite(res.tf).all())
    print(f"[canary] all-masked moving cloud: iteration "
          f"{int(res.iterations)}, finite tf: {ok}")
    if not ok:
        raise AssertionError("all-masked moving cloud")


def kernel_vs_reference(fixed, moving, p, ell, label):
    """Moment kernel (Mom, nnz, wsq) against the plain jnp reference,
    on the kd-sorted clouds the align hands the kernel."""
    from cvo_rgbd_tpu.core.registration import build_moments_pre, kernel_order
    from cvo_rgbd_tpu.ops import fused_moments, fused_wsq
    from cvo_rgbd_tpu.ops.moment_kernel import reference_moments

    kp = dataclasses.replace(p, backend="pallas")
    fixed, moving = kernel_order(kp, fixed), kernel_order(kp, moving)
    c0, x_c, phi = build_moments_pre(kp, fixed)
    args = (x_c, fixed.features, fixed.mask,
            moving.positions - c0, moving.features, moving.mask)
    mom, nnz = fused_moments(*args, phi, ell, p=kp)
    wsq, nnz2 = fused_wsq(*args, ell, p=kp)
    r_mom, r_nnz, r_wsq = reference_moments(*args, ell, p=p)
    mom, r_mom = np.asarray(mom), np.asarray(r_mom)
    rel = float(np.abs(mom - r_mom).max() / np.abs(r_mom).max())
    wrel = float(abs(float(wsq) - float(r_wsq)) / abs(float(r_wsq)))
    print(f"[kernel] {label}: nnz {int(nnz)} / reference {int(r_nnz)} "
          f"(wsq sweep {int(nnz2)}), Mom max rel err {rel:.2e}, wsq rel "
          f"err {wrel:.2e} (tol {MOM_RTOL}, fp32 summation order)")
    if not (float(nnz) == float(r_nnz) == float(nnz2)):
        raise AssertionError(f"{label}: nnz differs")
    if not (rel < MOM_RTOL and wrel < MOM_RTOL):
        raise AssertionError(f"{label}: moments differ")
    ker = _sweep_ms(lambda e: fused_moments(*args, phi, e, p=kp)[0], ell)
    ref = _sweep_ms(lambda e: reference_moments(*args, e, p=p)[0], ell)
    return ker, ref, _kept_tiles(args, ell, kp)


def _kept_tiles(args, ell, p):
    """Share of tile pairs the AABB skip keeps for this sweep."""
    from cvo_rgbd_tpu.ops import moment_kernel as mk

    n_pad, m_pad, _, sc, xs, ys, (md,) = mk._prepare(*args, ell, p)
    return float(jnp.mean(md <= sc[4] + mk.SKIP_MARGIN))


def _sweep_ms(sweep, ell, lo=10, hi=40):
    """Device ms of one sweep: `lo` and `hi` chained sweeps, each in one
    dispatch (every sweep's ell depends on the last one's output), and
    the slope between them, so dispatch and sync drop out."""
    def chained(k):
        def body(e, _):
            return e + 1e-12 * sweep(e)[0, 0], None

        return jax.jit(lambda e: jax.lax.scan(body, e, None, length=k)[0])

    times = {}
    for k in (lo, hi):
        fn = chained(k)
        e0 = jnp.float32(ell)
        jax.block_until_ready(fn(e0))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(e0))
            ts.append(time.perf_counter() - t0)
        times[k] = float(np.median(ts))
    return (times[hi] - times[lo]) / (hi - lo) * 1e3


def time_align(p, fixed, moving, repeats=3):
    """(ms per iteration, iterations, tf) of one align, median of
    `repeats` warm runs; compilation happens before."""
    res = align_jit(p, fixed, moving)
    jax.block_until_ready(res)
    per, iters = [], 0
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = jax.block_until_ready(align_jit(p, fixed, moving))
        iters = int(res.iterations) + 1
        per.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(per)), iters, np.asarray(res.tf)


def kernel_phase(clouds_cvo, clouds_acvo, card, seed):
    """Phase 5: the moment kernel against its reference at N=M=3072
    and at the MATLAB-protocol size, then align per iteration, XLA
    against the kernel, at N=M=3072."""
    i, j = PAIR
    for tag, p, clouds, ell in (("cvo", CvoParams(), clouds_cvo, 0.05),
                                ("acvo", AcvoParams(), clouds_acvo, 0.08)):
        ker, ref, kept = kernel_vs_reference(clouds[i], clouds[j], p, ell,
                                             f"{tag} N=M={CAP}")
        print(f"[kernel] {tag} one moment sweep N=M={CAP} at ell={ell} "
              f"on {card}: kernel {ker:.4f} ms ({kept:.3f} of tiles "
              f"kept), plain XLA (Gram + A^T Phi) {ref:.4f} ms "
              f"(slope of chained sweeps)")
    r = np.random.default_rng(seed)
    small = []
    for c in (clouds_cvo[i], clouds_cvo[j]):
        idx = np.nonzero(np.asarray(c.mask) > 0)[0]
        pick = np.sort(r.choice(idx, 760, replace=False))
        small.append(pad_cloud(np.asarray(c.positions)[pick],
                               np.asarray(c.features)[pick, :3] * 255.0,
                               capacity=768))
    kernel_vs_reference(small[0], small[1], MATLAB_PARAMS, 0.1,
                        "MATLAB protocol N=M=768 (linear)")

    readings = {}
    for tag, base, clouds in (("cvo", CvoParams(), clouds_cvo),
                              ("acvo", AcvoParams(), clouds_acvo)):
        fixed, moving = clouds[i], clouds[j]
        runs = {}
        for backend in ("xla", "pallas", "pallas", "xla"):
            p = dataclasses.replace(base, backend=backend)
            ms, iters, tf = time_align(p, fixed, moving)
            runs.setdefault(backend, []).append((ms, iters, tf))
        xla_ms = float(np.mean([x[0] for x in runs["xla"]]))
        ker_ms = float(np.mean([x[0] for x in runs["pallas"]]))
        d = float(np.abs(runs["pallas"][0][2] - runs["xla"][0][2]).max())
        print(f"[kernel] {tag} align N=M={CAP} on {card}: xla "
              f"{xla_ms:.4f} ms/iter ({runs['xla'][0][1]} iters), moment "
              f"kernel {ker_ms:.4f} ms/iter ({runs['pallas'][0][1]} "
              f"iters), speedup {xla_ms / ker_ms:.3f}x; max|tf_kernel - "
              f"tf_xla| {d:.2e} (tol {POSE_TOL})")
        if not d < POSE_TOL:
            raise AssertionError(f"{tag}: kernel pose vs xla {d}")
        readings[tag] = (xla_ms, ker_ms)
    return readings


def four_card_phase(devices, clouds, seed, lanes=64, points=768,
                    sharded_cloud_pair=None):
    """--four: dp-batched align over 64 lanes and sp-sharded align at
    N=M=3072, each against the same work on one card."""
    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.parallel import align_batched, align_sharded, make_mesh

    r = np.random.default_rng(seed)
    fixed_l, moving_l = [], []
    for k in range(lanes):
        i = k % (len(clouds) - 1)
        for c, out in ((clouds[i], fixed_l), (clouds[i + 1], moving_l)):
            idx = np.nonzero(np.asarray(c.mask) > 0)[0]
            pick = np.sort(r.choice(idx, min(points - 8, idx.size),
                                    replace=False))
            out.append(pad_cloud(np.asarray(c.positions)[pick],
                                 np.asarray(c.features)[pick],
                                 capacity=points))
    fb, mb = stack_clouds(fixed_l), stack_clouds(moving_l)
    p = CvoParams()
    mesh = make_mesh({"dp": 4}, devices=devices[:4])
    # the sharded program reduces in another order than the one-card
    # program, and the C++ stops turn rounding into stop skew; the
    # one-card repeat shows the card's own run-to-run spread
    t0 = time.perf_counter()
    dp = jax.block_until_ready(align_batched(p, fb, mb, mesh=mesh))
    dt = time.perf_counter() - t0
    one = np.asarray(align_batched(p, fb, mb).tf)
    repeat = np.asarray(align_batched(p, fb, mb).tf)
    on = dp.tf.sharding.device_set
    d = float(np.abs(np.asarray(dp.tf) - one).max())
    d_rep = float(np.abs(repeat - one).max())
    print(f"[four] align_batched dp=4, {lanes} lanes x {points} points: on "
          f"{len(on)} devices {sorted(x.id for x in on)}; max|tf_dp4 - "
          f"tf_one| {d:.2e} (tol {LANE_TOL}); one card run twice "
          f"{d_rep:.2e}; first call {dt:.2f} s")
    if len(on) != 4:
        raise AssertionError("dp result does not come from four devices")
    if not d < LANE_TOL:
        raise AssertionError(f"dp=4 vs one card {d}")

    fixed, moving = sharded_cloud_pair or (clouds[PAIR[0]], clouds[PAIR[1]])
    mesh = make_mesh({"sp": 4}, devices=devices[:4])
    ref = align_jit(p, fixed, moving)
    sp = jax.jit(functools.partial(align_sharded, p, mesh))(fixed, moving)
    sp = jax.block_until_ready(sp)
    on = sp.tf.sharding.device_set
    d = float(np.abs(np.asarray(sp.tf) - np.asarray(ref.tf)).max())
    print(f"[four] align_sharded sp=4 N=M={fixed.capacity}: on {len(on)} "
          f"devices, {int(sp.iterations)} iters (one card "
          f"{int(ref.iterations)}); max|tf_sp4 - tf_one| {d:.2e} "
          f"(tol {POSE_TOL})")
    if len(on) != 4:
        raise AssertionError("sp result does not come from four devices")
    if not d < POSE_TOL:
        raise AssertionError(f"sp=4 vs one card {d}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)

    count = 4 if args.four else 1
    devices = require_gpu(count=count)
    cache_dir = enable_compile_cache()
    cache = CacheCounter()
    card = card_line()
    dev = devices[0]
    print(f"[device] {dev.platform} {dev.device_kind} x{len(devices)}, "
          f"jax {jax.__version__}")
    print(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"[device] compile cache {cache_dir}")
    print(f"[device] card (name, power limit): {card}")

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        render(root, args.seed)
        from cvo_rgbd_tpu import native

        print(f"[data] {FRAMES} frames 320x240 rendered, seed "
              f"{args.seed}; PNG decoder: "
              f"{'native' if native.get_lib() is not None else 'numpy'}"
              f" ({native.build_error() or 'built'})")
        clouds_cvo = frame_clouds(root, 1)
        if args.four:
            four_card_phase(devices, clouds_cvo, args.seed)
        else:
            clouds_acvo = frame_clouds(root, 0)
            pts = [int(np.asarray(c.mask).sum())
                   for c in clouds_cvo + clouds_acvo]
            print(f"[data] valid points per frame (capacity "
                  f"{clouds_cvo[0].capacity}): min {min(pts)}, max "
                  f"{max(pts)} (need >= {MIN_POINTS}); N=M={CAP} pair "
                  f"{[pts[k] for k in PAIR]}")
            if min(pts) < MIN_POINTS or clouds_cvo[0].capacity != CAP:
                raise AssertionError("selector fell short")
            for adaptive in (False, True):
                run_main_path(root, adaptive, card)
            canaries(clouds_cvo[PAIR[0]], args.seed)
            kernel_phase(clouds_cvo, clouds_acvo, card, args.seed)
    print(f"[device] compile cache hits {cache.hits}, misses "
          f"{cache.misses}; wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))


if __name__ == "__main__":
    main()
