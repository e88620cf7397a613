"""Batch pairwise registration over a directory of point-cloud files.

Re-implements the MATLAB batch runner `rgbddataset_rkhs.m`: sequential
pairwise registration over a `pcd_ds/` directory with range filter
[0.8, 4] m + grid downsample (rgbddataset_rkhs.m:34-47), per-frame
try/catch storing NaN on failure (rgbddataset_rkhs.m:49-81), results +
per-pair registration_time saved to a timestamped npz
(rgbddataset_rkhs.m:87-88 saves a .mat).
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

from cvo_rgbd_tpu import MATLAB_PARAMS, align_jit, pad_cloud
from cvo_rgbd_tpu.core.cloud import round_up
from cvo_rgbd_tpu.io.pcd import read_pcd
from cvo_rgbd_tpu.utils import grid_downsample, range_filter


def load_pcd_dir(directory, rmin=0.8, rmax=4.0, grid=0.05):
    """Load + preprocess all .pcd files, sorted by name (timestamp)."""
    paths = sorted(glob.glob(os.path.join(directory, "*.pcd")))
    clouds = []
    for p in paths:
        d = read_pcd(p)
        pos, col = d["positions"], d.get("colors")
        if col is None:
            col = np.zeros_like(pos)
        pos, col = range_filter(pos, col, rmin, rmax)
        pos, col = grid_downsample(pos, col, grid)
        clouds.append((os.path.basename(p), pos, col * 255.0))
    return clouds


def run_batch(
    directory,
    params=None,
    rmin=0.8,
    rmax=4.0,
    grid=0.05,
    output=None,
    min_valid=64,
    log=print,
):
    """Pairwise registration over the directory.

    Returns (results [n,4,4] with NaN rows on failure,
    registration_time [n-1]).  results[0] is identity; results[i] is
    the relative transform frame i-1 -> frame i, matching the MATLAB
    runner's per-pair affine3d array.

    `min_valid`: clouds with fewer valid points (or any non-finite
    valid position) mark both their pairs failed (core.cloud.cloud_ok
    — the MATLAB try/catch-NaN analog for degenerate inputs).
    """
    params = params or MATLAB_PARAMS
    clouds = load_pcd_dir(directory, rmin, rmax, grid)
    if len(clouds) < 2:
        raise ValueError(f"need >= 2 .pcd files in {directory}")
    cap = round_up(max(c[1].shape[0] for c in clouds))
    padded = [pad_cloud(p, c, capacity=cap) for _, p, c in clouds]

    n = len(clouds)
    results = np.full((n, 4, 4), np.nan)
    results[0] = np.eye(4)
    times = np.zeros(n - 1)
    # every pair is an independent cold-start registration, so ALL
    # aligns dispatch first (async) and ONE transfer drains the results
    # — a blocking per-pair fetch would serialize the loop on a
    # device->host wait per pair.  Dispatch-time errors
    # (bad cloud shapes etc.) still fail per pair; non-finite results
    # are marked at drain time (rgbddataset_rkhs.m:75-80 semantics).
    t0 = time.perf_counter()
    handles = {}
    errors = {}
    from cvo_rgbd_tpu.slam import _compiled_cloud_ok

    # ONE cloud_ok dispatch per CLOUD (not per pair side): interior
    # clouds appear in two consecutive pairs.  The per-pair AND happens on the
    # host after the single drain below.
    ok_fn = _compiled_cloud_ok(min_valid)
    ok_handles = [ok_fn(c) for c in padded]
    for i in range(1, n):
        try:
            res = align_jit(params, padded[i - 1], padded[i])
            handles[i] = (res.tf, res.iterations)
        except Exception as e:  # skip-and-mark (rgbddataset_rkhs.m:75-80)
            errors[i] = str(e)
    import jax

    # input-sanity flags ride the same single drain (cloud_ok): a
    # degenerate cloud converges to a silent identity, which the
    # MATLAB runner's try/catch would instead record as a NaN failure
    # (rgbddataset_rkhs.m:75-80)
    fetched, oks = jax.device_get(
        ([handles[i] for i in sorted(handles)], ok_handles)
    )
    per = (time.perf_counter() - t0) / max(n - 1, 1)
    times[:] = per
    drained = dict(zip(sorted(handles), fetched))
    for i in range(1, n):
        if i in errors:
            status = f"FAILED ({errors[i]})"
        else:
            tf, its = drained[i]
            okv = bool(oks[i - 1]) and bool(oks[i])
            if not (okv and np.isfinite(tf).all()):
                status = "FAILED (non-finite transform or degenerate cloud)"
            else:
                results[i] = tf
                status = f"iters={int(its)}"
        log(f"pair {i - 1}->{i} ({clouds[i][0]}): {status} "
            f"t_avg={per * 1e3:.1f}ms (batch amortized: dispatch+drain "
            "time / pairs, not a per-pair measurement)")

    if output is None:
        stamp = time.strftime("%d-%b-%Y-%H-%M-%S")
        output = os.path.join(directory, f"cvo_batch_{stamp}.npz")
    np.savez(
        output,
        results=results,
        registration_time=times,
        names=[c[0] for c in clouds],
    )
    log(f"saved {output}")
    return results, times
