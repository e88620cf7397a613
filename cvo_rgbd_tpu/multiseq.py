"""Multi-sequence odometry: batch data parallelism over sequences.

The reference processes one sequence at a time (cvo_main.cpp:36-66).
For production throughput, S sequences advance in lockstep: each step
registers S frame pairs as one `align_batched` call — vmapped on a
single chip, sharded over the `dp` mesh axis on many (SURVEY.md
section 2.6 "Batch DP").
"""

from __future__ import annotations

import functools as _ft
import os
import time

import numpy as np

from cvo_rgbd_tpu.frontend import make_frontend
from cvo_rgbd_tpu.io.tum import load_assoc, write_trajectory_line
from cvo_rgbd_tpu.odometry import load_image_pair
from cvo_rgbd_tpu.params import CvoParams
from cvo_rgbd_tpu.parallel import align_batched


from cvo_rgbd_tpu.core.cloud import stack_clouds as _stack


@_ft.lru_cache(maxsize=None)
def _compiled_lane_post(adaptive: bool, ell_init: float, min_valid: int = 64):
    """Jitted per-lane warm-state update: a failed lane resets to cold
    (skip-and-mark, like run_odometry), a good lane carries its R/T/ell
    (acvo resets ell per pair, adaptive_cvo.cpp:475).  Runs ON DEVICE
    so the lockstep chain never waits for a step's result before
    dispatching the next one (see odometry._compiled_odom_step).

    Lane failure = non-finite transform OR degenerate input clouds
    (core.cloud.cloud_ok); retired lanes' all-masked placeholders fail
    the validity test too, which is harmless — their results are never
    written."""
    import jax
    import jax.numpy as jnp

    from cvo_rgbd_tpu.core.cloud import cloud_ok

    def post(tf, R, T, ell, fixed_b, moving_b):
        ok = (
            jnp.isfinite(tf).all(axis=(1, 2))
            & cloud_ok(fixed_b, min_valid)
            & cloud_ok(moving_b, min_valid)
        )
        Rw = jnp.where(ok[:, None, None], R, jnp.eye(3, dtype=jnp.float32))
        Tw = jnp.where(ok[:, None], T, jnp.zeros((), jnp.float32))
        if adaptive:
            ellw = jnp.full_like(ell, ell_init)
        else:
            ellw = jnp.where(ok, ell, jnp.float32(ell_init))
        return ok, Rw, Tw, ellw

    return jax.jit(post)


def run_multiseq(
    folders,
    dataset_seq,
    adaptive=False,
    params=None,
    num_want=3000,
    max_frames=None,
    mesh=None,
    warm_start=True,
    fetch_every=4,
    min_valid=64,
    log=print,
):
    """Run odometry on several TUM folders in lockstep.

    Returns {folder: trajectory_path}.  Sequences shorter than the
    longest are RETIRED once they end: their lane is replaced by an
    all-masked cloud, which converges at iteration 0 — so a finished
    lane neither gates the lockstep batch's iteration count nor pays
    frontend/IO work, and its trajectory stops growing.  `adaptive`
    picks acvo (feature_type 0 frontend + AcvoParams defaults) per
    pair, matching run_odometry.

    `warm_start` (default True): each lane is its own sequence, so the
    exact reference across-pair warm start (R/T/ell persistence,
    cvo.cpp:43-45, 398-399 — see odometry.run_odometry) applies per
    lane; batch iteration count is the max over lanes, so warm lanes
    finish the lockstep step much earlier.

    `fetch_every`: lockstep steps between device->host result flushes.
    The per-lane warm chain runs on device (`_compiled_lane_post`), so
    step k+1 dispatches without waiting for step k's fetch; pose
    chaining and trajectory writes happen at each flush, value-identical
    to `fetch_every=1` (same per-pair transforms, host fp64 chaining).
    """
    from cvo_rgbd_tpu.params import AcvoParams

    params = params or (AcvoParams() if adaptive else CvoParams())
    frontend = make_frontend(dataset_seq, num_want, 0 if adaptive else 1)

    seqs = []
    for folder in folders:
        entries = load_assoc(os.path.join(folder, "assoc.txt"))
        if max_frames:
            entries = entries[:max_frames]
        seqs.append({"folder": folder, "entries": entries, "accum": np.eye(4)})
    n_steps = max(len(s["entries"]) for s in seqs)

    outs = {}
    handles = []
    for s in seqs:
        path = os.path.join(
            s["folder"],
            "acvo_poses_qt_batch.txt" if adaptive else "cvo_poses_qt_batch.txt",
        )
        outs[s["folder"]] = path
        handles.append(open(path, "w"))

    t0 = time.time()
    pairs_done = 0
    prev_clouds = None
    empty_cloud = None   # all-masked placeholder for finished lanes
    S = len(seqs)
    # per-lane warm state (identity / ell_init = cold); acvo resets ell
    # per pair (adaptive_cvo.cpp:475) so its lanes always get ell_init
    warm_R = np.broadcast_to(np.eye(3, dtype=np.float32), (S, 3, 3)).copy()
    warm_T = np.zeros((S, 3), np.float32)
    warm_ell = np.full((S,), params.ell_init, np.float32)
    post = _compiled_lane_post(adaptive, float(params.ell_init), min_valid)
    pending = []   # (step, tfs_device, ok_device) awaiting one fetch

    def flush():
        nonlocal pairs_done
        if not pending:
            return
        import jax

        # ONE device->host transfer for the whole chunk of steps
        fetched = jax.device_get([(p[1], p[2]) for p in pending])
        for (step, _, _), (tfs, ok) in zip(pending, fetched):
            for si, s in enumerate(seqs):
                if step < len(s["entries"]):
                    if ok[si]:
                        s["accum"] = s["accum"] @ tfs[si]
                    else:
                        # skip-and-mark (rgbddataset_rkhs.m:49-81):
                        # keep the previous accumulated pose
                        log(f"{s['folder']} step {step}: non-finite "
                            "transform, skipping")
                    write_trajectory_line(
                        handles[si], s["entries"][step].name, s["accum"]
                    )
                    pairs_done += 1
        pending.clear()

    try:
        for step in range(n_steps):
            clouds = []
            for s in seqs:
                if step < len(s["entries"]):
                    rgb, dep = load_image_pair(s["folder"], s["entries"][step])
                    clouds.append(frontend(rgb, dep))
                else:
                    # retired lane: an all-masked cloud converges at
                    # iteration 0 (zero flow), so it neither gates the
                    # lockstep batch's while_loop trip count nor pays
                    # frontend/image IO — a 1-frame lane costs nothing
                    # once its sequence ends
                    clouds.append(empty_cloud)
            if empty_cloud is None:
                import jax

                empty_cloud = jax.tree_util.tree_map(
                    np.zeros_like, clouds[0]
                )
            if prev_clouds is not None:
                kw = (
                    dict(R0=warm_R, T0=warm_T, ell0=warm_ell)
                    if warm_start else {}
                )
                fb, mb = _stack(prev_clouds), _stack(clouds)
                res = align_batched(params, fb, mb, mesh=mesh, **kw)
                # warm chain stays ON DEVICE; results are fetched in
                # batches of `fetch_every` steps so the dispatch
                # pipeline never stalls on a device->host wait
                ok_d, Rw, Tw, ellw = post(res.tf, res.R, res.T, res.ell,
                                          fb, mb)
                if warm_start:
                    warm_R, warm_T = Rw, Tw
                    if not adaptive:
                        warm_ell = ellw
                pending.append((step, res.tf, ok_d))
                if len(pending) >= fetch_every:
                    flush()
            else:
                for si, s in enumerate(seqs):
                    write_trajectory_line(
                        handles[si], s["entries"][0].name, s["accum"]
                    )
            prev_clouds = clouds
            if step % 10 == 0:
                log(f"step {step}/{n_steps}")
        flush()
    finally:
        for h in handles:
            h.close()
    dt = time.time() - t0
    if pairs_done:
        log(f"{pairs_done} pairs across {len(seqs)} sequences in {dt:.1f}s "
            f"({pairs_done / dt:.2f} pairs/s)")
    return outs
