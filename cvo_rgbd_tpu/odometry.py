"""Frame-to-frame odometry driver: the reference CLI loop, resumable.

Replaces cvo_main.cpp:8-73 / adaptive_cvo_main.cpp: parse assoc.txt,
loop frames, frontend -> align -> chain accumulated pose, append a TUM
trajectory line per frame, per-frame timing.

Improvements over the reference (SURVEY.md section 5):
- explicit `OdometryState` checkpoint (accum pose + frame index) —
  resuming regenerates the fixed cloud from frame i-1 and continues;
- structured per-frame records (iterations, convergence, wall time)
  instead of raw couts;
- skip-and-mark failure semantics per pair (the MATLAB batch runner's
  try/catch NaN behavior, rgbddataset_rkhs.m:49-81): a non-finite
  transform marks the frame and carries the previous accumulated pose.
"""

from __future__ import annotations

import dataclasses
import functools as _ft
import json
import os
import time

import numpy as np

from cvo_rgbd_tpu.frontend import make_frontend
from cvo_rgbd_tpu.io.tum import load_assoc, write_trajectory_line
from cvo_rgbd_tpu.params import AcvoParams, CvoParams


def _fetch(*arrays):
    """Fetch device values in ONE transfer.  Separate np.asarray calls
    on align results each wait on the device; jax.device_get on the
    tuple issues the copies together and waits once."""
    import jax

    return jax.device_get(arrays)


@_ft.lru_cache(maxsize=None)
def _compiled_odom_step(params, adaptive: bool, min_valid: int = 64):
    """Jitted align + on-device warm-start bookkeeping for one pair.

    The sequential odometry chain needs NOTHING from the device between
    pairs: the across-pair warm state (the reference's persistent
    R/T/ell members, cvo.cpp:43-45, 398-399) feeds straight from one
    align into the next, and the skip-and-mark failure reset
    (rgbddataset_rkhs.m:49-81 semantics) is a `where` on a finiteness
    flag.  Folding both into the jitted step lets the driver dispatch
    frame i+1 without waiting for frame i's result — the per-frame
    device->host wait moves out of the loop entirely and is amortized
    over `fetch_every` frames.  Host-side pose chaining (fp64 accum @ tf)
    happens at flush time from the fetched tf's, bit-identical to the
    eager path.
    """
    import jax
    import jax.numpy as jnp

    from cvo_rgbd_tpu import align
    from cvo_rgbd_tpu.core.cloud import cloud_ok

    ell_init = np.float32(params.ell_init)

    def step(fixed, moving, R0, T0, ell0):
        res = align(params, fixed, moving, R0, T0, ell0)
        # failure = non-finite result OR degenerate input (empty /
        # corrupt cloud on either side — the align loop is total and
        # would otherwise chain a silent identity, see cloud_ok)
        finite = (
            jnp.isfinite(res.tf).all()
            & cloud_ok(fixed, min_valid)
            & cloud_ok(moving, min_valid)
        )
        # failure resets the warm state to cold (identity / ell_init)
        Rw = jnp.where(finite, res.R, jnp.eye(3, dtype=jnp.float32))
        Tw = jnp.where(finite, res.T, jnp.zeros(3, jnp.float32))
        if adaptive:
            # acvo resets ell per pair (adaptive_cvo.cpp:475)
            ellw = jnp.full((), ell_init)
        else:
            ellw = jnp.where(finite, res.ell, ell_init)
        return res.tf, res.iterations, res.converged, finite, Rw, Tw, ellw

    return jax.jit(step)


@dataclasses.dataclass
class FrameRecord:
    index: int
    name: str
    iterations: int
    converged: bool
    failed: bool
    seconds: float


@dataclasses.dataclass
class OdometryState:
    frame_index: int          # next frame to process
    accum: np.ndarray         # [4,4] accumulated transform
    # across-pair warm-start state (the reference's persistent R/T/ell
    # members, cvo.cpp:43-45, 398-399): None = cold (identity/ell_init)
    warm_R: np.ndarray | None = None   # [3,3]
    warm_T: np.ndarray | None = None   # [3]
    warm_ell: float | None = None      # cvo only; acvo resets per pair

    def save(self, path):
        with open(path, "w") as f:
            json.dump(
                {
                    "frame_index": self.frame_index,
                    "accum": self.accum.tolist(),
                    "warm_R": None if self.warm_R is None
                    else np.asarray(self.warm_R).tolist(),
                    "warm_T": None if self.warm_T is None
                    else np.asarray(self.warm_T).tolist(),
                    "warm_ell": None if self.warm_ell is None
                    else float(self.warm_ell),
                },
                f,
            )

    @staticmethod
    def load(path) -> "OdometryState":
        with open(path) as f:
            d = json.load(f)
        arr = lambda v, dt: None if v is None else np.array(v, dt)  # noqa: E731
        return OdometryState(
            d["frame_index"], np.array(d["accum"]),
            warm_R=arr(d.get("warm_R"), np.float32),
            warm_T=arr(d.get("warm_T"), np.float32),
            warm_ell=d.get("warm_ell"),
        )


def _decoder():
    """The native PNG decoder when it builds, else the zlib + numpy
    one (io/png.py)."""
    from cvo_rgbd_tpu import native

    if native.get_lib() is not None:
        return native.decode_png
    from cvo_rgbd_tpu.io.png import read_png

    return read_png


def load_image_pair(folder, entry):
    """PNG loading analog of load_img (cvo_main.cpp:104-107): 8-bit RGB
    + 16-bit depth."""
    decode = _decoder()
    rgb = decode(os.path.join(folder, entry.rgb_path))
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=2)
    dep = decode(os.path.join(folder, entry.depth_path))
    return (np.asarray(rgb[..., :3], np.float32),
            np.asarray(dep, np.float32))


def make_frame_source(folder, entries, start, use_native=True):
    """Yield (index, rgb f32, depth f32) from `start`.

    Uses the native threaded prefetch loader (cvo_rgbd_tpu.native) when
    it builds — PNG read+decode of upcoming frames overlaps with device
    compute — else decodes synchronously with io/png.py.
    """
    from cvo_rgbd_tpu import native

    if use_native and native.get_lib() is not None:
        rgb0, dep0 = load_image_pair(folder, entries[start])
        loader = native.PrefetchLoader(
            [os.path.join(folder, e.rgb_path) for e in entries[start:]],
            [os.path.join(folder, e.depth_path) for e in entries[start:]],
            rgb0.shape[1], rgb0.shape[0],
            dep0.shape[1], dep0.shape[0],
            workers=2, ahead=8,
        )

        def gen():
            for off, rgb, dep in loader:
                yield start + off, rgb.astype(np.float32), dep.astype(np.float32)
            loader.close()

        return gen()

    def gen_py():
        for i in range(start, len(entries)):
            rgb, dep = load_image_pair(folder, entries[i])
            yield i, rgb, dep

    return gen_py()


def run_odometry(
    folder,
    dataset_seq,
    adaptive=False,
    params=None,
    output=None,
    max_frames=None,
    checkpoint=None,
    num_want=3000,
    use_native=True,
    warm_start=True,
    fetch_every=8,
    min_valid=64,
    log=print,
):
    """Run the full odometry loop.  Returns list[FrameRecord].

    `min_valid`: pairs whose clouds carry fewer valid points (or any
    non-finite valid position) are marked failed (skip-and-mark) —
    the driver-level analog of the MATLAB runner's try/catch NaN
    (rgbddataset_rkhs.m:49-81); see core.cloud.cloud_ok.

    `dataset_seq` selects camera intrinsics (int or name, see
    frontend.camera).  `adaptive` picks acvo (feature_type 0 + adaptive
    ell, adaptive_cvo.cpp:451) vs cvo (feature_type 1, cvo.cpp:340).

    `warm_start` (default True = reference semantics): the reference's
    R/T members persist across pairs (cvo.cpp:43-45, 398-399 — never
    reset by set_pcd), so every pair after the first starts from the
    previous pair's converged relative transform; for cvo, `ell` also
    carries over (iterations 0-2 run at the previous align's final
    length-scale before the absolute k>2/9/19 schedule takes over,
    cvo.cpp:408-410), while acvo resets ell per pair
    (adaptive_cvo.cpp:475).  False starts every pair from identity at
    ell_init.  A skipped (non-finite) pair resets the warm state.

    `fetch_every`: frames between device->host result flushes.  The
    warm-start chain and failure reset run ON DEVICE (see
    `_compiled_odom_step`), so the host never has to wait for a pair
    before dispatching the next one; results are fetched in batches of
    `fetch_every`, so the device runs ahead of the host by up to
    `fetch_every` pairs.  Trajectory lines, FrameRecords,
    logs, and checkpoint saves happen at each flush; the values written
    are bit-identical to `fetch_every=1` (pose chaining stays on the
    host in fp64 from the fetched per-pair transforms).  A crash loses
    at most `fetch_every-1` frames of checkpoint progress.
    """
    params = params or (AcvoParams() if adaptive else CvoParams())
    feature_type = 0 if adaptive else 1
    frontend = make_frontend(dataset_seq, num_want, feature_type)

    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    if max_frames:
        entries = entries[:max_frames]
    if output is None:
        output = os.path.join(
            folder, "acvo_poses_qt.txt" if adaptive else "cvo_poses_qt.txt"
        )

    state = OdometryState(0, np.eye(4))
    mode = "w"
    if checkpoint and os.path.exists(checkpoint):
        state = OdometryState.load(checkpoint)
        mode = "a"
        log(f"resuming at frame {state.frame_index}")

    records: list[FrameRecord] = []
    fixed_cloud = None
    step_fn = _compiled_odom_step(params, adaptive, min_valid)
    # device-resident (R0, T0, ell0) for the next pair; explicit cold
    # values keep warm and cold on ONE compiled signature
    cold = (
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
        np.float32(params.ell_init),
    )
    warm = cold
    if warm_start and state.warm_R is not None:
        # resume with the checkpointed across-pair state
        warm = (
            np.asarray(state.warm_R, np.float32),
            np.asarray(state.warm_T, np.float32),
            np.float32(params.ell_init if (adaptive or state.warm_ell is None)
                       else state.warm_ell),
        )
    start = max(state.frame_index - 1, 0)
    total_t0 = time.time()

    # deferred results: (frame_index, name, (tf, iters, conv, finite))
    pending: list[tuple] = []
    chunk_t0 = time.time()

    frames = make_frame_source(folder, entries, start, use_native=use_native)
    with open(output, mode) as traj:

        def flush():
            nonlocal chunk_t0
            if not pending:
                return
            import jax

            # ONE device->host transfer for the whole chunk (each
            # separate fetch waits on the device on its own)
            fetched, (wR, wT, well) = jax.device_get(
                ([p[2] for p in pending], warm)
            )
            per = (time.time() - chunk_t0) / len(pending)
            for (i, name, _), (tf, it, cv, fin) in zip(pending, fetched):
                failed = not bool(fin)
                if failed:
                    # skip-and-mark (rgbddataset_rkhs.m:49-81): keep the
                    # previous accum (warm reset already happened on
                    # device inside the step)
                    log(f"frame {i}: non-finite transform, skipping")
                else:
                    state.accum = state.accum @ tf
                records.append(FrameRecord(
                    index=i, name=name, iterations=int(it),
                    converged=bool(cv), failed=failed, seconds=per,
                ))
                write_trajectory_line(traj, name, state.accum)
                state.frame_index = i + 1
                log(
                    f"frame {i}/{len(entries)}: iters={int(it)} "
                    f"conv={bool(cv)} t={per*1000:.1f}ms"
                )
            traj.flush()
            if checkpoint:
                if warm_start:
                    state.warm_R = np.asarray(wR, np.float32)
                    state.warm_T = np.asarray(wT, np.float32)
                    state.warm_ell = None if adaptive else float(well)
                state.save(checkpoint)
            pending.clear()
            chunk_t0 = time.time()

        for i, rgb, dep in frames:
            cloud = frontend(rgb, dep)

            if fixed_cloud is None:
                # first frame seeds the fixed cloud (cvo.cpp:326-334)
                fixed_cloud = cloud
                if i >= state.frame_index:
                    write_trajectory_line(traj, entries[i].name, state.accum)
                    state.frame_index = i + 1
                continue

            out = step_fn(fixed_cloud, cloud, *warm)
            if warm_start:
                # across-pair R/T (+ ell for cvo) persistence, with
                # on-device failure reset — stays on device so the next
                # dispatch never waits on this one's result
                warm = (out[4], out[5], out[6])
            pending.append((i, entries[i].name, out[:4]))
            fixed_cloud = cloud
            if len(pending) >= fetch_every:
                flush()
        flush()

    total = time.time() - total_t0
    n = len(records)
    if n:
        log(
            f"processed {n} pairs in {total:.1f}s "
            f"({n / total:.2f} frames/s)"
        )
    return records


def run_odometry_batched(
    folder,
    dataset_seq,
    adaptive=False,
    params=None,
    output=None,
    max_frames=None,
    num_want=3000,
    batch=8,
    use_native=True,
    motion_prior=False,
    min_valid=64,
    log=print,
):
    """Offline odometry with batched pair registration.

    Frame-to-frame *pairs* are independent even though the accumulated
    pose chain is sequential, so an offline trajectory can register
    `batch` pairs per device step (`parallel.align_batched`) and chain
    the results afterwards — amortizing per-call overhead and, on a
    mesh, sharding pairs over the `dp` axis.  `adaptive` picks acvo
    (feature_type 0, per-pair ell reset — adaptive_cvo.cpp:451,
    476-485) exactly as in `run_odometry`.  Returns list[FrameRecord].

    `motion_prior` (default False): warm-start every lane of chunk k+1
    with the last finite relative transform of chunk k — a
    constant-velocity approximation of the reference's exact
    across-pair warm start (which batched registration cannot
    reproduce: lane j's true predecessor is lane j-1 of the SAME
    chunk).  The converged optimum is tolerance-equal; iteration counts
    drop sharply on smooth sequences.  Off by default so batched output
    is independent of chunking.

    `min_valid`: pairs touching a degenerate cloud (fewer valid points,
    or non-finite valid positions — core.cloud.cloud_ok) are marked
    failed, exactly as in `run_odometry`: the align loop is total and
    would otherwise chain a silent identity relative pose (and the
    `motion_prior` seed must never come from such a lane).
    """
    from cvo_rgbd_tpu.parallel import align_batched

    params = params or (AcvoParams() if adaptive else CvoParams())
    feature_type = 0 if adaptive else 1
    frontend = make_frontend(dataset_seq, num_want, feature_type)
    entries = load_assoc(os.path.join(folder, "assoc.txt"))
    if max_frames:
        entries = entries[:max_frames]
    if output is None:
        output = os.path.join(
            folder, "acvo_poses_qt.txt" if adaptive else "cvo_poses_qt.txt"
        )
    if len(entries) < 2:
        raise ValueError("need at least 2 frames")

    total_t0 = time.time()
    clouds = []
    for i, rgb, dep in make_frame_source(folder, entries, 0, use_native):
        clouds.append(frontend(rgb, dep))
    n_pairs = len(clouds) - 1

    # ONE cloud_ok dispatch per cloud, drained in ONE transfer (each
    # separate fetch waits on the device); the per-pair
    # AND happens on the host
    from cvo_rgbd_tpu.slam import _compiled_cloud_ok

    ok_fn = _compiled_cloud_ok(min_valid)
    import jax as _jax

    cloud_oks = np.asarray(
        _jax.device_get([ok_fn(c) for c in clouds]), bool
    )
    pair_ok = cloud_oks[:-1] & cloud_oks[1:]

    from cvo_rgbd_tpu.core.cloud import stack_clouds as stack

    rels = []
    iters = []
    conv = []
    pair_secs = []  # per-pair wall share of each device chunk (group)
    prior = None  # (R0 [3,3], T0 [3], ell0 scalar) from the last chunk
    # without motion_prior the chunks are fully independent, so their
    # fetches are deferred and batched (same rationale as run_odometry's
    # fetch_every): the next chunk dispatches while the previous one
    # computes, and one transfer drains several chunks' results.  The
    # motion_prior path needs each chunk's transforms on the host before
    # dispatching the next, so it keeps the per-chunk fetch.
    pending = []          # (idxs, (tf, iterations, converged)) awaiting fetch
    flush_chunks = 4      # chunks per deferred flush
    group_t0 = time.time()

    def flush_pending():
        nonlocal group_t0
        if not pending:
            return
        import jax

        fetched = jax.device_get([p[1] for p in pending])
        n_in_group = sum(len(p[0]) for p in pending)
        per = (time.time() - group_t0) / n_in_group
        for (idxs, _), (tfs, its, cvg) in zip(pending, fetched):
            for k, i in enumerate(idxs):
                rels.append(tfs[k])
                iters.append(int(its[k]))
                conv.append(bool(cvg[k]))
                pair_secs.append(per)
            log(f"pairs {idxs[0]}..{idxs[-1]} registered")
        pending.clear()
        group_t0 = time.time()

    for start in range(0, n_pairs, batch):
        chunk_t0 = time.time()
        idxs = list(range(start, min(start + batch, n_pairs)))
        pad = idxs + [idxs[-1]] * (batch - len(idxs))  # repeat-pad last chunk
        fb = stack([clouds[i] for i in pad])
        mb = stack([clouds[i + 1] for i in pad])
        kw = {}
        if motion_prior and prior is not None:
            kw = dict(
                R0=np.broadcast_to(prior[0], (batch, 3, 3)).copy(),
                T0=np.broadcast_to(prior[1], (batch, 3)).copy(),
                ell0=np.full((batch,), prior[2], np.float32),
            )
        res = align_batched(params, fb, mb, **kw)
        if not motion_prior:
            pending.append((idxs, (res.tf, res.iterations, res.converged)))
            if len(pending) >= flush_chunks:
                flush_pending()
            continue
        tfs, its, cvg, res_R, res_T, res_ell = _fetch(
            res.tf, res.iterations, res.converged, res.R, res.T, res.ell,
        )
        # the constant-velocity seed must come from a lane whose INPUTS
        # were sane, not just one whose transform happens to be finite
        # (a degenerate cloud converges to a finite identity)
        fin = np.isfinite(tfs).all(axis=(1, 2)) & pair_ok[np.array(pad)]
        if fin.any():
            last = int(np.max(np.nonzero(fin)[0]))
            prior = (
                np.asarray(res_R, np.float32)[last],
                np.asarray(res_T, np.float32)[last],
                params.ell_init if adaptive
                else float(res_ell[last]),
            )
        else:
            prior = None
        chunk_dt = time.time() - chunk_t0
        for k, i in enumerate(idxs):
            rels.append(tfs[k])
            iters.append(int(its[k]))
            conv.append(bool(cvg[k]))
            pair_secs.append(chunk_dt / len(idxs))
        log(f"pairs {idxs[0]}..{idxs[-1]} registered")
    flush_pending()

    records = []
    accum = np.eye(4)
    with open(output, "w") as traj:
        write_trajectory_line(traj, entries[0].name, accum)
        for i, rel in enumerate(rels):
            failed = not (bool(pair_ok[i]) and bool(np.isfinite(rel).all()))
            if not failed:
                accum = accum @ rel
            write_trajectory_line(traj, entries[i + 1].name, accum)
            records.append(FrameRecord(
                index=i + 1, name=entries[i + 1].name,
                iterations=iters[i], converged=conv[i],
                failed=failed, seconds=pair_secs[i],
            ))
    total = time.time() - total_t0
    log(f"{n_pairs} pairs in {total:.1f}s ({n_pairs / total:.2f} pairs/s, "
        f"batch={batch})")
    return records
