"""Keyframe SLAM: keyframe odometry + loop closure + pose-graph
optimization.

The reference stops at frame-to-frame chaining (cvo.cpp:414).  This
module composes the framework's pieces into the system the BASELINE
north star asks for:

- frames register against the current *keyframe* (drift accumulates
  only across keyframe promotions, not every frame);
- keyframe promotion uses the normalized function inner product
  (keyframes.KeyframeSelector — the hook adaptive_cvo.cpp:385-439
  defines but never wires);
- new keyframes are scored against past keyframes; high-overlap,
  non-adjacent pairs are registered and added as loop-closure edges;
- the SE(3) pose graph (core.posegraph) redistributes the loop error;
- optionally, `refine_map` runs distributed bundle adjustment
  (parallel.ba — Schur-complement GN over collectives) on landmarks
  harvested from the keyframe clouds for metric map consistency.
"""

from __future__ import annotations

import dataclasses
import functools as _ft

import numpy as np

from cvo_rgbd_tpu import align_jit
from cvo_rgbd_tpu.odometry import _fetch


@_ft.lru_cache(maxsize=None)
def _compiled_cloud_ok(min_valid: int):
    import jax

    from cvo_rgbd_tpu.core.cloud import cloud_ok

    return jax.jit(_ft.partial(cloud_ok, min_valid=min_valid))
from cvo_rgbd_tpu.core.posegraph import from_odometry, optimize
from cvo_rgbd_tpu.keyframes import (
    KeyframePolicy,
    KeyframeSelector,
    aligned_fip,
    inner_product_async,
    keyframe_scores_batched,
)


@_ft.lru_cache(maxsize=None)
def _compiled_slam_step(params, adaptive: bool, min_valid: int = 64):
    """Jitted per-frame slam work: align vs the keyframe + the
    self/cross inner products the promotion decision needs, with the
    on-device warm-reset of odometry._compiled_odom_step.  Lets
    `process_batch` dispatch a whole group of frames and fetch ONCE."""
    import jax
    import jax.numpy as jnp

    from cvo_rgbd_tpu import align
    from cvo_rgbd_tpu.core.cloud import cloud_ok
    from cvo_rgbd_tpu.core.registration import function_inner_product

    ell_init = np.float32(params.ell_init)

    def step(key_cloud, cloud, R0, T0, ell0):
        res = align(params, key_cloud, cloud, R0, T0, ell0)
        finite = jnp.isfinite(res.tf).all() & cloud_ok(cloud, min_valid)
        Rw = jnp.where(finite, res.R, jnp.eye(3, dtype=jnp.float32))
        Tw = jnp.where(finite, res.T, jnp.zeros(3, jnp.float32))
        # warm R/T, FRESH ell: keyframe-relative pairs have growing
        # baselines (unlike consecutive-frame odometry), and carrying
        # the previous pair's fully-shrunk ell (0.03 after the k>19
        # schedule, cvo.cpp:408-410) narrows the kernel support so much
        # that the flow dies before covering the extra offset — the
        # warm transform is the right prior, the warm length-scale is
        # not
        ellw = jnp.full((), ell_init)
        cs = function_inner_product(params, cloud, cloud)
        cross = function_inner_product(params, key_cloud, cloud)
        return res.tf, finite, Rw, Tw, ellw, cs, cross

    return jax.jit(step)


@dataclasses.dataclass
class Keyframe:
    index: int            # frame index in the input sequence
    pose: np.ndarray      # [4,4] world pose (odometry estimate)
    cloud: object         # PointCloud
    self_fip: float = 1.0  # cached <f,f> (rigid-invariant)


@dataclasses.dataclass
class SlamConfig:
    keyframe: KeyframePolicy = dataclasses.field(default_factory=KeyframePolicy)
    loop_min_separation: int = 3       # keyframes between loop candidates
    loop_score_threshold: float = 0.5  # overlap needed to attempt closure
    loop_edge_weight: float = 5.0
    loop_max_correction_m: float = 0.5     # outlier gates on measured
    loop_max_correction_rad: float = 0.5   # vs odometry prior
    # spatial prior gate: candidates whose odometry-relative pose to the
    # new keyframe exceeds these bounds are skipped before any kernel
    # evaluation (odometry drift would have to exceed the bound for a
    # true loop to be missed)
    loop_prior_max_m: float = 1.0
    loop_prior_max_rad: float = 1.0
    # input-sanity gate (core.cloud.cloud_ok): frames with fewer valid
    # points, or non-finite positions, are skip-and-marked and can
    # never be promoted to keyframes
    min_valid: int = 64
    optimize_iters: int = 15
    # Robust kernel for the pose-graph solve (core.posegraph): a wrong
    # loop closure that slips past the correction gates down-weights
    # itself by IRLS instead of bending the trajectory.  Cauchy
    # (redescending) rejects far outliers from the odometry
    # initialization; good edges' residuals sit far below delta, so
    # clean graphs solve identically to exact least squares.
    # huber_delta=0 disables (exact LS).
    huber_delta: float = 0.3
    robust_kernel: str = "cauchy"
    # Graduated robustification: first N GN iterations run convex Huber
    # before switching to redescending Cauchy.  Loop edges are admitted
    # with corrections up to loop_prior_max_m/rad ~ 1.0, so a genuine
    # closure of large drift starts with ||r|| >> huber_delta where
    # Cauchy's weight ~ delta^2/r^2 could suppress exactly the
    # correction the edge carries; the Huber phase pulls the chain into
    # the loop basin first (core.posegraph._edge_terms).
    robust_warmup_iters: int = 5


class KeyframeSlam:
    """Feed clouds with `process`; call `solve` for the optimized poses."""

    def __init__(self, params, config: SlamConfig | None = None):
        self.params = params
        self.config = config or SlamConfig()
        self.selector = KeyframeSelector(params, self.config.keyframe)
        self.keyframes: list[Keyframe] = []
        self.frame_poses: list[np.ndarray] = []   # per input frame
        self.frame_keyframe: list[int] = []       # owning keyframe id
        self.loop_edges: list[tuple] = []
        # across-frame warm start (reference R/T/ell persistence, see
        # odometry.run_odometry): valid only while the keyframe is
        # unchanged — the previous frame's keyframe-relative transform
        # is a near-exact prior for the next frame's
        self._warm = None       # (R0, T0, ell0)
        self._warm_kf = -1
        # explicit cold-start seed (identity / ell_init): passing it
        # keeps every align in the system on one compiled signature
        self._cold = (
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            np.float32(params.ell_init),
        )

    def process(self, index, cloud):
        """Register one frame; returns its (odometry) world pose."""
        # <f,f> is needed by the selector score every frame and by
        # loop-closure search for promoted keyframes — dispatch it (no
        # blocking fetch yet) so it rides the same transfer as the align
        cloud_self_d = inner_product_async(self.params, cloud, cloud)
        ok_d = _compiled_cloud_ok(self.config.min_valid)(cloud)
        if not self.keyframes:
            pose = np.eye(4)
            if not bool(ok_d):
                # a degenerate frame must never become a keyframe —
                # including frame 0: seeding the anchor from it would
                # leave a dead keyframe (self_fip ~ 0) in the graph.
                # Skip-and-mark at identity and defer seeding to the
                # first frame that passes cloud_ok.
                self.frame_poses.append(pose)
                self.frame_keyframe.append(0)
                return pose
            cloud_self = float(cloud_self_d)
            self.keyframes.append(
                Keyframe(index, pose, cloud, self_fip=cloud_self)
            )
            self.selector.update(index, cloud, cloud_self=cloud_self)
            self.frame_poses.append(pose)
            self.frame_keyframe.append(0)
            return pose

        key = self.keyframes[-1]
        kf_id = len(self.keyframes) - 1
        if self._warm is not None and self._warm_kf == kf_id:
            res = align_jit(self.params, key.cloud, cloud, *self._warm)
        else:
            # explicit cold seed: keeps cold and warm aligns on ONE
            # compiled signature (the no-argument form traces a second
            # whole align program — a separate multi-second compile)
            res = align_jit(self.params, key.cloud, cloud, *self._cold)
        # the selector's overlap score needs <f_key, f_cloud>; dispatch
        # it too, then ONE device->host transfer for the whole frame
        # (instead of three separate blocking fetches per frame: self
        # fip, align fetch, score fip)
        cross_d = inner_product_async(self.params, key.cloud, cloud)
        rel, res_R, res_T, cloud_self, cross, ok = _fetch(
            res.tf, res.R, res.T, cloud_self_d, cross_d, ok_d,
        )
        cloud_self = float(cloud_self)
        failed = not (bool(ok) and np.isfinite(rel).all())
        if failed:
            # skip-and-mark: carry the PREVIOUS FRAME's pose (for a
            # keyframe-relative driver, rel=identity would snap back to
            # the keyframe's pose — a spurious jump, not continuity)
            rel = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            self._warm = None
        else:
            # warm R/T, FRESH ell — the keyframe-relative warm-start
            # policy of _compiled_slam_step: carrying the previous
            # pair's fully-shrunk ell starves the flow at the growing
            # keyframe baseline (see that docstring).  Both drivers
            # share the policy.
            self._warm = (
                np.asarray(res_R, np.float32), np.asarray(res_T, np.float32),
                np.float32(self.params.ell_init),
            )
            self._warm_kf = kf_id
        pose = key.pose @ rel
        self.frame_poses.append(pose)
        self.frame_keyframe.append(len(self.keyframes) - 1)

        if failed:
            # a degenerate frame must never become a keyframe (its
            # zero overlap score would force exactly that); keep the
            # span counter frame-accurate and move on
            self.selector.tick()
            return pose

        score = float(
            cross / np.sqrt(float(key.self_fip) * cloud_self + 1e-30)
        )
        promoted, _ = self.selector.update_scored(
            index, cloud, cloud_self, score
        )
        if promoted:
            kf = Keyframe(index, pose, cloud, self_fip=cloud_self)
            self.keyframes.append(kf)
            self._try_loop_closure(len(self.keyframes) - 1)
        return pose

    def process_batch(self, items):
        """Process consecutive `(index, cloud)` frames with ONE device
        fetch for the whole group.

        Every frame still registers against the keyframe active when it
        was DISPATCHED (the keyframe at group start, or one promoted in
        an earlier group), so each pose is exact — `pose = key.pose @
        rel` with rel measured against that keyframe.  What changes vs
        per-frame `process` is the promotion CADENCE: overlap scores
        are examined at group granularity, so a promotion (and its
        loop-closure search) can land up to `len(items)-1` frames later
        than the sequential driver would place it, with the in-between
        frames anchored to the older keyframe.  After an in-group
        promotion, the remaining frames of the group skip promotion
        checks (their scores were measured against the old keyframe —
        re-scoring against the new one would need another device round
        trip, which is exactly what this API removes).

        Use group sizes ~4-8: removes the per-frame device->host wait
        (the only blocking sync in `process`).  Returns the list of
        world poses, one per item.
        """
        from cvo_rgbd_tpu.params import AcvoParams

        adaptive = isinstance(self.params, AcvoParams)
        poses_out = []
        items = list(items)
        # the very first frame seeds the keyframe set via process()
        while items and not self.keyframes:
            index, cloud = items.pop(0)
            poses_out.append(self.process(index, cloud))
        if not items:
            return poses_out

        step = _compiled_slam_step(self.params, adaptive,
                                   self.config.min_valid)
        key = self.keyframes[-1]
        kf_id = len(self.keyframes) - 1
        if self._warm is not None and self._warm_kf == kf_id:
            warm = self._warm
        else:
            # odometry prior for the group's first frame: unlike the
            # sequential driver (whose new keyframe IS the previous
            # frame, so cold = identity is exact), a group can open
            # several steps from a keyframe promoted mid-last-group —
            # a cold start at that baseline can exhaust max_iter under
            # the shrinking ell schedule.  inv(key.pose) @ last_pose
            # is one frame stale, which the warm chain absorbs.
            prior = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            R0 = prior[:3, :3].T.astype(np.float32)
            T0 = (-prior[:3, :3].T @ prior[:3, 3]).astype(np.float32)
            warm = (R0, T0, np.float32(self.params.ell_init))
        pend = []
        for index, cloud in items:
            out = step(key.cloud, cloud, *warm)
            warm = (out[2], out[3], out[4])   # on-device warm chain
            pend.append((index, cloud, out))
        import jax

        fetched = jax.device_get([p[2] for p in pend])
        self._warm, self._warm_kf = warm, kf_id

        promoted_any = False
        for (index, cloud, _), (rel, fin, _, _, _, cs, cross) in zip(
            pend, fetched
        ):
            if not bool(fin):
                # skip-and-mark: carry the previous frame's pose (see
                # the same branch in process)
                rel = np.linalg.inv(key.pose) @ self.frame_poses[-1]
            pose = key.pose @ np.asarray(rel, np.float64)
            self.frame_poses.append(pose)
            self.frame_keyframe.append(kf_id)
            poses_out.append(pose)
            if not bool(fin):
                # degenerate frame: never promote it (see process)
                self.selector.tick()
                continue
            if promoted_any:
                # scores are stale vs the new keyframe — skip the
                # promotion check but keep the frame counter accurate
                # so max_span-forced promotions stay frame-cadenced
                self.selector.tick()
                continue
            cs = float(cs)
            score = float(
                cross / np.sqrt(float(key.self_fip) * cs + 1e-30)
            )
            promoted, _ = self.selector.update_scored(
                index, cloud, cs, score
            )
            if promoted:
                self.keyframes.append(
                    Keyframe(index, pose, cloud, self_fip=cs)
                )
                self._try_loop_closure(len(self.keyframes) - 1)
                promoted_any = True
        if promoted_any:
            # the stored warm state is relative to the old keyframe
            self._warm = None
        return poses_out

    def _try_loop_closure(self, kf_id):
        cfg = self.config
        kf = self.keyframes[kf_id]
        # 1. spatial prior gate — pure host math, no kernel work: by
        # odometry, keyframes further than the bound cannot overlap
        cand_ids, priors = [], {}
        for cand_id in range(kf_id - cfg.loop_min_separation):
            cand = self.keyframes[cand_id]
            prior = np.linalg.inv(cand.pose) @ kf.pose
            dt = np.linalg.norm(prior[:3, 3])
            ang = np.arccos(
                np.clip((np.trace(prior[:3, :3]) - 1) / 2, -1, 1)
            )
            if dt <= cfg.loop_prior_max_m and ang <= cfg.loop_prior_max_rad:
                cand_ids.append(cand_id)
                priors[cand_id] = prior
        if not cand_ids:
            return
        # 2. overlap-score ALL surviving candidates in ONE batched
        # device call, using the cached per-keyframe self products
        scores = keyframe_scores_batched(
            self.params,
            [self.keyframes[c].cloud for c in cand_ids],
            kf.cloud,
            [self.keyframes[c].self_fip for c in cand_ids],
            kf.self_fip,
        )
        order = int(np.argmax(scores))
        if scores[order] < cfg.loop_score_threshold:
            return
        cand_id = cand_ids[order]
        cand = self.keyframes[cand_id]

        # register from BOTH the odometry prior and a cold (identity)
        # start, and keep whichever lands at the higher post-align RKHS
        # inner product.  Neither init wins universally: a cold start
        # across a large true offset converges to nearby local optima
        # (round-2 calibration), while a DRIFTED prior strands the
        # align in a local optimum at the drift scale even when the
        # revisit is near-exact (573-frame study, PERF.md — a
        # 135 mm-off prior converged 118 mm off where the cold start
        # was exact).  The inner product the flow maximizes is the
        # natural arbiter and costs one extra batched Gram.
        prior = priors[cand_id]
        R0 = prior[:3, :3].T.astype(np.float32)
        T0 = (-prior[:3, :3].T @ prior[:3, 3]).astype(np.float32)
        res_p = align_jit(self.params, cand.cloud, kf.cloud, R0, T0)
        res_c = align_jit(self.params, cand.cloud, kf.cloud, *self._cold)
        quals = aligned_fip(
            self.params, cand.cloud, kf.cloud, (res_p.tf, res_c.tf),
        )
        rel_p, cv_p, rel_c, cv_c, quals = _fetch(
            res_p.tf, res_p.converged, res_c.tf, res_c.converged, quals,
        )
        cands = [
            (float(q), np.asarray(r, np.float64))
            for q, r, cv in ((quals[0], rel_p, cv_p), (quals[1], rel_c, cv_c))
            if bool(cv) and np.isfinite(r).all()
        ]
        if not cands:
            return
        rel = max(cands, key=lambda t: t[0])[1]
        # outlier gate: the measured relative pose must be within a
        # plausible correction of the prior
        delta = np.linalg.inv(prior) @ rel
        dt = np.linalg.norm(delta[:3, 3])
        ang = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
        if dt > cfg.loop_max_correction_m or ang > cfg.loop_max_correction_rad:
            return
        self.loop_edges.append((cand_id, kf_id, rel, cfg.loop_edge_weight))

    def solve(self):
        """Optimize the keyframe graph; returns per-frame corrected poses."""
        if not self.keyframes:
            # every frame was degenerate: nothing was ever seeded
            return list(self.frame_poses), np.zeros((0, 4, 4))
        kf_poses = np.stack([k.pose for k in self.keyframes])
        if len(self.keyframes) < 2:
            return list(self.frame_poses), kf_poses
        graph = from_odometry(kf_poses, loop_edges=self.loop_edges)
        nodes, _ = optimize(graph, iters=self.config.optimize_iters,
                            huber_delta=self.config.huber_delta,
                            robust=self.config.robust_kernel,
                            robust_warmup=self.config.robust_warmup_iters)
        nodes = np.asarray(nodes)
        # re-anchor every frame to its (corrected) keyframe
        out = []
        for pose, kf_id in zip(self.frame_poses, self.frame_keyframe):
            correction = nodes[kf_id] @ np.linalg.inv(
                self.keyframes[kf_id].pose
            )
            out.append(correction @ pose)
        return out, nodes

    def refine_map(self, kf_poses=None, mesh=None, iters=8, grid=0.05,
                   radius=0.03, feature_weight=2.0):
        """Bundle-adjust keyframe poses + a landmark map (parallel.ba).

        Starts from `kf_poses` (default: the pose-graph solution from
        `solve`).  Returns (refined kf poses [K,4,4], landmarks [M,3],
        costs) or None when too few keyframes/correspondences.  Pass a
        mesh to shard the observation reductions over devices.

        `radius` must stay BELOW the cloud's typical point spacing:
        on continuous surfaces a larger radius lets the landmark->point
        association slide along the surface between views, and that
        association bias shows up directly as pose error (measured:
        radius 0.05 on ~3 cm-spaced clouds inflated keyframe ATE 1.9x,
        radius 0.03 held it while still dropping the BA cost).
        `feature_weight` additionally pins each correspondence to the
        same textured spot across views (round 5: the 5-dim features
        join the NN cost inside the radius — see
        parallel.ba.ba_from_keyframes).
        """
        from cvo_rgbd_tpu.parallel import ba_from_keyframes, ba_solve

        if len(self.keyframes) < 2:
            return None
        if kf_poses is None:
            _, kf_poses = self.solve()
        problem = ba_from_keyframes(
            [k.cloud for k in self.keyframes], np.asarray(kf_poses),
            grid=grid, radius=radius, feature_weight=feature_weight,
        )
        if problem is None:
            return None
        return ba_solve(problem, mesh=mesh, iters=iters)
