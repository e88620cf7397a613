"""Distributed bundle adjustment — sparse Schur + matrix-free PCG over
collectives.

SURVEY.md section 2.6 lists "keyframe graph + Schur-complement reduction
over collectives" as a first-class component with **no analog in the
reference** (the reference chains accum_transform, cvo.cpp:414, and
never builds a map).  This module provides it for the RGB-D setting:

  poses      X_k in SE(3)   (keyframe camera-to-world)
  landmarks  l_m in R^3     (world-frame map points)
  residual   r_o = X_k^{-1} l_m - z_o
             (z_o = the 3-D point measured in camera k's frame — RGB-D
             observes full 3-D points, so no projection model is needed)

Gauss-Newton with right-multiplicative pose updates X <- X exp(xi^),
xi = [omega; v] (the se3.exp_se3 convention).  With d = R^T (l - t):

  dr/dxi = [skew(d), -I_3]        dr/dl = R^T

The normal equations have the classic BA arrowhead structure: H_pp is
block-diagonal over poses, H_ll block-diagonal over landmarks, and the
pose-landmark coupling H_pl is SPARSE — one [6,3] block per distinct
(pose, landmark) EDGE, never more than one per observation.  Storing
H_pl densely as [K, M, 6, 3] would cap the map size; here it lives as
per-edge blocks E [Ne, 6, 3] (Ne <= O), and
the reduced camera system

  S dp = -(b_p - H_pl W b_l),   S = H_pp - H_pl W H_lp,  W = H_ll^{-1}

is solved MATRIX-FREE: S is never formed — each PCG matvec gathers
x through the edge blocks (H_lp x: edge scatter-add into [M,3]; W·;
H_pl·: edge gather back into [K,6]) in O(Ne) work, with a block-Jacobi
preconditioner assembled from the same edge blocks.  Landmarks then
back-substitute dl = -W (b_l + H_lp dp).

Distribution: observations shard over a mesh axis inside
`shard_map`; every device scatter-adds its shard's contributions into
the edge-block/diagonal accumulators and ONE `lax.psum` per quantity
reduces them — the direct scale-out of the reference's mutex-guarded
accumulators (cvo.cpp:201-204).  The landmark-block inversion W is
computed on LANDMARK shards (each device inverts its M/n slice of
3x3 blocks) and all-gathered; the PCG loop itself is replicated —
its per-matvec cost is O(Ne·18) flops with no [K,M] or [6K,6K]
objects, so at realistic edge counts it is cheaper than one psum and
replication costs nothing.  Per GN iteration the collective payload is
O(Ne·18 + K·36 + M·9) — independent of K·M.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core.pcg import pcg as _pcg

# reduced-precision default matmuls bias GN updates (PERF.md numerics);
# pin full fp32 precision on every contraction.
_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """poses [K,4,4] camera-to-world; landmarks [M,3] world;
    observations (obs_pose [O] int32, obs_lm [O] int32, obs_z [O,3]
    camera-frame measured points, obs_w [O] weights — 0 marks padding);
    edge structure (obs_edge [O] int32 mapping each observation to its
    distinct (pose, landmark) pair, edge_pose/edge_lm [Ne] int32) —
    static per problem, built by make_ba_problem.
    """

    poses: jnp.ndarray
    landmarks: jnp.ndarray
    obs_pose: jnp.ndarray
    obs_lm: jnp.ndarray
    obs_z: jnp.ndarray
    obs_w: jnp.ndarray
    obs_edge: jnp.ndarray
    edge_pose: jnp.ndarray
    edge_lm: jnp.ndarray


def make_ba_problem(poses, landmarks, obs_pose, obs_lm, obs_z, obs_w=None,
                    pad_to=None, pad_landmarks_to=None):
    """Assemble a BAProblem from host arrays, padding observations to
    `pad_to` and landmarks to `pad_landmarks_to` (needed to shard
    evenly over a mesh axis).  The (pose, landmark) edge list — the
    sparsity pattern of H_pl — is derived here with np.unique, so
    duplicate observations of one pair merge into one coupling block."""
    poses = np.asarray(poses, np.float32)
    landmarks = np.asarray(landmarks, np.float32)
    obs_pose = np.asarray(obs_pose, np.int32)
    obs_lm = np.asarray(obs_lm, np.int32)
    obs_z = np.asarray(obs_z, np.float32)
    o = obs_pose.shape[0]
    obs_w = (np.ones(o, np.float32) if obs_w is None
             else np.asarray(obs_w, np.float32))

    # edge structure from the REAL (pre-padding) observations
    m = landmarks.shape[0]
    pair_key = obs_pose.astype(np.int64) * m + obs_lm.astype(np.int64)
    uniq, obs_edge = np.unique(pair_key, return_inverse=True)
    edge_pose = (uniq // m).astype(np.int32)
    edge_lm = (uniq % m).astype(np.int32)
    obs_edge = obs_edge.astype(np.int32)

    if pad_to is not None and pad_to > o:
        pad = pad_to - o
        obs_pose = np.concatenate([obs_pose, np.zeros(pad, np.int32)])
        obs_lm = np.concatenate([obs_lm, np.zeros(pad, np.int32)])
        obs_z = np.concatenate([obs_z, np.zeros((pad, 3), np.float32)])
        obs_w = np.concatenate([obs_w, np.zeros(pad, np.float32)])
        # w=0 padding contributes nothing wherever it scatters
        obs_edge = np.concatenate([obs_edge, np.zeros(pad, np.int32)])
    if pad_landmarks_to is not None and pad_landmarks_to > m:
        landmarks = np.concatenate([
            landmarks,
            np.zeros((pad_landmarks_to - m, 3), np.float32),
        ])  # unobserved: H_ll block = 0, damping keeps W finite, dl = 0
    return BAProblem(
        poses=jnp.asarray(poses),
        landmarks=jnp.asarray(landmarks),
        obs_pose=jnp.asarray(obs_pose),
        obs_lm=jnp.asarray(obs_lm),
        obs_z=jnp.asarray(obs_z),
        obs_w=jnp.asarray(obs_w),
        obs_edge=jnp.asarray(obs_edge),
        edge_pose=jnp.asarray(edge_pose),
        edge_lm=jnp.asarray(edge_lm),
    )


def _accumulate(problem: BAProblem, poses, landmarks, n_edges):
    """Normal-equation accumulators from one observation shard: edge
    coupling blocks E [Ne,6,3] (the sparse H_pl), block diagonals
    H_pp [K,6,6] / H_ll [M,3,3], gradients b_p/b_l, and the cost."""
    k, m = poses.shape[0], landmarks.shape[0]
    R = poses[problem.obs_pose, :3, :3]              # [O,3,3]
    t = poses[problem.obs_pose, :3, 3]               # [O,3]
    l = landmarks[problem.obs_lm]                    # [O,3]
    d = jnp.matmul((l - t)[:, None, :], R,
                   precision=_HI)[:, 0, :]           # R^T (l - t), [O,3]
    r = d - problem.obs_z                            # [O,3]

    Jp = jnp.concatenate([se3.skew(d), -jnp.broadcast_to(
        jnp.eye(3, dtype=d.dtype), d.shape[:1] + (3, 3))], axis=-1)  # [O,3,6]
    Jl = jnp.swapaxes(R, -1, -2)                     # R^T, [O,3,3]

    w = problem.obs_w[:, None, None]
    JpT = jnp.swapaxes(Jp, -1, -2)
    JlT = jnp.swapaxes(Jl, -1, -2)
    mm = functools.partial(jnp.matmul, precision=_HI)

    H_pp = jnp.zeros((k, 6, 6), jnp.float32).at[problem.obs_pose].add(
        w * mm(JpT, Jp)
    )
    H_ll = jnp.zeros((m, 3, 3), jnp.float32).at[problem.obs_lm].add(
        w * mm(JlT, Jl)
    )
    E = jnp.zeros((n_edges, 6, 3), jnp.float32).at[problem.obs_edge].add(
        w * mm(JpT, Jl)
    )
    b_p = jnp.zeros((k, 6), jnp.float32).at[problem.obs_pose].add(
        (w * mm(JpT, r[..., None]))[..., 0]
    )
    b_l = jnp.zeros((m, 3), jnp.float32).at[problem.obs_lm].add(
        (w * mm(JlT, r[..., None]))[..., 0]
    )
    cost = jnp.sum(problem.obs_w * jnp.sum(r * r, axis=-1))
    return E, H_pp, H_ll, b_p, b_l, cost


def _landmark_inverse(H_ll, damping, axis, axis_n):
    """W = (H_ll + damping I)^{-1}, computed on landmark SHARDS when
    running under shard_map (each device inverts its M/n slice of 3x3
    blocks) and all-gathered — landmarks shard too, not just
    observations."""
    eye3 = jnp.eye(3, dtype=jnp.float32)
    damped = H_ll + damping * eye3
    if axis is None:
        return jnp.linalg.inv(damped)
    m = H_ll.shape[0]
    local = m // axis_n
    idx = jax.lax.axis_index(axis)
    my = jax.lax.dynamic_slice(damped, (idx * local, 0, 0), (local, 3, 3))
    return jax.lax.all_gather(
        jnp.linalg.inv(my), axis, axis=0, tiled=True
    )


def _edge_matvecs(E, edge_pose, edge_lm, W, n_lm):
    """Matrix-free pieces of the Schur complement built from the edge
    blocks: Hlp_x (scatter [K,6]->[M,3]), Hpl_z (gather back)."""
    mm = functools.partial(jnp.matmul, precision=_HI)

    def Hlp_x(x):                       # H_lp x : [K,6] -> [M,3]
        per_edge = mm(
            jnp.swapaxes(E, -1, -2), x[edge_pose][..., None]
        )[..., 0]                       # [Ne,3]
        return jnp.zeros((n_lm, 3), jnp.float32).at[edge_lm].add(per_edge)

    def Hpl_scatter(z, n_pose):         # H_pl z : [M,3] -> [K,6]
        per_edge = mm(E, z[edge_lm][..., None])[..., 0]   # [Ne,6]
        return jnp.zeros((n_pose, 6), jnp.float32).at[edge_pose].add(
            per_edge
        )

    return Hlp_x, Hpl_scatter


def _schur_precond(E, edge_pose, edge_lm, W, H_pp, damping, gauge):
    """Block-Jacobi preconditioner: the exact 6x6 diagonal blocks of
    S = H_pp - H_pl W H_lp (+ damping + gauge), inverted."""
    mm = functools.partial(jnp.matmul, precision=_HI)
    k = H_pp.shape[0]
    AWAt = mm(mm(E, W[edge_lm]), jnp.swapaxes(E, -1, -2))   # [Ne,6,6]
    diag = jnp.zeros((k, 6, 6), jnp.float32).at[edge_pose].add(AWAt)
    Sdiag = H_pp - diag + damping * jnp.eye(6, dtype=jnp.float32)
    Sdiag = Sdiag.at[0].add(gauge * jnp.eye(6, dtype=jnp.float32))
    return jnp.linalg.inv(Sdiag)


def _schur_step(problem, poses, landmarks, acc, damping, cg_iters,
                gauge=1e6):
    """One GN update from (psum'd) accumulators: matrix-free Schur PCG
    for the poses, closed-form back-substitution for the landmarks."""
    E, H_pp, H_ll, b_p, b_l, cost, W = acc
    k, m = H_pp.shape[0], H_ll.shape[0]
    mm = functools.partial(jnp.matmul, precision=_HI)
    Hlp_x, Hpl_scatter = _edge_matvecs(
        E, problem.edge_pose, problem.edge_lm, W, m
    )

    def Wdot(y):
        return mm(W, y[..., None])[..., 0]

    def matvec(x):                      # S x, never forming S
        Hpp_x = mm(H_pp, x[..., None])[..., 0]
        coupling = Hpl_scatter(Wdot(Hlp_x(x)), k)
        out = Hpp_x - coupling + damping * x
        return out.at[0].add(gauge * x[0])

    Minv = _schur_precond(E, problem.edge_pose, problem.edge_lm, W, H_pp,
                          damping, gauge)

    def precond(r):
        return mm(Minv, r[..., None])[..., 0]

    rhs = -(b_p - Hpl_scatter(Wdot(b_l), k))
    dp = _pcg(matvec, precond, rhs, cg_iters)

    dl = -Wdot(b_l + Hlp_x(dp))
    new_poses = jnp.matmul(poses, se3.exp_se3(dp), precision=_HI)
    return new_poses, landmarks + dl, cost


def _solve_local(problem: BAProblem, iters: int, damping: float,
                 cg_iters: int, axis: str | None, axis_n: int = 1):
    """GN loop over a (possibly sharded) observation set.  When `axis`
    is set this runs inside shard_map: obs_* hold this device's shard
    and the accumulators are psum'd before the replicated update."""
    n_edges = problem.edge_pose.shape[0]

    def body(carry, _):
        poses, landmarks = carry
        acc = _accumulate(problem, poses, landmarks, n_edges)
        if axis is not None:
            acc = jax.lax.psum(acc, axis_name=axis)
        W = _landmark_inverse(acc[2], damping, axis, axis_n)
        poses, landmarks, cost = _schur_step(
            problem, poses, landmarks, acc + (W,), damping, cg_iters
        )
        return (poses, landmarks), cost

    (poses, landmarks), costs = jax.lax.scan(
        body, (problem.poses, problem.landmarks), None, length=iters
    )
    return poses, landmarks, costs


@functools.partial(jax.jit,
                   static_argnames=("iters", "damping", "cg_iters"))
def _ba_single(problem, iters, damping, cg_iters):
    return _solve_local(problem, iters, damping, cg_iters, axis=None)


@functools.lru_cache(maxsize=None)
def _compiled_ba_sharded(mesh, axis, iters, damping, cg_iters):
    obs_spec = P(axis)
    rep = P()
    fn = jax.shard_map(
        functools.partial(_solve_local, iters=iters, damping=damping,
                          cg_iters=cg_iters, axis=axis,
                          axis_n=mesh.shape[axis]),
        mesh=mesh,
        in_specs=(BAProblem(rep, rep, obs_spec, obs_spec, obs_spec,
                            obs_spec, obs_spec, rep, rep),),
        out_specs=(rep, rep, rep), check_vma=False,
    )
    return jax.jit(fn)


def ba_solve(problem: BAProblem, mesh=None, axis: str = "sp",
             iters: int = 10, damping: float = 1e-4, cg_iters: int = 48):
    """Bundle-adjust; returns (poses [K,4,4], landmarks [M,3], costs).

    With a mesh, observations shard over `axis` (ONE psum of the
    edge/diagonal accumulators per GN iteration — O(Ne·18+K·36+M·9)
    payload, no K·M term) and the landmark-block inversion runs on
    landmark shards.  The edge list stays replicated: the PCG matvec
    is O(Ne·18) flops, far below one collective's cost at any scale
    this solver targets.
    """
    if mesh is None:
        return _ba_single(problem, iters, damping, cg_iters)

    n = mesh.shape[axis]
    o = int(problem.obs_pose.shape[0])
    m = int(problem.landmarks.shape[0])
    if o % n or m % n:
        problem = jax.tree_util.tree_map(np.asarray, problem)
        problem = make_ba_problem(
            problem.poses, problem.landmarks,
            problem.obs_pose[problem.obs_w > 0],
            problem.obs_lm[problem.obs_w > 0],
            problem.obs_z[problem.obs_w > 0],
            problem.obs_w[problem.obs_w > 0],
            pad_to=((o + n - 1) // n) * n,
            pad_landmarks_to=((m + n - 1) // n) * n,
        )

    poses, lms, costs = _compiled_ba_sharded(
        mesh, axis, iters, damping, cg_iters
    )(problem)
    return poses, lms[:m], costs  # drop landmark padding


def ba_cost(problem: BAProblem, poses=None, landmarks=None):
    """Total weighted squared residual."""
    poses = problem.poses if poses is None else poses
    landmarks = problem.landmarks if landmarks is None else landmarks
    R = poses[problem.obs_pose, :3, :3]
    t = poses[problem.obs_pose, :3, 3]
    d = jnp.matmul((landmarks[problem.obs_lm] - t)[:, None, :], R,
                   precision=_HI)[:, 0, :]
    r = d - problem.obs_z
    return jnp.sum(problem.obs_w * jnp.sum(r * r, axis=-1))


def ba_from_keyframes(keyframe_clouds, poses, grid=0.1, radius=0.05,
                      max_landmarks=8192, min_obs=2, rng=None,
                      feature_weight=2.0):
    """Harvest a BA problem from keyframe clouds + trajectory poses.

    CVO is correspondence-free, so correspondences for map refinement
    are built here the classic way: landmark candidates are a grid
    subsample of ALL keyframe clouds merged in world frame (coverage
    over the whole map, not just keyframe 0's view); each keyframe
    observes a landmark if its cloud has a point within `radius` of it
    (host-side brute-force NN — keyframe counts and cloud sizes are
    small).  Landmarks seen by fewer than `min_obs` keyframes are
    dropped — a single-observer landmark adds no pose coupling, only
    solve work — and each surviving landmark is re-initialized at the
    MEAN of its observers' matched world points, which centers the
    initial value among the drift-displaced views instead of
    inheriting one view's error.  Returns a BAProblem or None if too
    few observations.

    `feature_weight`: on continuous surfaces a position-only NN slides
    along the surface between views (the association bias behind the
    small map-cost gains noted in slam.refine_map) — so the match
    minimizes `d2_pos + lam * d2_feat` INSIDE the position radius,
    with the landmark's grid-averaged 5-dim feature vector pinning the
    correspondence to the same textured spot in every view.  `lam` is
    auto-scaled so a 1-sigma feature mismatch costs
    (feature_weight * radius/2)^2 of position distance; 0 disables
    (and featureless clouds degrade to position-only automatically).
    Calibration (80-frame rendered sequence, keyframe ATE after BA):
    position-only WORSENS the trajectory (12.9 -> 14.2 mm — the
    sliding bias realized), feature_weight=2.0 improves it
    (-> 11.5 mm) and is the default; heavier weights over-pin and
    give the bias back.

    max_landmarks defaults to 8192 (16x round 1's 512): the sparse
    edge-block solver scales in the number of observations, not K·M.
    """
    from cvo_rgbd_tpu.utils.downsample import grid_downsample

    rng = np.random.default_rng(0) if rng is None else rng
    poses = np.asarray(poses, np.float32)

    def world(cloud, T):
        valid = np.asarray(cloud.mask) > 0
        pos = np.asarray(cloud.positions)[valid]
        feat = np.asarray(cloud.features)[valid]
        return pos @ T[:3, :3].T + T[:3, 3], feat

    pairs = [world(c, T) for c, T in zip(keyframe_clouds, poses)]
    worlds = [p for p, _ in pairs]
    feats = [f for _, f in pairs]
    merged = np.concatenate(worlds, axis=0)
    merged_f = np.concatenate(feats, axis=0).astype(np.float64)
    cand, cand_f = grid_downsample(merged, merged_f, grid)
    if cand.shape[0] > max_landmarks:
        pick = rng.choice(cand.shape[0], max_landmarks, replace=False)
        cand, cand_f = cand[pick], cand_f[pick]

    # feature-distance weight: 1-sigma total feature mismatch ~
    # (feature_weight * radius/2)^2 of position cost
    fvar = float(np.mean(np.var(merged_f, axis=0)))
    nfeat = merged_f.shape[1]
    if feature_weight > 0.0 and fvar > 1e-12:
        lam = (feature_weight * 0.5 * radius) ** 2 / (nfeat * fvar)
    else:
        lam = 0.0

    obs_pose, obs_lm, obs_z, obs_w_pts = [], [], [], []
    r2 = radius * radius
    for k, ((pts_w, f_k), T) in enumerate(zip(pairs, poses)):
        # dense brute-force NN (landmark -> nearest cloud point); fine at
        # keyframe scale: max_landmarks x cloud points
        d2 = ((cand[:, None, :] - pts_w[None, :, :]) ** 2).sum(-1)
        if lam > 0.0:
            fk = f_k.astype(np.float64)
            d2f = (
                (cand_f * cand_f).sum(1)[:, None]
                + (fk * fk).sum(1)[None, :]
                - 2.0 * cand_f @ fk.T
            )
            cost = np.where(d2 < r2, d2 + lam * np.maximum(d2f, 0.0),
                            np.inf)
        else:
            cost = np.where(d2 < r2, d2, np.inf)
        j = cost.argmin(1)
        hit = np.isfinite(cost[np.arange(cand.shape[0]), j])
        if not hit.any():
            continue
        # observation = the matched point expressed in camera k's frame
        Rk, tk = T[:3, :3], T[:3, 3]
        z = (pts_w[j[hit]] - tk) @ Rk
        obs_pose.append(np.full(hit.sum(), k, np.int32))
        obs_lm.append(np.nonzero(hit)[0].astype(np.int32))
        obs_z.append(z.astype(np.float32))
        obs_w_pts.append(pts_w[j[hit]].astype(np.float32))

    if not obs_pose:
        return None
    obs_pose = np.concatenate(obs_pose)
    obs_lm = np.concatenate(obs_lm)
    obs_z = np.concatenate(obs_z)
    obs_w_pts = np.concatenate(obs_w_pts)

    counts = np.bincount(obs_lm, minlength=cand.shape[0])
    keep = counts >= max(min_obs, 1)
    if not keep.any():
        return None
    remap = np.cumsum(keep) - 1
    sel = keep[obs_lm]
    obs_pose, obs_lm, obs_z, obs_w_pts = (
        obs_pose[sel], remap[obs_lm[sel]].astype(np.int32), obs_z[sel],
        obs_w_pts[sel],
    )
    # landmark init = mean of its observers' matched world points
    m = int(keep.sum())
    sums = np.zeros((m, 3), np.float64)
    np.add.at(sums, obs_lm, obs_w_pts.astype(np.float64))
    cnt = np.bincount(obs_lm, minlength=m)[:, None]
    landmarks = (sums / np.maximum(cnt, 1)).astype(np.float32)

    return make_ba_problem(poses, landmarks, obs_pose, obs_lm, obs_z)
