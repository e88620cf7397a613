"""SE(3) pose-graph optimization — jittable Gauss-Newton on device.

The reference chains odometry into `accum_transform` with no global
consistency machinery (cvo.cpp:414; SURVEY.md section 2.6 lists
pose-graph/BA as a required extension with no reference analog).  This
module closes loops: given keyframe nodes and relative-pose edges
(odometry + loop closures from the keyframe scorer), it minimizes

    sum_e  || log( Z_e^{-1} X_i^{-1} X_j ) ||^2_{Omega_e}

by Gauss-Newton with right-multiplicative updates.  Node 0 is
gauge-fixed by a large prior.

Two solvers share the same per-edge residual/Jacobian math (batched
over edges with vmap):

- "dense" — assemble the full 6N x 6N normal equations and solve
  densely.  Exact; O(N^2) memory — right at tens of keyframes.
- "pcg" — never form H: keep per-edge 6x6 coupling blocks, accumulate
  only the N block-diagonal entries, and solve by block-Jacobi
  preconditioned CG whose matvec scatter/gathers through the edge list
  (O(E) work/memory — the pose-graph analog of parallel/ba.py's
  matrix-free Schur solver).  Scales to hundreds/thousands of nodes.

`optimize(..., solver="auto")` picks dense for small graphs, pcg
otherwise; `mesh=` shards the edge set over a mesh axis (accumulators
and the per-CG-iteration off-diagonal matvec are psum'd, the direct
scale-out of the reference's mutex-guarded reductions).

Edge Jacobians use the standard small-residual form
  d r / d xi_i = -Jr^{-1}(r) Ad(X_j^{-1} X_i),   d r / d xi_j = Jr^{-1}(r)
with the exact right-Jacobian inverse from se3.left_jacobian_se3.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core.pcg import pcg

_HI = jax.lax.Precision.HIGHEST
_GAUGE = 1e6


class PoseGraph(NamedTuple):
    """nodes [N,4,4]; edges (i [E], j [E], z [E,4,4], weight [E])."""

    nodes: jnp.ndarray
    edge_i: jnp.ndarray
    edge_j: jnp.ndarray
    edge_z: jnp.ndarray
    edge_w: jnp.ndarray


def from_odometry(poses, loop_edges=()):
    """Build a graph from absolute poses: consecutive odometry edges
    (weight 1) plus optional (i, j, Z, w) loop closures."""
    poses = np.asarray(poses)
    n = poses.shape[0]
    ei, ej, ez, ew = [], [], [], []
    for k in range(n - 1):
        ei.append(k)
        ej.append(k + 1)
        ez.append(np.linalg.inv(poses[k]) @ poses[k + 1])
        ew.append(1.0)
    for (i, j, z, w) in loop_edges:
        ei.append(i)
        ej.append(j)
        ez.append(np.asarray(z))
        ew.append(float(w))
    return PoseGraph(
        nodes=jnp.asarray(poses, jnp.float32),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_z=jnp.asarray(np.stack(ez), jnp.float32),
        edge_w=jnp.asarray(ew, jnp.float32),
    )


def _se3_inv44(X):
    R = X[..., :3, :3]
    t = X[..., :3, 3]
    Ri, ti = se3.se3_inv(R, t)
    return se3.make_se3(Ri, ti)


def _edge_residual_jac(Xi, Xj, Z):
    """r [6], Ji [6,6], Jj [6,6] for one edge."""
    mm = functools.partial(jnp.matmul, precision=_HI)
    rel = mm(_se3_inv44(Xi), Xj)
    E = mm(_se3_inv44(Z), rel)
    r = se3.log_se3(E)
    # right Jacobian inverse: Jr(r) = Jl(-r)
    Jr_inv = jnp.linalg.inv(se3.left_jacobian_se3(-r))
    Adj = se3.adjoint_se3(_se3_inv44(rel))
    Ji = -mm(Jr_inv, Adj)
    Jj = Jr_inv
    return r, Ji, Jj


def _edge_terms(nodes, edge_i, edge_j, edge_z, edge_w, huber_delta,
                robust="huber", k=None, warmup=0):
    """Per-edge normal-equation pieces: diagonal contributions
    Hii/Hjj [E,6,6], the off-diagonal coupling block B = w JiT Jj
    [E,6,6], gradient pieces bi/bj [E,6], and the cost.

    `huber_delta > 0` enables a robust kernel by IRLS (each GN
    iteration rescales edge weights from the current residual norms),
    so a wrong loop closure — a registration that converged to the
    wrong optimum but slipped past the slam outlier gates — damages
    the trajectory less than exact least squares.  delta <= 0 is exact
    least squares.  `robust` picks the kernel (STATIC under jit):

    - "huber":  w = min(1, delta/||r||).  Convex; outlier influence is
      bounded but CONSTANT (force ~ delta), so a lone far outlier
      against a free chain end still displaces it.
    - "cauchy": w = 1/(1 + ||r||^2/delta^2).  Redescending; outlier
      influence ~ delta^2/||r||, vanishing for far outliers — the
      standard choice for robust pose graphs (DCS/switchable
      constraints are equivalent reweightings).  Non-convex: relies on
      the odometry chain being a sane initialization, which is exactly
      the SLAM setting.

    The returned cost is the matching robust cost, monotone under the
    same IRLS iteration.

    `k`/`warmup` implement GRADUATED robustification for the
    redescending Cauchy kernel: a genuine loop closure that corrects
    large odometry drift starts with ||r|| far above delta, where
    Cauchy's weight ~ delta^2/||r||^2 can suppress the correction and
    let the non-convex IRLS equilibrate with the loop ignored.  The
    first `warmup` GN iterations therefore run the CONVEX Huber kernel
    (bounded but non-vanishing outlier influence pulls the chain into
    the loop's basin); iterations k >= warmup switch to Cauchy, which
    then zeroes out any edge still far off — i.e. an actual outlier."""
    r, Ji, Jj = jax.vmap(_edge_residual_jac)(
        nodes[edge_i], nodes[edge_j], edge_z
    )
    rn2 = jnp.sum(r * r, axis=-1)
    rn = jnp.sqrt(rn2 + 1e-12)
    d2 = huber_delta * huber_delta
    h_scale = jnp.minimum(1.0, huber_delta / rn)
    h_rho = jnp.where(
        rn > huber_delta, huber_delta * (2.0 * rn - huber_delta), rn2
    )
    if robust == "cauchy":
        scale = 1.0 / (1.0 + rn2 / jnp.maximum(d2, 1e-12))
        rho = d2 * jnp.log1p(rn2 / jnp.maximum(d2, 1e-12))
        if warmup and k is not None:
            in_warm = k < warmup
            scale = jnp.where(in_warm, h_scale, scale)
            rho = jnp.where(in_warm, h_rho, rho)
    elif robust == "huber":
        scale, rho = h_scale, h_rho
    else:
        raise ValueError(f"unknown robust kernel {robust!r}")
    use = huber_delta > 0.0
    w_e = edge_w * jnp.where(use, scale, 1.0)
    w = w_e[:, None, None]
    mm = functools.partial(jnp.matmul, precision=_HI)
    JiT = jnp.swapaxes(Ji, -1, -2)
    JjT = jnp.swapaxes(Jj, -1, -2)
    Hii = w * mm(JiT, Ji)
    Hjj = w * mm(JjT, Jj)
    B = w * mm(JiT, Jj)
    bi = (w * mm(JiT, r[..., None]))[..., 0]
    bj = (w * mm(JjT, r[..., None]))[..., 0]
    cost = jnp.sum(edge_w * jnp.where(use, rho, rn2))
    return Hii, Hjj, B, bi, bj, cost


def _apply_update(nodes, delta):
    # right-multiplicative update X <- X exp(delta); pinned fp32 — the
    # bf16 matmul default biases pose chains at mm level (CLAUDE.md)
    return jnp.matmul(nodes, se3.exp_se3(delta), precision=_HI)


def _gn_step_dense(nodes, edge_i, edge_j, edge_z, edge_w, damping,
                   huber_delta, robust, k=None, warmup=0):
    n = nodes.shape[0]
    Hii, Hjj, B, bi, bj, cost = _edge_terms(
        nodes, edge_i, edge_j, edge_z, edge_w, huber_delta, robust,
        k=k, warmup=warmup,
    )
    H = jnp.zeros((n, n, 6, 6), jnp.float32)
    b = jnp.zeros((n, 6), jnp.float32)
    H = H.at[edge_i, edge_i].add(Hii)
    H = H.at[edge_j, edge_j].add(Hjj)
    H = H.at[edge_i, edge_j].add(B)
    H = H.at[edge_j, edge_i].add(jnp.swapaxes(B, -1, -2))
    b = b.at[edge_i].add(bi)
    b = b.at[edge_j].add(bj)

    # gauge fix node 0: huge prior on its increment
    H = H.at[0, 0].add(_GAUGE * jnp.eye(6))

    Hd = H.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    Hd = Hd + damping * jnp.eye(6 * n)
    bd = b.reshape(6 * n)
    delta = jnp.linalg.solve(Hd, -bd).reshape(n, 6)
    return _apply_update(nodes, delta), cost


def _gn_step_pcg(nodes, edge_i, edge_j, edge_z, edge_w, damping, cg_iters,
                 huber_delta=0.0, robust="huber", axis=None, k=None,
                 warmup=0):
    """Sparse GN step: block-diagonal accumulation + edge-block
    matrix-free PCG.  Under shard_map (`axis` set) the edge arrays hold
    this device's shard; accumulators and the matvec's off-diagonal
    scatter are psum'd."""
    n = nodes.shape[0]
    mm = functools.partial(jnp.matmul, precision=_HI)
    Hii, Hjj, B, bi, bj, cost = _edge_terms(
        nodes, edge_i, edge_j, edge_z, edge_w, huber_delta, robust,
        k=k, warmup=warmup,
    )
    Hd = (
        jnp.zeros((n, 6, 6), jnp.float32)
        .at[edge_i].add(Hii)
        .at[edge_j].add(Hjj)
    )
    b = jnp.zeros((n, 6), jnp.float32).at[edge_i].add(bi).at[edge_j].add(bj)
    if axis is not None:
        Hd, b, cost = jax.lax.psum((Hd, b, cost), axis_name=axis)

    eye6 = jnp.eye(6, dtype=jnp.float32)
    Hd = Hd.at[0].add(_GAUGE * eye6)           # gauge prior
    BT = jnp.swapaxes(B, -1, -2)

    def matvec(x):                              # H x, never forming H
        off = (
            jnp.zeros_like(x)
            .at[edge_i].add(mm(B, x[edge_j][..., None])[..., 0])
            .at[edge_j].add(mm(BT, x[edge_i][..., None])[..., 0])
        )
        if axis is not None:
            off = jax.lax.psum(off, axis_name=axis)
        return mm(Hd, x[..., None])[..., 0] + damping * x + off

    Minv = jnp.linalg.inv(Hd + damping * eye6)  # block-Jacobi

    def precond(r):
        return mm(Minv, r[..., None])[..., 0]

    delta = pcg(matvec, precond, -b, cg_iters)
    return _apply_update(nodes, delta), cost


def _run(step, graph, iters):
    def body(nodes, k):
        return step(nodes, k)

    return jax.lax.scan(body, graph.nodes, jnp.arange(iters))


@functools.partial(jax.jit,
                   static_argnames=("iters", "robust", "warmup"))
def _optimize_dense(graph: PoseGraph, iters: int, damping: float,
                    huber_delta: float, robust: str, warmup: int = 0):
    return _run(
        lambda nodes, k: _gn_step_dense(
            nodes, graph.edge_i, graph.edge_j, graph.edge_z, graph.edge_w,
            damping, huber_delta, robust, k=k, warmup=warmup,
        ),
        graph, iters,
    )


@functools.partial(jax.jit,
                   static_argnames=("iters", "cg_iters", "robust", "warmup"))
def _optimize_pcg(graph: PoseGraph, iters: int, damping: float,
                  cg_iters: int, huber_delta: float, robust: str,
                  warmup: int = 0):
    return _run(
        lambda nodes, k: _gn_step_pcg(
            nodes, graph.edge_i, graph.edge_j, graph.edge_z, graph.edge_w,
            damping, cg_iters, huber_delta, robust, k=k, warmup=warmup,
        ),
        graph, iters,
    )


@functools.lru_cache(maxsize=None)
def _compiled_pcg_sharded(mesh, axis, iters, damping, cg_iters,
                          huber_delta, robust, warmup=0):
    from jax.sharding import PartitionSpec as P

    def solve(graph):
        return _run(
            lambda nodes, k: _gn_step_pcg(
                nodes, graph.edge_i, graph.edge_j, graph.edge_z,
                graph.edge_w, damping, cg_iters, huber_delta, robust,
                axis=axis, k=k, warmup=warmup,
            ),
            graph, iters,
        )

    es = P(axis)
    rep = P()
    return jax.jit(jax.shard_map(
        solve, mesh=mesh,
        in_specs=(PoseGraph(rep, es, es, es, es),),
        out_specs=(rep, rep), check_vma=False,
    ))


def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None, mesh=None,
             axis: str = "sp", huber_delta: float = 0.0,
             robust: str = "huber", robust_warmup: int = 0):
    """Gauss-Newton; returns (optimized nodes [N,4,4], costs [iters]).

    solver: "dense" (exact 6Nx6N solve, O(N^2) memory), "pcg"
    (edge-block matrix-free, O(E)), or "auto" (dense up to 64 nodes).
    `cg_iters` defaults to 2N: with a block-Jacobi preconditioner CG
    propagates corrections about one graph hop per iteration, so
    chain-like graphs need O(N) iterations (each matvec is only O(E)
    6x6 work — still far below the dense solve).  `mesh` shards the
    edge set over `axis` (forces pcg); edges are padded with weight-0
    self-loops to a multiple of the axis size (zero weight contributes
    nothing anywhere).

    `huber_delta > 0` turns on a robust kernel (IRLS: edge weights
    rescale from the current residual norms every GN iteration), which
    contains the damage of a wrong loop closure; 0 = exact least
    squares (default, the historical behavior).  With
    robust="cauchy", `robust_warmup` > 0 runs the first iterations
    under the convex Huber kernel before switching to the redescending
    Cauchy — graduated robustification, so genuine loop corrections
    whose initial residuals sit far above delta are pulled into their
    basin before Cauchy's vanishing weight could freeze them out (see
    `_edge_terms`).
    """
    n = int(graph.nodes.shape[0])
    if solver == "auto":
        solver = "dense" if n <= 64 and mesh is None else "pcg"
    if cg_iters is None:
        cg_iters = max(64, 2 * n)
    if mesh is not None:
        nsh = mesh.shape[axis]
        e = int(graph.edge_i.shape[0])
        if e % nsh:
            pad = ((e + nsh - 1) // nsh) * nsh - e
            graph = PoseGraph(
                nodes=graph.nodes,
                edge_i=jnp.concatenate(
                    [graph.edge_i, jnp.zeros(pad, jnp.int32)]),
                edge_j=jnp.concatenate(
                    [graph.edge_j, jnp.zeros(pad, jnp.int32)]),
                edge_z=jnp.concatenate([
                    graph.edge_z,
                    jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                     (pad, 4, 4)),
                ]),
                edge_w=jnp.concatenate(
                    [graph.edge_w, jnp.zeros(pad, jnp.float32)]),
            )
        return _compiled_pcg_sharded(mesh, axis, iters, damping,
                                     cg_iters, huber_delta, robust,
                                     robust_warmup)(graph)
    if solver == "dense":
        return _optimize_dense(graph, iters, damping, huber_delta, robust,
                               robust_warmup)
    return _optimize_pcg(graph, iters, damping, cg_iters, huber_delta,
                         robust, robust_warmup)


def graph_cost(graph: PoseGraph, nodes=None):
    """Total weighted squared residual of the graph."""
    nodes = graph.nodes if nodes is None else nodes
    Xi = nodes[graph.edge_i]
    Xj = nodes[graph.edge_j]

    def res(Xi, Xj, Z):
        mm = functools.partial(jnp.matmul, precision=_HI)
        return se3.log_se3(mm(mm(_se3_inv44(Z), _se3_inv44(Xi)), Xj))

    r = jax.vmap(res)(Xi, Xj, graph.edge_z)
    return jnp.sum(graph.edge_w * jnp.sum(r * r, axis=-1))
