"""Pose-graph optimization tests: loop closure pulls drifted odometry
back to ground truth."""

import numpy as np

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core.posegraph import (
    from_odometry,
    graph_cost,
    optimize,
)


def _se3(w, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(se3.exp_so3(np.asarray(w, np.float32)))
    T[:3, 3] = t
    return T


def test_consistent_graph_zero_cost(rng):
    """Odometry edges built from the poses themselves: cost 0, optimize
    is a no-op."""
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(5):
        poses.append(poses[-1] @ _se3([0.01, 0, 0.02], [0.1, 0, 0]))
    g = from_odometry(np.stack(poses))
    assert float(graph_cost(g)) < 1e-10
    nodes, costs = optimize(g, iters=3)
    np.testing.assert_allclose(np.asarray(nodes), np.stack(poses), atol=1e-4)


def test_loop_closure_corrects_drift(rng):
    """Square loop with per-step drift; a loop-closure edge to the start
    redistributes the error."""
    # ground truth: walk a square, return to start
    gt = [np.eye(4, dtype=np.float32)]
    steps = (
        [_se3([0, 0, 0], [1, 0, 0])] * 2
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
    )
    for s in steps:
        gt.append(gt[-1] @ s)
    gt = np.stack(gt)

    # drifted odometry: each measured step slightly wrong
    drift = _se3([0, 0, 0.02], [0.03, 0.01, 0])
    noisy = [gt[0]]
    for s in steps:
        noisy.append(noisy[-1] @ s @ drift)
    noisy = np.stack(noisy)
    start_err = np.linalg.norm(noisy[-1][:3, 3] - gt[-1][:3, 3])
    assert start_err > 0.1  # drift is visible

    # loop closure: final pose observes the true relative pose to node 0
    z_loop = np.linalg.inv(gt[0]) @ gt[-1]
    g = from_odometry(noisy, loop_edges=[(0, len(gt) - 1, z_loop, 10.0)])
    nodes, costs = optimize(g, iters=15)
    nodes = np.asarray(nodes)

    end_err = np.linalg.norm(nodes[-1][:3, 3] - gt[-1][:3, 3])
    assert end_err < 0.05, (start_err, end_err)
    # cost decreases monotonically-ish and substantially
    assert float(costs[-1]) < 0.1 * float(costs[0])
    # intermediate nodes also improve
    mid_err_before = np.linalg.norm(noisy[4][:3, 3] - gt[4][:3, 3])
    mid_err_after = np.linalg.norm(nodes[4][:3, 3] - gt[4][:3, 3])
    assert mid_err_after < mid_err_before


def test_gauge_fixed(rng):
    poses = [np.eye(4, dtype=np.float32)]
    for k in range(4):
        poses.append(poses[-1] @ _se3([0, 0.01, 0], [0.2, 0, 0.05]))
    g = from_odometry(np.stack(poses))
    nodes, _ = optimize(g, iters=5)
    np.testing.assert_allclose(np.asarray(nodes)[0], np.eye(4), atol=1e-4)


def _drifted_square_graph():
    """The loop-closure fixture of test_loop_closure_corrects_drift."""
    gt = [np.eye(4, dtype=np.float32)]
    steps = (
        [_se3([0, 0, 0], [1, 0, 0])] * 2
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
        + [_se3([0, 0, np.pi / 2], [1, 0, 0])]
        + [_se3([0, 0, 0], [1, 0, 0])]
    )
    for s in steps:
        gt.append(gt[-1] @ s)
    gt = np.stack(gt)
    drift = _se3([0, 0, 0.02], [0.03, 0.01, 0])
    noisy = [gt[0]]
    for s in steps:
        noisy.append(noisy[-1] @ s @ drift)
    z_loop = np.linalg.inv(gt[0]) @ gt[-1]
    return gt, from_odometry(
        np.stack(noisy), loop_edges=[(0, len(gt) - 1, z_loop, 10.0)]
    )


def test_pcg_matches_dense(rng):
    """The sparse edge-block PCG solver agrees with the dense 6Nx6N
    solve on the same graph."""
    _, g = _drifted_square_graph()
    nodes_d, costs_d = optimize(g, iters=10, solver="dense")
    nodes_p, costs_p = optimize(g, iters=10, solver="pcg", cg_iters=96)
    np.testing.assert_allclose(
        np.asarray(nodes_p), np.asarray(nodes_d), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(costs_p), np.asarray(costs_d), rtol=1e-3, atol=1e-6
    )


def test_pcg_sharded_matches(rng):
    """Edge-sharded (shard_map + psum) PCG equals the single-device
    solution on the 8-device mesh, including weight-0 edge padding."""
    from cvo_rgbd_tpu.parallel import make_mesh

    _, g = _drifted_square_graph()  # 9 edges -> padded to 16 over sp=8
    mesh = make_mesh({"sp": 8})
    nodes_s, costs_s = optimize(g, iters=10, mesh=mesh, cg_iters=96)
    nodes_p, costs_p = optimize(g, iters=10, solver="pcg", cg_iters=96)
    np.testing.assert_allclose(
        np.asarray(nodes_s), np.asarray(nodes_p), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(costs_s), np.asarray(costs_p), rtol=1e-5, atol=1e-8
    )


def test_large_graph_pcg(rng):
    """512-node corridor with drifted odometry + 8 ground-truth loop
    closures: the sparse solver (the dense path would be a 3072x3072
    solve per iteration) pulls the endpoint error down by >5x."""
    n = 512
    gt = [np.eye(4, dtype=np.float32)]
    steps = []
    for k in range(n - 1):
        # snake: forward with a slow turn, so revisits exist
        steps.append(_se3([0, 0, 0.012], [0.2, 0, 0.01]))
        gt.append(gt[-1] @ steps[-1])
    gt = np.stack(gt)

    drift = _se3([0, 0, 8e-4], [2e-3, 5e-4, 0])
    noisy = [gt[0]]
    for s in steps:
        noisy.append(noisy[-1] @ s @ drift)
    noisy = np.stack(noisy)

    # revisit-style closures: the camera re-observes the start every 64
    # frames (long-range edges, like a real loopy trajectory)
    loops = []
    for j in range(64, n, 64):
        z = np.linalg.inv(gt[0]) @ gt[j]
        loops.append((0, j, z, 10.0))
    g = from_odometry(noisy, loop_edges=loops)

    start_err = np.linalg.norm(noisy[-1][:3, 3] - gt[-1][:3, 3])
    nodes, costs = optimize(g, iters=8, solver="pcg")
    nodes = np.asarray(nodes)
    assert np.isfinite(nodes).all()
    end_err = np.linalg.norm(nodes[-1][:3, 3] - gt[-1][:3, 3])
    assert end_err < start_err / 5, (start_err, end_err)
    assert float(costs[-1]) < 0.2 * float(costs[0])


def test_robust_kernel_contains_bad_loop_edge(rng):
    """A WRONG loop closure (high weight, large false correction) bends
    the exact-least-squares solution; the redescending Cauchy kernel
    IRLS-rejects it from the odometry initialization.  Good edges
    (residuals << delta) are untouched, so the robust solve on a clean
    graph equals the exact one."""
    gt = [np.eye(4, dtype=np.float32)]
    step = _se3([0, 0, 0.02], [0.25, 0, 0])
    for _ in range(12):
        gt.append(gt[-1] @ step)
    gt = np.stack(gt)

    # clean graph: robust == exact
    g_clean = from_odometry(gt)
    n_exact, _ = optimize(g_clean, iters=8)
    n_rob, _ = optimize(g_clean, iters=8, huber_delta=0.3, robust="cauchy")
    np.testing.assert_allclose(np.asarray(n_rob), np.asarray(n_exact),
                               atol=1e-5)

    # good loop closures pin the shape (without them a chain + one bad
    # edge is DEGENERATE: a rigid rotation about the gauge node
    # satisfies any single loop edge at zero odometry cost, and no
    # robust kernel can object) ... plus one wrong loop edge claiming
    # node 11 sits near node 0
    good = [
        (0, 6, np.linalg.inv(gt[0]) @ gt[6], 5.0),
        (3, 9, np.linalg.inv(gt[3]) @ gt[9], 5.0),
        (0, 12, np.linalg.inv(gt[0]) @ gt[12], 5.0),
    ]
    z_bad = _se3([0, 0, 0.4], [0.5, 0.3, 0])
    bad = [(0, 11, z_bad, 5.0)]
    g_bad = from_odometry(gt, loop_edges=good + bad)
    n_ls, _ = optimize(g_bad, iters=12)
    n_cau, _ = optimize(g_bad, iters=12, huber_delta=0.15, robust="cauchy")
    err_ls = np.linalg.norm(np.asarray(n_ls)[11][:3, 3] - gt[11][:3, 3])
    err_cau = np.linalg.norm(np.asarray(n_cau)[11][:3, 3] - gt[11][:3, 3])
    # exact LS compromises between good and bad edges; Cauchy rejects
    # the bad edge and lands back near ground truth (the residual
    # displacement is the IRLS equilibrium w_bad/(w_bad + w_odom),
    # which shrinks quadratically with delta)
    assert err_ls > 0.05, err_ls
    assert err_cau < 0.1 * err_ls, (err_ls, err_cau)

    # huber (convex, constant outlier force) cannot reject the far
    # outlier — its IRLS equilibrium still leans on the bad edge; this
    # is WHY the slam default is cauchy.  It must at least run and
    # produce finite poses.
    n_hub, _ = optimize(g_bad, iters=12, huber_delta=0.3, robust="huber")
    assert np.isfinite(np.asarray(n_hub)).all()

    # pcg path agrees with dense under the robust kernel
    n_pcg, _ = optimize(g_bad, iters=12, huber_delta=0.15, robust="cauchy",
                        solver="pcg")
    np.testing.assert_allclose(np.asarray(n_pcg), np.asarray(n_cau),
                               atol=5e-3)


def test_graduated_cauchy_lands_large_true_correction(rng):
    """GOOD loop edges whose initial residuals sit far ABOVE the Cauchy
    delta (the regime slam actually admits: corrections up to
    loop_prior_max ~ 1.0 against huber_delta=0.3).  Pure Cauchy IRLS
    weights such an edge ~ delta^2/r^2 << 1 from the start and can
    equilibrate with the genuine correction suppressed; the graduated
    schedule (`robust_warmup`: convex Huber first, Cauchy after) must
    land the correction."""
    n = 25
    gt = [np.eye(4, dtype=np.float32)]
    steps = []
    for k in range(n - 1):
        steps.append(_se3([0, 0, 0.02], [0.25, 0, 0]))
        gt.append(gt[-1] @ steps[-1])
    gt = np.stack(gt)

    # heavy drift: endpoint lands far from truth, so the ground-truth
    # loop edges open with residuals ~ 1 >> delta=0.3
    drift = _se3([0, 0, 1.2e-2], [3e-2, 1.6e-2, 0])
    noisy = [gt[0]]
    for s in steps:
        noisy.append(noisy[-1] @ s @ drift)
    noisy = np.stack(noisy)

    loops = [
        (0, 12, np.linalg.inv(gt[0]) @ gt[12], 5.0),
        (0, 24, np.linalg.inv(gt[0]) @ gt[24], 5.0),
        (6, 18, np.linalg.inv(gt[6]) @ gt[18], 5.0),
    ]
    g = from_odometry(noisy, loop_edges=loops)

    # the premise of the test: the loop residuals at the odometry
    # initialization really are far above delta
    from cvo_rgbd_tpu.core.posegraph import _se3_inv44
    import jax.numpy as jnp

    r0 = max(
        float(jnp.linalg.norm(se3.log_se3(jnp.asarray(
            np.linalg.inv(z) @ np.linalg.inv(noisy[i]) @ noisy[j],
            np.float32))))
        for i, j, z, _ in loops
    )
    assert r0 > 3 * 0.3, r0

    start_err = np.linalg.norm(noisy[-1][:3, 3] - gt[-1][:3, 3])
    n_grad, costs = optimize(g, iters=15, huber_delta=0.3,
                             robust="cauchy", robust_warmup=5)
    err_grad = np.linalg.norm(np.asarray(n_grad)[-1][:3, 3] - gt[-1][:3, 3])
    # the graduated solve must actually land the loop correction
    assert err_grad < 0.1 * start_err, (start_err, err_grad)

    # and must do at least as well as cold Cauchy in this regime
    n_cold, _ = optimize(g, iters=15, huber_delta=0.3, robust="cauchy")
    err_cold = np.linalg.norm(np.asarray(n_cold)[-1][:3, 3] - gt[-1][:3, 3])
    assert err_grad <= err_cold * 1.05 + 1e-4, (err_grad, err_cold)

    # graduated schedule still rejects an actual outlier in the same
    # solve: add a wrong edge and check containment
    z_bad = _se3([0, 0, 0.5], [0.8, 0.4, 0])
    g_bad = from_odometry(noisy, loop_edges=loops + [(2, 22, z_bad, 5.0)])
    n_rob, _ = optimize(g_bad, iters=15, huber_delta=0.3,
                        robust="cauchy", robust_warmup=5)
    err_rob = np.linalg.norm(np.asarray(n_rob)[-1][:3, 3] - gt[-1][:3, 3])
    assert err_rob < 0.15 * start_err, (start_err, err_rob)
