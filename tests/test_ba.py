"""Distributed bundle adjustment: Schur-complement GN over collectives.

Synthetic BA: known poses + landmarks, noisy 3-D observations,
perturbed initial guesses — the solver must recover the ground truth
(up to the pose-0 gauge, which we pin to the truth), and the sharded
solve must match the single-device solve (SURVEY.md section 2.6 / 5:
determinism of psum reductions at fixed mesh shape).
"""

import numpy as np
import pytest

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.parallel import ba_cost, ba_solve, make_ba_problem, make_mesh


def _synthetic(rng, k=6, m=40, noise=0.0, perturb=0.05):
    landmarks = rng.uniform(-1, 1, (m, 3)).astype(np.float32) + [0, 0, 3.0]
    poses = []
    for i in range(k):
        xi = np.concatenate([
            rng.normal(0, 0.1, 3), rng.normal(0, 0.3, 3)]).astype(np.float32)
        poses.append(np.asarray(se3.exp_se3(xi)))
    poses = np.stack(poses)

    obs_pose, obs_lm, obs_z = [], [], []
    for i in range(k):
        R, t = poses[i, :3, :3], poses[i, :3, 3]
        z = (landmarks - t) @ R  # R^T (l - t)
        obs_pose.append(np.full(m, i, np.int32))
        obs_lm.append(np.arange(m, dtype=np.int32))
        obs_z.append(z + rng.normal(0, noise, z.shape))

    init_poses = poses.copy()
    for i in range(1, k):  # pose 0 is the gauge: keep it at truth
        xi = rng.normal(0, perturb, 6).astype(np.float32)
        init_poses[i] = init_poses[i] @ np.asarray(se3.exp_se3(xi))
    init_lms = landmarks + rng.normal(0, perturb, landmarks.shape)

    problem = make_ba_problem(
        init_poses, init_lms,
        np.concatenate(obs_pose), np.concatenate(obs_lm),
        np.concatenate(obs_z).astype(np.float32),
    )
    return problem, poses, landmarks


def test_ba_recovers_ground_truth(rng):
    problem, gt_poses, gt_lms = _synthetic(rng)
    poses, lms, costs = ba_solve(problem, iters=12)
    np.testing.assert_allclose(np.asarray(poses), gt_poses, atol=1e-3)
    np.testing.assert_allclose(np.asarray(lms), gt_lms, atol=1e-3)
    assert float(costs[-1]) < 1e-8
    assert float(costs[-1]) <= float(costs[0])


def test_ba_noisy_converges(rng):
    problem, gt_poses, _ = _synthetic(rng, noise=0.005)
    c0 = float(ba_cost(problem))
    poses, _, costs = ba_solve(problem, iters=10)
    assert float(costs[-1]) < c0
    # pose error well below the initial 0.05 perturbation
    err = [float(se3.dist_se3(
        (np.linalg.inv(gt_poses[i]) @ np.asarray(poses[i]))[:3, :3],
        (np.linalg.inv(gt_poses[i]) @ np.asarray(poses[i]))[:3, 3],
    )) for i in range(gt_poses.shape[0])]
    assert max(err) < 0.02


@pytest.mark.parametrize("axes", [{"sp": 8}, {"sp": 4}])
def test_ba_sharded_matches_single(rng, axes):
    problem, _, _ = _synthetic(rng, k=5, m=33, noise=0.002)  # odd obs count
    mesh = make_mesh(axes)
    p_ref, l_ref, c_ref = ba_solve(problem, iters=8)
    p_sh, l_sh, c_sh = ba_solve(problem, mesh=mesh, iters=8)
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_ref), atol=2e-4)
    np.testing.assert_allclose(np.asarray(l_sh), np.asarray(l_ref), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(c_sh), np.asarray(c_ref), rtol=1e-4, atol=1e-7)


def test_ba_sharded_deterministic(rng):
    problem, _, _ = _synthetic(rng, noise=0.01)
    mesh = make_mesh({"sp": 8})
    a = np.asarray(ba_solve(problem, mesh=mesh, iters=6)[0])
    b = np.asarray(ba_solve(problem, mesh=mesh, iters=6)[0])
    np.testing.assert_array_equal(a, b)


def test_ba_partial_observations(rng):
    """Landmarks seen by only some poses; unobserved landmarks stay put."""
    problem, gt_poses, gt_lms = _synthetic(rng, k=4, m=30)
    # drop all observations of landmark 7 by zero-weighting them
    w = np.asarray(problem.obs_w).copy()
    w[np.asarray(problem.obs_lm) == 7] = 0.0
    problem = problem._replace(obs_w=np.asarray(w, np.float32))
    poses, lms, _ = ba_solve(problem, iters=10)
    np.testing.assert_allclose(np.asarray(poses), gt_poses, atol=1e-3)
    # landmark 7 had no constraints: must not move
    np.testing.assert_allclose(
        np.asarray(lms[7]), np.asarray(problem.landmarks[7]), atol=1e-5)


def test_ba_from_keyframes(rng):
    """End-to-end harvest: keyframe clouds along a trajectory refine
    back to consistency after pose perturbation."""
    from cvo_rgbd_tpu import pad_cloud
    from cvo_rgbd_tpu.parallel import ba_from_keyframes

    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32) + [0, 0, 2.5]
    poses, clouds = [], []
    for i in range(4):
        xi = np.concatenate([rng.normal(0, 0.05, 3),
                             rng.normal(0, 0.2, 3)]).astype(np.float32)
        T = np.asarray(se3.exp_se3(xi))
        poses.append(T)
        local = (pts - T[:3, 3]) @ T[:3, :3]
        clouds.append(pad_cloud(local.astype(np.float32),
                                np.zeros((200, 5), np.float32),
                                capacity=256))
    poses = np.stack(poses)
    bad = poses.copy()
    for i in range(1, 4):
        bad[i] = bad[i] @ np.asarray(
            se3.exp_se3(rng.normal(0, 0.02, 6).astype(np.float32)))

    problem = ba_from_keyframes(clouds, bad, grid=0.3, radius=0.25)
    assert problem is not None
    c0 = float(ba_cost(problem))
    new_poses, _, costs = ba_solve(problem, iters=8)
    # landmarks now initialize at the mean of their observers' world
    # points, so c0 starts much closer to the optimum than the old
    # grid-candidate init — the drop is smaller but still substantial
    assert float(costs[-1]) < c0 * 0.75
    # refined poses closer to truth than the perturbed input
    def err(P):
        return sum(
            float(np.linalg.norm((np.linalg.inv(poses[i]) @ P[i])[:3, 3]))
            for i in range(1, 4))
    assert err(np.asarray(new_poses)) < err(bad)


def _synthetic_sparse(rng, k=16, m=5000, obs_per_lm=4, noise=0.001,
                      perturb=0.03):
    """Partial-visibility problem at map scale: each landmark observed
    by a few random keyframes — the sparse edge structure the
    edge-block Schur solver is built for."""
    landmarks = rng.uniform(-2, 2, (m, 3)).astype(np.float32) + [0, 0, 4.0]
    poses = []
    for i in range(k):
        xi = np.concatenate([
            rng.normal(0, 0.05, 3), rng.normal(0, 0.2, 3)]).astype(np.float32)
        poses.append(np.asarray(se3.exp_se3(xi)))
    poses = np.stack(poses)

    obs_pose = np.stack(
        [rng.choice(k, obs_per_lm, replace=False) for _ in range(m)]
    ).astype(np.int32).ravel()
    obs_lm = np.repeat(np.arange(m, dtype=np.int32), obs_per_lm)
    R = poses[obs_pose, :3, :3]
    t = poses[obs_pose, :3, 3]
    z = np.einsum("oi,oij->oj", landmarks[obs_lm] - t, R)
    z = (z + rng.normal(0, noise, z.shape)).astype(np.float32)

    init_poses = poses.copy()
    for i in range(1, k):
        xi = rng.normal(0, perturb, 6).astype(np.float32)
        init_poses[i] = init_poses[i] @ np.asarray(se3.exp_se3(xi))
    init_lms = (landmarks + rng.normal(0, perturb, landmarks.shape)).astype(
        np.float32
    )
    problem = make_ba_problem(init_poses, init_lms, obs_pose, obs_lm, z)
    return problem, poses, landmarks


def test_ba_map_scale_sparse(rng):
    """K=16 keyframes x M=5000 landmarks (20k observations): far past
    the dense-H_pl ceiling of round 1 (max_landmarks=512)."""
    problem, gt_poses, gt_lms = _synthetic_sparse(rng)
    assert problem.landmarks.shape[0] == 5000
    assert problem.edge_pose.shape[0] == 20000  # one edge per obs here
    poses, lms, costs = ba_solve(problem, iters=8)
    assert float(costs[-1]) < 1e-3 * float(costs[0])
    np.testing.assert_allclose(np.asarray(poses), gt_poses, atol=5e-3)
    err = np.linalg.norm(np.asarray(lms) - gt_lms, axis=1)
    assert np.median(err) < 5e-3


def test_ba_map_scale_sharded_matches(rng):
    problem, _, _ = _synthetic_sparse(rng, k=16, m=5003)  # uneven shard
    mesh = make_mesh({"sp": 8})
    p_ref, l_ref, c_ref = ba_solve(problem, iters=5)
    p_sh, l_sh, c_sh = ba_solve(problem, mesh=mesh, iters=5)
    np.testing.assert_allclose(np.asarray(p_sh), np.asarray(p_ref),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(l_sh), np.asarray(l_ref),
                               atol=5e-4)


def test_feature_weighted_association_pins_texture(rng):
    """The round-5 association mechanism.  Two views of a dense
    textured surface, view 1 carrying unmodeled drift: a position-only
    NN matches both views to the nearest WORLD point (different
    material points, offset by the drift), while the feature term
    pulls both views toward the same MATERIAL point.  Metric: for each
    landmark observed by both views, the material-coordinate gap
    |(x1_world - drift) - x0_world|; a strong feature weight must
    shrink it well below the position-only association's.  (The
    production default 2.0 is calibrated on rendered sequences where
    it minimizes post-BA keyframe ATE — parallel/ba.py docstring; this
    test pins the mechanism's direction, not the calibration.)"""
    from cvo_rgbd_tpu import pad_cloud
    from cvo_rgbd_tpu.parallel import ba_from_keyframes

    drift = np.array([0.012, 0.0, 0.0], np.float32)
    n = 240
    xy = rng.uniform(0, 0.16, (n, 2)).astype(np.float32)
    pts = np.concatenate([xy, np.full((n, 1), 2.0, np.float32)], 1)
    feat = np.stack([
        4000 * pts[:, 0], 4000 * pts[:, 1],
        2000 * (pts[:, 0] + pts[:, 1]),
        np.zeros(n, np.float32), np.zeros(n, np.float32),
    ], 1).astype(np.float32)
    c0 = pad_cloud(pts, feat, capacity=256)
    c1 = pad_cloud(pts + drift, feat, capacity=256)
    T = np.eye(4, dtype=np.float32)

    def material_gap(fw):
        prob = ba_from_keyframes([c0, c1], np.stack([T, T]), grid=0.015,
                                 radius=0.02, min_obs=2,
                                 feature_weight=fw)
        op = np.asarray(prob.obs_pose)
        ol = np.asarray(prob.obs_lm)
        z = np.asarray(prob.obs_z)          # pose = I: z IS world
        gaps = []
        for li in np.unique(ol):
            w0 = z[(ol == li) & (op == 0)]
            w1 = z[(ol == li) & (op == 1)]
            if len(w0) and len(w1):
                gaps.append(np.linalg.norm((w1[0] - drift) - w0[0]))
        return float(np.mean(gaps)), len(gaps)

    g_pos, n_pos = material_gap(0.0)
    g_strong, n_strong = material_gap(8.0)
    assert n_pos > 20 and n_strong > 20
    assert g_pos > 0.5 * float(np.linalg.norm(drift)), g_pos
    assert g_strong < 0.6 * g_pos, (g_strong, g_pos)
