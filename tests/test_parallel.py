"""Multi-device tests on the virtual 8-CPU mesh: sharded/ring/batched
align must agree with the single-device reference implementation."""

import functools

import jax
import numpy as np
import pytest

from cvo_rgbd_tpu import AcvoParams, CvoParams, align_jit, pad_cloud, se3
from cvo_rgbd_tpu.core.cloud import PointCloud
from cvo_rgbd_tpu.parallel import align_batched, align_sharded, make_mesh
from cvo_rgbd_tpu.parallel.sharded import align_ring


def _pair(rng, n=96, cap=256):
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60])).astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    x = pad_cloud(base[:n], feat[:n], capacity=cap)
    y = pad_cloud(yp, feat[20:20 + n], capacity=cap)
    return x, y


def test_eight_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("params", [CvoParams(max_iter=40), AcvoParams(max_iter=40)])
def test_align_sharded_matches_single(rng, params):
    x, y = _pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(params, x, y)
    got = jax.jit(
        functools.partial(align_sharded, params, mesh), static_argnums=()
    )(x, y)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf), atol=2e-5)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1


def test_align_sharded_linear_color_mode(rng):
    """MATLAB-mode (linear color kernel) params must dispatch to
    matlab_gram in the sharded/ring paths, not silently run the SE
    color kernel."""
    from cvo_rgbd_tpu import MATLAB_PARAMS

    x, y = _pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(MATLAB_PARAMS, x, y)
    shd = jax.jit(functools.partial(align_sharded, MATLAB_PARAMS, mesh))(x, y)
    rng_ = jax.jit(functools.partial(align_ring, MATLAB_PARAMS, mesh))(x, y)
    np.testing.assert_allclose(np.asarray(shd.tf), np.asarray(ref.tf), atol=1e-4)
    np.testing.assert_allclose(np.asarray(rng_.tf), np.asarray(ref.tf), atol=1e-4)


@pytest.mark.parametrize(
    "p",
    [
        CvoParams(max_iter=40),
        AcvoParams(max_iter=40),
        AcvoParams(max_iter=40, yy_quirk=True),
    ],
)
def test_align_ring_matches_single(rng, p):
    x, y = _pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(p, x, y)
    got = jax.jit(functools.partial(align_ring, p, mesh))(x, y)
    # blockwise reductions reorder fp32 sums; marginal sparsity-gate
    # entries can flip and the drift compounds over ~40 iterations
    # (worst under yy_quirk's row gate).  1e-4 on a pose entry is
    # 0.1mm-scale — far inside trajectory-parity territory.
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf), atol=1e-4)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1


def test_align_sharded_deterministic(rng):
    """Fixed mesh shape -> bitwise-identical psum results across runs
    (the reduction-order concern from SURVEY.md section 5)."""
    x, y = _pair(rng)
    p = CvoParams(max_iter=25)
    mesh = make_mesh({"sp": 8})
    fn = jax.jit(functools.partial(align_sharded, p, mesh))
    a = np.asarray(fn(x, y).tf)
    b = np.asarray(fn(x, y).tf)
    assert np.array_equal(a, b)


def test_align_batched_matches_loop(rng):
    p = CvoParams(max_iter=30)
    pairs = [_pair(rng) for _ in range(4)]
    fb = PointCloud(*(np.stack([np.asarray(getattr(x, f)) for x, _ in pairs])
                      for f in ("positions", "features", "mask")))
    mb = PointCloud(*(np.stack([np.asarray(getattr(y, f)) for _, y in pairs])
                      for f in ("positions", "features", "mask")))
    mesh = make_mesh({"dp": 4})
    batched = align_batched(p, fb, mb, mesh=mesh)
    for i, (x, y) in enumerate(pairs):
        ref = align_jit(p, x, y)
        np.testing.assert_allclose(
            np.asarray(batched.tf)[i], np.asarray(ref.tf), atol=2e-5
        )


def test_mesh_helper():
    m = make_mesh({"dp": 2, "sp": -1})
    assert m.shape == {"dp": 2, "sp": 4}
    with pytest.raises(ValueError):
        make_mesh({"sp": 16})


# ---------------------------------------------------------------------------
# The moment kernel inside the sharded paths: the per-device local
# compute is the SAME single-pass fused_moments sweep as the
# single-device align, with psum'd O(M) epilogues.
# ---------------------------------------------------------------------------

def _big_pair(rng, n=900, cap=1024):
    """128-divisible per-device row blocks at sp=8 (cap/8 = 128)."""
    return _pair(rng, n=n, cap=cap)


@pytest.mark.parametrize(
    "base", [CvoParams(max_iter=40), AcvoParams(max_iter=40)]
)
def test_align_sharded_pallas_matches_single(rng, base):
    import dataclasses

    p = dataclasses.replace(base, backend="pallas")
    x, y = _big_pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(p, x, y)          # single-chip pallas backend
    got = jax.jit(functools.partial(align_sharded, p, mesh))(x, y)
    # psum'd epilogues reassociate fp32 sums vs the single-chip sweep;
    # the C++ eps=5e-5 stop sits near the fp32 flow plateau, so the
    # stopping iteration skews several steps and the converged poses
    # differ at the 0.1-0.3mm scale (the documented stop-skew class,
    # docs/PARITY.md section 1) — assert pose agreement + convergence,
    # not iteration counts
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=3e-4)
    assert bool(got.converged) and bool(ref.converged)


def test_align_sharded_pallas_linear_mode(rng):
    """MATLAB-mode linear color kernel through the sharded moment path
    (the pre-masked CI tile plays the ck-cache role)."""
    import dataclasses

    from cvo_rgbd_tpu import MATLAB_PARAMS

    # C++ stop set: the coarse MATLAB eps=5e-4 stops iterations apart
    # under reassociated arithmetic (mm-scale skew, docs/PARITY.md);
    # the converged optima agree to 3e-4
    p = dataclasses.replace(MATLAB_PARAMS, backend="pallas",
                            eps=5e-5, eps_2=1e-5)
    x, y = _big_pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(p, x, y)
    got = jax.jit(functools.partial(align_sharded, p, mesh))(x, y)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=3e-4)


def test_align_sharded_pallas_fallback_unaligned(rng):
    """Row blocks that are not whole 128-point cells (cap/sp = 32) run
    the moment kernel on the padded block, not raise."""
    import dataclasses

    p = dataclasses.replace(CvoParams(max_iter=40), backend="pallas")
    x, y = _pair(rng)                 # cap=256 -> 32 rows/device
    mesh = make_mesh({"sp": 8})
    ref = align_jit(CvoParams(max_iter=40), x, y)
    got = jax.jit(functools.partial(align_sharded, p, mesh))(x, y)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=2e-5)


def test_train_step_2d_pallas(rng):
    """The full 2-D production step (dp x sp) with the Pallas local
    kernel matches per-pair single-chip pallas aligns."""
    import dataclasses

    from cvo_rgbd_tpu.parallel.sharded import train_step_2d

    p = dataclasses.replace(CvoParams(max_iter=30), backend="pallas")
    pairs = [_big_pair(rng, n=400 + 40 * i, cap=512) for i in range(2)]
    fb = PointCloud(*(np.stack([np.asarray(getattr(x, f)) for x, _ in pairs])
                      for f in ("positions", "features", "mask")))
    mb = PointCloud(*(np.stack([np.asarray(getattr(y, f)) for _, y in pairs])
                      for f in ("positions", "features", "mask")))
    mesh = make_mesh({"dp": 2, "sp": 4})   # 512/4 = 128 rows/device
    got = jax.jit(functools.partial(train_step_2d, p, mesh))(fb, mb)
    for i, (x, y) in enumerate(pairs):
        ref = align_jit(p, x, y)
        np.testing.assert_allclose(np.asarray(got.tf)[i],
                                   np.asarray(ref.tf), atol=3e-4)


@pytest.mark.parametrize(
    "base",
    [CvoParams(max_iter=40), AcvoParams(max_iter=40)],
)
def test_align_ring_pallas_matches_single(rng, base):
    """Single-sweep moment-carrying ring (the Mom block rides the
    ppermute payload; no second Gram sweep) vs single-chip pallas."""
    import dataclasses

    p = dataclasses.replace(base, backend="pallas")
    x, y = _big_pair(rng)             # 1024/8 = 128x128 blocks
    mesh = make_mesh({"sp": 8})
    ref = align_jit(p, x, y)
    got = jax.jit(functools.partial(align_ring, p, mesh))(x, y)
    # stop-skew class (see test_align_sharded_pallas_matches_single)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=3e-4)
    assert bool(got.converged) and bool(ref.converged)
    # the adaptive ell TRAJECTORY must match too, not just the pose:
    # a mis-ordered psum unpack in the ring body once fed dl a pair
    # count as its yy distance sum, slamming ell to the floor while the
    # pose still landed inside the 3e-4 tolerance on this easy pair
    # (round-5 review finding).  5% covers the stop-skew iteration
    # difference; the bug class is a >2x ell error.
    np.testing.assert_allclose(np.asarray(got.ell), np.asarray(ref.ell),
                               rtol=0.05)


def test_align_ring_pallas_linear_mode(rng):
    import dataclasses

    from cvo_rgbd_tpu import MATLAB_PARAMS

    p = dataclasses.replace(MATLAB_PARAMS, backend="pallas",
                            eps=5e-5, eps_2=1e-5)  # see the sharded test
    x, y = _big_pair(rng)
    mesh = make_mesh({"sp": 8})
    ref = align_jit(p, x, y)
    got = jax.jit(functools.partial(align_ring, p, mesh))(x, y)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=3e-4)


def test_ring_pallas_agrees_with_sharded_pallas(rng):
    """The two fast multi-chip paths cross-check each other (the
    MULTICHIP dryrun invariant, now on the Pallas kernels)."""
    import dataclasses

    p = dataclasses.replace(CvoParams(max_iter=40), backend="pallas")
    x, y = _big_pair(rng)
    mesh = make_mesh({"sp": 8})
    a = jax.jit(functools.partial(align_sharded, p, mesh))(x, y)
    b = jax.jit(functools.partial(align_ring, p, mesh))(x, y)
    np.testing.assert_allclose(np.asarray(a.tf), np.asarray(b.tf), atol=3e-4)
