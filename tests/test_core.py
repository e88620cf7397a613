"""Core kernel/flow/step tests against the NumPy float64 oracle."""

import numpy as np
import pytest

from cvo_rgbd_tpu.core import cubic, flow, gram, step
from cvo_rgbd_tpu.core.cloud import pad_cloud
from cvo_rgbd_tpu.params import AcvoParams, CvoParams

from oracle import (
    adaptive_dl_oracle,
    flow_oracle,
    se_kernel_oracle,
    step_coeffs_oracle,
)


def make_clouds(rng, n=60, m=70, feat_scale=0.2):
    base = rng.standard_normal((max(n, m), 3)).astype(np.float32) * 0.5
    basef = rng.random((max(n, m), 5)).astype(np.float32) * feat_scale
    xp = base[:n]
    yp = base[:m] + rng.standard_normal((m, 3)).astype(np.float32) * 0.03
    xf = basef[:n]
    yf = basef[:m] + rng.standard_normal((m, 5)).astype(np.float32) * 0.01 * feat_scale
    return xp, xf, yp, yf


P = AcvoParams()  # HSV-scale constants exercise both gates


def params_kwargs(p):
    return dict(
        sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres,
    )


def test_gram_matches_oracle(rng):
    xp, xf, yp, yf = make_clouds(rng)
    A_ref = se_kernel_oracle(
        xp.astype(np.float64), xf.astype(np.float64),
        yp.astype(np.float64), yf.astype(np.float64),
        0.1, P.sigma, P.c_ell, P.c_sigma, P.sp_thres, P.c_sp_thres,
    )
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    A = np.asarray(gram.se_gram(
        x.positions, x.features, x.mask,
        y.positions, y.features, y.mask,
        0.1, **params_kwargs(P),
    ))
    nv, mv = A_ref.shape
    # same sparsity pattern (gates are identical by construction)
    assert np.array_equal(A[:nv, :mv] != 0, A_ref != 0)
    np.testing.assert_allclose(A[:nv, :mv], A_ref, rtol=2e-5, atol=1e-7)
    # padding rows/cols are exactly zero
    assert np.all(A[nv:] == 0) and np.all(A[:, mv:] == 0)


def test_flow_matches_oracle(rng):
    xp, xf, yp, yf = make_clouds(rng)
    A_ref = se_kernel_oracle(
        xp.astype(np.float64), xf.astype(np.float64),
        yp.astype(np.float64), yf.astype(np.float64),
        0.1, P.sigma, P.c_ell, P.c_sigma, P.sp_thres, P.c_sp_thres,
    )
    om_ref, v_ref = flow_oracle(A_ref, xp.astype(np.float64), yp.astype(np.float64), P.c, P.d)

    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    A = gram.se_gram(
        x.positions, x.features, x.mask,
        y.positions, y.features, y.mask,
        0.1, **params_kwargs(P),
    )
    om, v = flow.flow(A, x.positions, y.positions, c=P.c, d=P.d)
    scale = max(np.linalg.norm(om_ref), np.linalg.norm(v_ref), 1e-6)
    np.testing.assert_allclose(np.asarray(om), om_ref, atol=2e-5 * scale)
    np.testing.assert_allclose(np.asarray(v), v_ref, atol=2e-5 * scale)


def test_step_coeffs_match_oracle(rng):
    xp, xf, yp, yf = make_clouds(rng)
    A_ref = se_kernel_oracle(
        xp.astype(np.float64), xf.astype(np.float64),
        yp.astype(np.float64), yf.astype(np.float64),
        0.1, P.sigma, P.c_ell, P.c_sigma, P.sp_thres, P.c_sp_thres,
    )
    omega = np.array([0.02, -0.03, 0.01])
    v = np.array([0.05, 0.02, -0.04])
    B_r, C_r, D_r, E_r = step_coeffs_oracle(
        A_ref, xp.astype(np.float64), yp.astype(np.float64), omega, v, 0.1
    )
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    A = gram.se_gram(
        x.positions, x.features, x.mask,
        y.positions, y.features, y.mask,
        0.1, **params_kwargs(P),
    )
    B, C, D, E = step.step_coefficients(
        A, x.positions, y.positions,
        omega.astype(np.float32), v.astype(np.float32), 0.1,
    )
    for got, ref in [(B, B_r), (C, C_r), (D, D_r), (E, E_r)]:
        np.testing.assert_allclose(float(got), ref, rtol=1e-3, atol=1e-5)


def test_adaptive_dl_matches_oracle(rng):
    xp, xf, yp, yf = make_clouds(rng, n=50, m=50)
    kw64 = dict(ell=0.1, sigma=P.sigma, c_ell=P.c_ell, c_sigma=P.c_sigma,
                sp_thres=P.sp_thres, c_sp_thres=P.c_sp_thres)
    A_r = se_kernel_oracle(xp, xf, yp, yf, **kw64)
    Axx_r = se_kernel_oracle(xp, xf, xp, xf, **kw64)
    Ayy_r = se_kernel_oracle(yp, yf, yp, yf, **kw64)
    dl_ref = adaptive_dl_oracle(A_r, Axx_r, Ayy_r, xp.astype(np.float64), yp.astype(np.float64), 0.1)

    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    kw = params_kwargs(P)
    A = gram.se_gram(x.positions, x.features, x.mask, y.positions, y.features, y.mask, 0.1, **kw)
    Axx = gram.se_gram(x.positions, x.features, x.mask, x.positions, x.features, x.mask, 0.1, **kw)
    Ayy = gram.se_gram(y.positions, y.features, y.mask, y.positions, y.features, y.mask, 0.1, **kw)
    dl = flow.adaptive_dl(A, Axx, Ayy, x.positions, y.positions, 0.1)
    np.testing.assert_allclose(float(dl), dl_ref, rtol=1e-3, atol=1e-7)


def test_adaptive_dl_yy_quirk(rng):
    """quirk=True with num_moving <= num_fixed: Ayy numerator drops out."""
    xp, xf, yp, yf = make_clouds(rng, n=50, m=50)
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    kw = params_kwargs(P)
    A = gram.se_gram(x.positions, x.features, x.mask, y.positions, y.features, y.mask, 0.1, **kw)
    Axx = gram.se_gram(x.positions, x.features, x.mask, x.positions, x.features, x.mask, 0.1, **kw)
    Ayy = gram.se_gram(y.positions, y.features, y.mask, y.positions, y.features, y.mask, 0.1, **kw)
    dl_q = flow.adaptive_dl(A, Axx, Ayy, x.positions, y.positions, 0.1,
                            num_fixed=50, yy_quirk=True)
    # oracle for the quirky value: drop the yy term from the numerator
    import oracle as o
    A_r = se_kernel_oracle(xp, xf, yp, yf, ell=0.1, sigma=P.sigma, c_ell=P.c_ell,
                           c_sigma=P.c_sigma, sp_thres=P.sp_thres, c_sp_thres=P.c_sp_thres)
    Axx_r = se_kernel_oracle(xp, xf, xp, xf, ell=0.1, sigma=P.sigma, c_ell=P.c_ell,
                             c_sigma=P.c_sigma, sp_thres=P.sp_thres, c_sp_thres=P.c_sp_thres)
    Ayy_r = se_kernel_oracle(yp, yf, yp, yf, ell=0.1, sigma=P.sigma, c_ell=P.c_ell,
                             c_sigma=P.c_sigma, sp_thres=P.sp_thres, c_sp_thres=P.c_sp_thres)
    ell3 = 0.1**3

    def wsum(M, a, b):
        s = 0.0
        for i in range(M.shape[0]):
            for j in range(M.shape[1]):
                if M[i, j] != 0:
                    s += M[i, j] * np.sum((a[i].astype(np.float64) - b[j]) ** 2)
        return s

    numer = (0.0 - 2 * wsum(A_r, xp, yp) + wsum(Axx_r, xp, xp)) / ell3
    denom = np.count_nonzero(Axx_r) + np.count_nonzero(Ayy_r) - 2 * np.count_nonzero(A_r)
    np.testing.assert_allclose(float(dl_q), numer / max(denom, 1), rtol=1e-3)


def test_matlab_gram_linear_color(rng):
    """MATLAB mode: A = CI .* K with K < sp zeroed (rkhs:125-127)."""
    xp, xf, yp, yf = make_clouds(rng)
    p = CvoParams(color_mode="linear", sp_thres=1e-3)
    x = pad_cloud(xp, xf[:, :3])
    y = pad_cloud(yp, yf[:, :3])
    ci = gram.linear_color_gram(x.features, y.features, p.color_scale)
    A = np.asarray(gram.matlab_gram(
        x.positions, x.mask, y.positions, y.mask, ci, 0.15,
        sigma=p.sigma, sp_thres=p.sp_thres,
    ))
    # oracle
    n, m = xp.shape[0], yp.shape[0]
    D2 = ((xp[:, None, :] - yp[None, :, :]) ** 2).sum(-1)
    K = p.sigma**2 * np.exp(-D2 / (2 * 0.15**2))
    K[K < p.sp_thres] = 0
    CI = p.color_scale * xf[:, :3] @ yf[:, :3].T
    np.testing.assert_allclose(A[:n, :m], CI * K, rtol=2e-4, atol=1e-9)


# ---------- cubic solver ----------

def _check_roots(coef, got):
    """Every returned root is a root; every real np root is represented."""
    a, b, c, d = (float(x) for x in coef)
    for t in got:
        assert np.isfinite(t)
        p = ((a * t + b) * t + c) * t + d
        scale = max(abs(a * t**3), abs(b * t**2), abs(c * t), abs(d), 1e-6)
        assert abs(p) < 1e-3 * scale, (coef, t, p)
    for r in np.roots(coef):
        if abs(r.imag) < 1e-7 * max(1.0, abs(r.real)):
            assert any(abs(t - r.real) < 1e-3 * max(1.0, abs(r.real)) for t in got), (coef, got, r)


@pytest.mark.parametrize("coef", [
    (2.0, -3.0, -11.0, 6.0),      # roots 3, -2, 0.5
    (1.0, 0.0, -1.0, 0.0),        # roots 0, 1, -1
    (1.0, -6.0, 11.0, -6.0),      # roots 1, 2, 3
    (1.0, 0.0, 0.0, -8.0),        # single real root 2
    (1.0, 3.0, 3.0, 1.0),         # triple root -1
    (0.0, 1.0, -3.0, 2.0),        # quadratic: 1, 2
    (0.0, 1.0, 0.0, 1.0),         # quadratic, complex roots
    (0.0, 0.0, 2.0, -5.0),        # linear: 2.5
])
def test_cubic_roots_vs_numpy(coef):
    roots, valid = cubic.cubic_roots(*coef)
    got = [float(r) for r, ok in zip(np.asarray(roots), np.asarray(valid)) if ok]
    _check_roots(coef, got)


def test_min_positive_root_semantics():
    # roots 3, -2, 0.5 -> pick 0.5
    r, ok = cubic.cubic_roots(2.0, -3.0, -11.0, 6.0)
    assert abs(float(cubic.min_positive_root(r, ok, 0.2, 0.8)) - 0.5) < 1e-5
    # roots 1,2,3 -> min positive 1 but clamp to 0.8
    r, ok = cubic.cubic_roots(1.0, -6.0, 11.0, -6.0)
    assert abs(float(cubic.min_positive_root(r, ok, 0.2, 0.8)) - 0.8) < 1e-6
    # no positive real roots -> min_step
    r, ok = cubic.cubic_roots(0.0, 1.0, 0.0, 1.0)
    assert abs(float(cubic.min_positive_root(r, ok, 0.2, 0.8)) - 0.2) < 1e-6


def test_cubic_random_fuzz(rng):
    for _ in range(200):
        coef = rng.standard_normal(4) * np.power(10.0, rng.integers(-3, 3, 4))
        roots, valid = cubic.cubic_roots(*coef)
        got = [float(r) for r, ok in zip(np.asarray(roots), np.asarray(valid)) if ok]
        _check_roots(coef, got)


def test_function_inner_product(rng):
    """Mean kernel value over gated pairs (adaptive_cvo.cpp:385-439)."""
    from cvo_rgbd_tpu.core.registration import function_inner_product

    xp, xf, yp, yf = make_clouds(rng, n=40, m=40)
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    fip = float(function_inner_product(P, x, y))
    # oracle: sum/count over gated pairs at ell_init, color gate uses
    # sp_thres (not c_sp_thres) per the reference
    A = se_kernel_oracle(
        xp.astype(np.float64), xf.astype(np.float64),
        yp.astype(np.float64), yf.astype(np.float64),
        P.ell_init, P.sigma, P.c_ell, P.c_sigma, P.sp_thres, P.sp_thres,
    )
    ref = A.sum() / max(np.count_nonzero(A), 1)
    np.testing.assert_allclose(fip, ref, rtol=1e-4)
    # self inner product is larger than cross (keyframe-selection signal)
    self_fip = float(function_inner_product(P, x, x))
    assert self_fip >= fip


def test_align_trace(rng):
    """Structured per-iteration records match the align result."""
    from cvo_rgbd_tpu import CvoParams, align_jit
    from cvo_rgbd_tpu.core.trace import align_trace

    xp, xf, yp, yf = make_clouds(rng, n=80, m=80, feat_scale=255.0)
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    p = CvoParams(max_iter=60)
    res = align_jit(p, x, y)
    final, recs = align_trace(p, x, y, 60)
    # trace endpoint agrees with align
    np.testing.assert_allclose(
        np.asarray(final.R), np.asarray(res.R), atol=1e-5
    )
    conv = np.asarray(recs.converged)
    if bool(res.converged):
        k = int(res.iterations)
        assert conv[k]           # converged at the reported iteration
        assert not conv[:k].any()
        # frozen after convergence
        assert conv[k:].all()
    assert np.isfinite(np.asarray(recs.omega_norm)).all()
    # ell follows the schedule
    ells = np.asarray(recs.ell)
    assert ells[0] <= p.ell_init


def test_step_factored_matches_direct(rng):
    """Moment-factored line-search coefficients vs the direct path."""
    from cvo_rgbd_tpu.core.step_factored import step_coefficients_factored
    from cvo_rgbd_tpu.core import gram as gram_mod

    xp, xf, yp, yf = make_clouds(rng, n=120, m=120)
    x = pad_cloud(xp, xf)
    y = pad_cloud(yp, yf)
    A = gram_mod.se_gram(
        x.positions, x.features, x.mask, y.positions, y.features, y.mask,
        0.1, **params_kwargs(P),
    )
    omega = np.array([0.02, -0.03, 0.01], np.float32)
    v = np.array([0.05, 0.02, -0.04], np.float32)
    ref = step.step_coefficients(A, x.positions, y.positions, omega, v, 0.1)
    got = step_coefficients_factored(A, x.positions, y.positions, omega, v, 0.1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=5e-3, atol=1e-4)


def test_exp_mode_fast_matches_precise_at_matlab_stops(rng):
    """params.exp_mode="fast" (hardware exp, ~30% cheaper kernels)
    must converge at the MATLAB stops with poses at the stop-set
    tolerance of the precise default (the round-3 configuration;
    PERF.md numerics findings for why "precise" is the default)."""
    import dataclasses
    import functools

    import jax

    from cvo_rgbd_tpu.core.registration import align
    from cvo_rgbd_tpu.params import CvoParams

    base = np.random.default_rng(17)
    pos = base.standard_normal((200, 3)).astype(np.float32) * 0.4
    feat = (base.random((200, 5)) * np.array([255, 255, 255, 60, 60])
            ).astype(np.float32)
    from cvo_rgbd_tpu import se3 as _se3

    R = np.asarray(_se3.exp_so3(np.array([0.01, -0.008, 0.012], np.float32)))
    t = np.array([0.015, -0.02, 0.01], np.float32)
    x = pad_cloud(pos, feat)
    y = pad_cloud((pos @ R.T + t).astype(np.float32), feat)

    p_precise = CvoParams(eps=5e-4, eps_2=1e-4)
    p_fast = dataclasses.replace(p_precise, exp_mode="fast")
    r_p = jax.jit(functools.partial(align, p_precise))(x, y)
    r_f = jax.jit(functools.partial(align, p_fast))(x, y)
    assert bool(r_p.converged) and bool(r_f.converged)
    d = np.asarray(r_p.tf, np.float64) - np.asarray(r_f.tf, np.float64)
    assert np.abs(d[:3, 3]).max() < 2e-3, d[:3, 3]


def test_kd_sort_invariants(rng):
    """kd_sort (the tile-compactness reorder behind the AABB pruning):
    a permutation of the valid points with padding last, and tiles
    measurably more compact than sample order."""
    import numpy as np

    from cvo_rgbd_tpu import pad_cloud
    from cvo_rgbd_tpu.core.cloud import kd_sort
    from cvo_rgbd_tpu.ops.moment_kernel import block_bounds

    pts = rng.uniform(-2, 2, (1000, 3)).astype(np.float32)
    feat = rng.random((1000, 5)).astype(np.float32)
    c = pad_cloud(pts, feat, capacity=1024)
    s = kd_sort(c)
    # permutation: same point/feature multiset, same valid count
    key = lambda p, f: sorted(map(tuple, np.concatenate([p, f], 1).tolist()))  # noqa: E731
    assert key(np.asarray(c.positions), np.asarray(c.features)) == \
        key(np.asarray(s.positions), np.asarray(s.features))
    m = np.asarray(s.mask)
    assert m.sum() == 1000 and (np.diff(m) <= 0).all()  # valid first
    # compactness: mean per-tile AABB diagonal shrinks vs sample order
    def mean_diag(cloud):
        lo, hi = block_bounds(cloud.positions, cloud.mask, 128)
        d = np.asarray(hi) - np.asarray(lo)
        d = d[np.isfinite(d).all(1)]
        return float(np.linalg.norm(d, axis=1).mean())
    assert mean_diag(s) < 0.7 * mean_diag(c)
