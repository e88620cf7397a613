"""Moment-kernel tests (interpret mode on CPU) vs the XLA path.

The same kernel source is lowered through Triton on the GPU, where
chip_smoke.py compares it with the plain reference at N=M=3072.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvo_rgbd_tpu import (
    MATLAB_PARAMS, AcvoParams, CvoParams, align_jit, pad_cloud, se3,
)
from cvo_rgbd_tpu.core import flow as flow_mod
from cvo_rgbd_tpu.core import gram as gram_mod
from cvo_rgbd_tpu.core.step import step_coefficients
from cvo_rgbd_tpu.core.step_factored import monomial_features
from cvo_rgbd_tpu.ops import fused_moments, fused_wsq
from cvo_rgbd_tpu.ops import moment_kernel as mk

CAP = 256
P = CvoParams()


def _pair(rng, n=200, cap=CAP, nfeat=5):
    base = rng.standard_normal((n + 30, 3)).astype(np.float32) * 0.4
    feat = (rng.random((n + 30, 5)) * np.array([255, 255, 255, 60, 60]))
    feat = feat[:, :nfeat].astype(np.float32)
    R = np.asarray(se3.exp_so3(np.array([0.01, -0.012, 0.008], np.float32)))
    t = np.array([0.02, -0.01, 0.015], np.float32)
    yp = (base[20:20 + n] @ R.T + t).astype(np.float32)
    x = pad_cloud(base[:n], feat[:n], capacity=cap)
    y = pad_cloud(yp, feat[20:20 + n], capacity=cap)
    return x, y


def _xla_reference(p, x, y, ell):
    A = gram_mod.se_gram(
        x.positions, x.features, x.mask, y.positions, y.features, y.mask,
        ell, sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres,
    )
    om, v = flow_mod.flow(A, x.positions, y.positions, c=p.c, d=p.d)
    wsq = flow_mod.weighted_sqdist_sum(A, x.positions, y.positions)
    return A, om, v, wsq, flow_mod.nnz(A)


def _centered(x):
    w = x.mask.astype(jnp.float32)
    c0 = jnp.sum(x.positions * w[:, None], 0) / jnp.maximum(jnp.sum(w), 1.0)
    x_c = x.positions - c0
    return c0, x_c, monomial_features(x_c)


def _clouds(x, y):
    return (x.positions, x.features, x.mask,
            y.positions, y.features, y.mask)


# ---------------------------------------------------------------------------
# the wrapper: block choice, padding, platform route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,want", [
    (3072, 3072, (3072, 3072, 6)),     # 96 column blocks x 6 row ranges
    (768, 3072, (768, 3072, 6)),       # the sp=4 row shard
    (768, 768, (768, 768, 22)),        # MATLAB-protocol pair
    (100, 200, (128, 224, 4)),         # pads to whole tiles
    (32, 32, (32, 32, 1)),             # never more splits than row tiles
])
def test_tile_plan(n, m, want):
    n_pad, m_pad, splits = mk.tile_plan(n, m)
    assert (n_pad, m_pad, splits) == want
    assert n_pad % mk.TILE == 0 and m_pad % mk.TILE == 0
    # enough programs to fill the card unless the rows run out first
    assert (m_pad // mk.TILE) * splits >= min(
        mk.TARGET_PROGRAMS, (m_pad // mk.TILE) * (n_pad // mk.TILE)
    )


def test_planes_pad_and_mask():
    pos = jnp.arange(30, dtype=jnp.float32).reshape(10, 3)
    feat = jnp.ones((10, 3), jnp.float32)
    planes = mk._planes(pos, feat, jnp.ones(10), 32)
    assert planes.shape == (mk.NPLANES, 32)
    np.testing.assert_array_equal(np.asarray(planes[:3, :10]),
                                  np.asarray(pos.T))
    # linear-mode clouds carry 3 features: planes 6-7 are zero
    assert not np.asarray(planes[6:8]).any()
    # padded slots are masked out
    np.testing.assert_array_equal(np.asarray(planes[8]),
                                  np.r_[np.ones(10), np.zeros(22)])


def test_unaligned_capacity_pads(rng):
    """Capacities that are not whole tiles pad inside the wrapper and
    give the same sums as the reference."""
    x, y = _pair(rng, n=90, cap=100)
    mom, nnz = fused_moments(*_clouds(x, y), monomial_features(x.positions),
                             0.1, p=P)
    r_mom, r_nnz, _ = mk.reference_moments(*_clouds(x, y), 0.1, p=P)
    assert mom.shape == (100, 35)
    assert float(nnz) == float(r_nnz)
    np.testing.assert_allclose(np.asarray(mom), np.asarray(r_mom),
                               rtol=1e-5, atol=1e-5 * float(
                                   np.abs(np.asarray(r_mom)).max()))


_TRITON = "__gpu$xla.gpu.triton"


@pytest.mark.parametrize("params,kind", [
    (CvoParams(), "moments"), (AcvoParams(), "moments"),
    (MATLAB_PARAMS, "moments"), (AcvoParams(), "wsq_symmetric"),
])
def test_kernel_lowered_for_cuda_goes_through_triton(params, kind):
    """Lowered for the GPU, the kernel body is lowered to Triton IR (on
    this host, without a card) and called as one Triton custom call per
    sweep — not interpreted."""
    nfeat = 3 if params.color_mode == "linear" else 5
    x = pad_cloud(np.random.default_rng(0).random((40, 3), np.float32),
                  np.ones((40, nfeat), np.float32), capacity=64)

    def f(c):
        if kind == "moments":
            return fused_moments(*_clouds(c, c),
                                 monomial_features(c.positions), 0.1,
                                 p=params)
        return fused_wsq(*_clouds(c, c), 0.1, p=params, symmetric=True)

    exp = jax.export.export(
        jax.jit(f), platforms=("cuda",),
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(_TRITON)],
    )(x)
    text = exp.mlir_module()
    assert text.count(_TRITON) == 1


def test_kernel_lowered_for_cpu_is_interpreted():
    """Lowered for the CPU the kernel runs in interpret mode; the
    Triton branch is kept for the GPU only."""
    x = pad_cloud(np.zeros((4, 3), np.float32), capacity=32)
    text = jax.jit(
        lambda c: fused_wsq(*_clouds(c, c), 0.1, p=P)
    ).lower(x).as_text()
    assert _TRITON not in text


# ---------------------------------------------------------------------------
# kernel vs plain reference
# ---------------------------------------------------------------------------

def test_capacity_validation(rng):
    """The symmetric self-sweep needs a self-pair."""
    x, y = _pair(rng, n=100, cap=256)
    with pytest.raises(ValueError):
        fused_wsq(
            x.positions[:128], x.features[:128], x.mask[:128],
            y.positions, y.features, y.mask, 0.1, p=P, symmetric=True,
        )


@pytest.mark.parametrize("params,nfeat", [
    (CvoParams(), 5), (AcvoParams(), 5), (MATLAB_PARAMS, 3),
])
def test_kernel_matches_reference_moments(rng, params, nfeat):
    """Mom, nnz and wsq against core/gram + A^T Phi at HIGHEST: nnz is
    exact, Mom and wsq agree to summation order."""
    x, y = _pair(rng, n=220, cap=256, nfeat=nfeat)
    ell = 0.1
    c0, x_c, phi = _centered(x)
    args = (x_c, x.features, x.mask, y.positions - c0, y.features, y.mask)
    mom, nnz = fused_moments(*args, phi, ell, p=params)
    wsq, nnz2 = fused_wsq(*args, ell, p=params)
    r_mom, r_nnz, r_wsq = mk.reference_moments(*args, ell, p=params)
    assert float(r_nnz) > 0
    assert float(nnz) == float(r_nnz) == float(nnz2)
    scale = float(np.abs(np.asarray(r_mom)).max())
    np.testing.assert_allclose(np.asarray(mom), np.asarray(r_mom),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(float(wsq), float(r_wsq), rtol=1e-5)


def test_align_pallas_linear_mode_matches_xla(rng):
    """MATLAB-protocol (linear CI) params on the pallas backend: the
    in-kernel CI dot + position-kernel gate must reproduce
    matlab_gram."""
    x, y = _pair(rng, nfeat=3)
    ref = align_jit(MATLAB_PARAMS, x, y)
    got = align_jit(dataclasses.replace(MATLAB_PARAMS, backend="pallas"),
                    x, y)
    np.testing.assert_allclose(
        np.asarray(got.tf), np.asarray(ref.tf), atol=5e-5
    )
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1


def test_align_pallas_adaptive_matches_xla(rng):
    x, y = _pair(rng)
    ref = align_jit(AcvoParams(max_iter=30), x, y)
    got = align_jit(AcvoParams(max_iter=30, backend="pallas"), x, y)
    np.testing.assert_allclose(
        np.asarray(got.tf), np.asarray(ref.tf), atol=5e-5
    )
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1


def test_fused_moments_flow_matches_xla(rng):
    """Single-pass moments -> difference-form flow epilogue vs the XLA
    reference."""
    from cvo_rgbd_tpu.core.moments import flow_from_moments

    x, y = _pair(rng)
    ell = 0.1
    A, om_ref, v_ref, wsq_ref, nnz_ref = _xla_reference(P, x, y, ell)
    c0, x_c, phi = _centered(x)
    Mom, nnz = fused_moments(
        x_c, x.features, x.mask, y.positions - c0, y.features, y.mask,
        phi, ell, p=P,
    )
    scale = max(float(np.linalg.norm(np.asarray(om_ref))), 1e-8)
    om, v, wsq, sA = flow_from_moments(Mom, y.positions, c0, c=P.c, d=P.d)
    np.testing.assert_allclose(
        np.asarray(om), np.asarray(om_ref), rtol=1e-3, atol=1e-3 * scale
    )
    np.testing.assert_allclose(
        np.asarray(v), np.asarray(v_ref), rtol=1e-3, atol=1e-6
    )
    np.testing.assert_allclose(float(wsq), float(wsq_ref), rtol=1e-3)
    assert int(nnz) == int(nnz_ref)
    np.testing.assert_allclose(
        float(sA), float(np.sum(np.asarray(A))), rtol=1e-4
    )


def test_fused_moments_step_matches_direct(rng):
    """B..E from the moment contraction vs the direct step coefficients."""
    from cvo_rgbd_tpu.core.moments import step_from_moments

    x, y = _pair(rng)
    ell = 0.1
    A, om, v, _, _ = _xla_reference(P, x, y, ell)
    B_r, C_r, D_r, E_r = step_coefficients(
        A, x.positions, y.positions, om, v, ell
    )
    c0, x_c, phi = _centered(x)
    Mom, _ = fused_moments(
        x_c, x.features, x.mask, y.positions - c0, y.features, y.mask,
        phi, ell, p=P,
    )
    B, C, D, E = step_from_moments(Mom, y.positions, c0, om, v, ell)
    for got, ref in [(B, B_r), (C, C_r), (D, D_r), (E, E_r)]:
        np.testing.assert_allclose(float(got), float(ref), rtol=5e-3,
                                   atol=1e-6)


def test_fused_wsq_matches_xla(rng):
    x, y = _pair(rng)
    ell = 0.1
    A, _, _, wsq_ref, nnz_ref = _xla_reference(P, x, y, ell)
    wsq, nnz = fused_wsq(*_clouds(x, y), ell, p=P)
    np.testing.assert_allclose(float(wsq), float(wsq_ref), rtol=1e-3)
    assert int(nnz) == int(nnz_ref)


def test_fused_wsq_symmetric_matches_full(rng):
    """Upper-triangle self-sweep == full sweep on a self-pair."""
    x, _ = _pair(rng)
    ell = 0.1
    full = fused_wsq(*_clouds(x, x), ell, p=P)
    sym = fused_wsq(*_clouds(x, x), ell, p=P, symmetric=True)
    np.testing.assert_allclose(float(sym[0]), float(full[0]), rtol=1e-5)
    assert int(sym[1]) == int(full[1])


# ---------------------------------------------------------------------------
# the align loop on the moment backend vs the XLA backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params,nfeat", [
    (CvoParams(max_iter=40), 5),
    (CvoParams(max_iter=60), 5),
    (MATLAB_PARAMS, 3),
    (AcvoParams(max_iter=60), 5),
])
def test_align_pallas_backend_matches_xla(rng, params, nfeat):
    """Full align loop with backend='pallas' vs backend='xla'."""
    x, y = _pair(rng, nfeat=nfeat)
    ref = align_jit(params, x, y)
    got = align_jit(dataclasses.replace(params, backend="pallas"), x, y)
    np.testing.assert_allclose(
        np.asarray(got.tf), np.asarray(ref.tf), atol=5e-5
    )
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1
    assert bool(got.converged) == bool(ref.converged)


PM = dataclasses.replace(MATLAB_PARAMS, backend="pallas")


def test_pallas_warm_start(rng):
    x, y = _pair(rng, nfeat=3)
    R0 = np.asarray(se3.exp_so3(np.array([0.005, 0.003, -0.002], np.float32)))
    T0 = np.array([0.01, 0.0, -0.005], np.float32)
    ref = align_jit(MATLAB_PARAMS, x, y, R0, T0)
    got = align_jit(PM, x, y, R0, T0)
    np.testing.assert_allclose(np.asarray(got.tf), np.asarray(ref.tf),
                               atol=5e-5)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 1


def test_ell0_seed_matches_across_backends(rng):
    """`ell0` seeds the length-scale state (the reference cvo carries
    ell across pairs, cvo.cpp:408-410): explicit ell_init reproduces
    the default exactly, and a carried-over ell agrees across
    backends."""
    x, y = _pair(rng, nfeat=3)
    base = align_jit(PM, x, y)
    seeded = align_jit(PM, x, y, ell0=MATLAB_PARAMS.ell_init)
    np.testing.assert_array_equal(np.asarray(seeded.tf), np.asarray(base.tf))
    assert int(seeded.iterations) == int(base.iterations)

    carried = align_jit(MATLAB_PARAMS, x, y, ell0=0.03)
    kern = align_jit(PM, x, y, ell0=0.03)
    np.testing.assert_allclose(np.asarray(kern.tf), np.asarray(carried.tf),
                               atol=5e-5)
    assert abs(int(kern.iterations) - int(carried.iterations)) <= 1


@pytest.mark.parametrize(
    "params,nfeat", [(PM, 3), (CvoParams(backend="pallas"), 5)]
)
def test_pallas_self_registration_identity(rng, params, nfeat):
    x, _ = _pair(rng, nfeat=nfeat)
    res = align_jit(params, x, x)
    assert int(res.iterations) == 0
    np.testing.assert_array_equal(np.asarray(res.tf),
                                  np.eye(4, dtype=np.float32))


def test_pallas_empty_moving(rng):
    x, _ = _pair(rng, nfeat=3)
    empty = pad_cloud(np.zeros((0, 3), np.float32),
                      np.zeros((0, 3), np.float32), capacity=256)
    res = align_jit(PM, x, empty)
    assert int(res.iterations) == 0
    assert np.isfinite(np.asarray(res.tf)).all()


def test_pallas_vmap_batched_matches_per_pair(rng):
    """vmap over the moment backend (a batched grid): each lane
    matches its own single-pair run."""
    from cvo_rgbd_tpu.core.cloud import stack_clouds
    from cvo_rgbd_tpu.core.registration import align

    ps = [_pair(rng, nfeat=3) for _ in range(3)]
    fb = stack_clouds([x for x, _ in ps])
    mb = stack_clouds([y for _, y in ps])
    out = jax.jit(jax.vmap(lambda f, m: align(PM, f, m)))(fb, mb)
    for i, (x, y) in enumerate(ps):
        one = align_jit(PM, x, y)
        np.testing.assert_allclose(np.asarray(out.tf)[i],
                                   np.asarray(one.tf), atol=1e-6)
        assert int(np.asarray(out.iterations)[i]) == int(one.iterations)


# ---------------------------------------------------------------------------
# Exact AABB tile skipping: pruned tiles would contribute exactly zero,
# so the skip changes no computed bit — tile_skip=True must be BITWISE
# equal to False.
# ---------------------------------------------------------------------------

def _scattered_pair(rng, n=700, cap=1024):
    """Clusters far apart relative to the gate radius, so the AABB
    prune has real work to do at small ell."""
    centers = rng.uniform(-1.5, 1.5, (8, 3)).astype(np.float32)
    pts = np.concatenate([
        c + 0.08 * rng.standard_normal((n // 8, 3)).astype(np.float32)
        for c in centers
    ])
    feat = (rng.random((pts.shape[0], 5)) *
            np.array([255, 255, 255, 60, 60])).astype(np.float32)
    x = pad_cloud(pts, feat, capacity=cap)
    d = 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
    y = pad_cloud(pts + d, feat, capacity=cap)
    return x, y


def test_tile_skip_bounds_are_conservative(rng):
    """Every gated-in pair lies in a tile the prune keeps."""
    from cvo_rgbd_tpu.core.cloud import kd_sort

    x, y = _scattered_pair(rng)
    x, y = kd_sort(x), kd_sort(y)
    tile = mk.TILE
    lo_x, hi_x = mk.block_bounds(x.positions, x.mask, tile)
    lo_y, hi_y = mk.block_bounds(y.positions, y.mask, tile)
    md = np.asarray(mk.aabb_min_d2(lo_x, hi_x, lo_y, hi_y))
    d2 = np.sum(
        (np.asarray(x.positions)[:, None, :]
         - np.asarray(y.positions)[None, :, :]) ** 2, axis=-1,
    )
    valid = (np.asarray(x.mask)[:, None] > 0) & (np.asarray(y.mask)[None] > 0)
    d2 = np.where(valid, d2, np.inf)
    blk = d2.reshape(d2.shape[0] // tile, tile,
                     d2.shape[1] // tile, tile).min(axis=(1, 3))
    assert (md <= blk + 1e-6).all()
    # and the prune is non-trivial on this geometry at ell=0.05
    thres = -2 * 0.05 ** 2 * np.log(P.sp_thres / P.sigma ** 2)
    assert (md > thres).mean() > 0.3, (md > thres).mean()


@pytest.mark.parametrize(
    "base", [CvoParams(max_iter=60), AcvoParams(max_iter=60)]
)
def test_align_tile_skip_bitwise_equal(rng, base):
    x, y = _scattered_pair(rng)
    p_on = dataclasses.replace(base, backend="pallas", tile_skip=True)
    p_off = dataclasses.replace(base, backend="pallas", tile_skip=False)
    a = align_jit(p_on, x, y)
    b = align_jit(p_off, x, y)
    assert np.array_equal(np.asarray(a.tf), np.asarray(b.tf))
    assert int(a.iterations) == int(b.iterations)
    assert np.array_equal(np.asarray(a.ell), np.asarray(b.ell))


def test_acvo_cheb_self_mode_matches_exact(rng):
    """self_mode="cheb" (per-align Chebyshev tables replacing the
    per-iteration self-kernel sweeps — they are functions of ell alone
    by rigid invariance) converges to the same pose as exact sweeps
    within the documented drift."""
    x, y = _pair(rng, nfeat=5, n=400, cap=512)
    p_ex = AcvoParams(backend="pallas", max_iter=200)
    p_ch = dataclasses.replace(p_ex, self_mode="cheb")
    a = align_jit(p_ex, x, y)
    b = align_jit(p_ch, x, y)
    assert bool(a.converged) and bool(b.converged)
    np.testing.assert_allclose(np.asarray(b.tf), np.asarray(a.tf),
                               atol=5e-4)


# ---------------------------------------------------------------------------
# params: the backend option
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", [CvoParams, AcvoParams])
@pytest.mark.parametrize("backend", ["fused", "triton", "XLA"])
def test_params_reject_unknown_backend(cls, backend):
    with pytest.raises(ValueError, match="backend"):
        cls(backend=backend)


@pytest.mark.parametrize("kw", [
    dict(yy_quirk=True), dict(color_mode="linear"),
])
def test_acvo_params_reject_kernel_gaps(kw):
    """Combinations the moment kernel does not implement are refused,
    not rerouted."""
    with pytest.raises(ValueError):
        AcvoParams(backend="pallas", **kw)
    AcvoParams(backend="xla", **kw)
