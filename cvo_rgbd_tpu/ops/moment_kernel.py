"""Single-sweep moment kernel: one masked Gram-tile pass per iteration.

Each align iteration needs, from the masked Gram matrix A [N, M], the
omega-independent moment matrix

    Mom = A^T Phi(x')          [M, 35 monomials of degree <= 4]

plus the count nnz(A).  Flow, the adaptive weighted squared-distance
sum and the line-search coefficients B..E are then O(M) epilogues
(core/moments.py), so the reference's two nnz(A) traversals
(cvo.cpp:164-308) collapse into one, and A is never written to device
memory.

`fused_wsq` is the lean companion for the adaptive self-kernels
(Axx/Ayy, adaptive_cvo.cpp:156-160): those only feed the dl reduction,
which needs just sum A*d2 and nnz.

Layout (Pallas, Triton route): the grid runs over column blocks of the
moving cloud times `splits` row ranges of the fixed cloud.  Each
program keeps its [TILE, 64] moment accumulator in registers and loops
over the row tiles of its range; the partial sums of the row ranges
are added by XLA afterwards.  A row tile whose AABB lower bound on the
pair distance exceeds the position-gate radius is skipped outright
(exact: every entry of it fails d2 < d2_thres, cvo.cpp:119-125).  The
color kernel is recomputed in-kernel.  The moment contraction runs in
IEEE fp32 (Precision.HIGHEST, never TF32).

The kernel is lowered through Triton on the GPU and interpreted when
lowered for the CPU (the tests); any other platform is refused.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from cvo_rgbd_tpu.core import gram as gram_mod
from cvo_rgbd_tpu.core.numerics import exp_neg
from cvo_rgbd_tpu.core.step_factored import NUM_MONO, monomial_features

TILE = 32         # rows and columns per tile (powers of two for Triton)
MOM_WIDTH = 64    # 35 monomials padded to a power of two
NPLANES = 3 + 5 + 1   # planes per cloud: x, y, z, f0..f4, mask
# Enough programs for a few waves on the 132 SMs of an H100; the row
# range of each column block is split until the grid reaches this.
TARGET_PROGRAMS = 4 * 132
NUM_WARPS = 4

# Conservative margin on the tile-skip comparison: the AABB bound is
# computed from the same coordinates as the in-kernel d2 but rounds
# differently, so a boundary-hair pair could gate IN while the bound
# says OUT.  d2 fp32 noise is ~3e-8 m^2 at scene scale; 1e-5 m^2 of
# slack skips essentially nothing extra and keeps the skip exact.
SKIP_MARGIN = 1e-5

_HI = jax.lax.Precision.HIGHEST


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def tile_plan(n, m):
    """(padded rows, padded columns, row splits) for an [n, m] sweep.

    Both capacities pad to a multiple of TILE with masked rows.  The
    row range of each column block splits until the grid has about
    TARGET_PROGRAMS programs, and never below one row tile per split."""
    n_pad, m_pad = _round_up(max(n, 1), TILE), _round_up(max(m, 1), TILE)
    n_tiles, m_tiles = n_pad // TILE, m_pad // TILE
    splits = max(1, min(n_tiles, -(-TARGET_PROGRAMS // m_tiles)))
    return n_pad, m_pad, splits


def block_bounds(pos, mask, tile=TILE):
    """Per-tile AABBs of the valid points: [nb,3] lo and hi.

    Invalid slots are excluded via +/-inf sentinels; an all-invalid
    tile gets lo=+inf / hi=-inf, which makes every pairwise lower
    bound +inf, so padding tiles are skipped outright."""
    nb = pos.shape[0] // tile
    p = pos.reshape(nb, tile, 3)
    valid = (mask.reshape(nb, tile) > 0)[..., None]
    lo = jnp.min(jnp.where(valid, p, jnp.inf), axis=1)
    hi = jnp.max(jnp.where(valid, p, -jnp.inf), axis=1)
    return lo, hi


def aabb_min_d2(lo_x, hi_x, lo_y, hi_y):
    """[nbx, nby] lower bounds on the squared distance between any
    point of x-tile i and any point of y-tile j.  min_d2[i, j] >
    d2_thres implies every pair of the tile fails the position gate,
    so its Gram block is exactly zero."""
    gap1 = lo_y[None, :, :] - hi_x[:, None, :]
    gap2 = lo_x[:, None, :] - hi_y[None, :, :]
    gap = jnp.maximum(jnp.maximum(gap1, gap2), 0.0)
    return jnp.sum(gap * gap, axis=-1)


def _scalars(ell, p):
    """Per-call scalars: (s2, cs2, 1/2l^2, 1/2cl^2, d2_thres,
    d2_c_thres, sp_thres, color_scale)."""
    ell = jnp.asarray(ell, jnp.float32)
    s2 = p.sigma * p.sigma
    cs2 = p.c_sigma * p.c_sigma
    d2_thres = -2.0 * ell * ell * jnp.log(jnp.float32(p.sp_thres / s2))
    d2_c_thres = -2.0 * p.c_ell * p.c_ell * jnp.log(p.c_sp_thres / cs2)
    return jnp.stack([
        jnp.float32(s2), jnp.float32(cs2), 1.0 / (2.0 * ell * ell),
        jnp.float32(1.0 / (2.0 * p.c_ell * p.c_ell)), d2_thres,
        jnp.float32(d2_c_thres), jnp.float32(p.sp_thres),
        jnp.float32(getattr(p, "color_scale", 0.0)),
    ])


def _planes(pos, feat, mask, n_pad):
    """[NPLANES, n_pad] plane-major layout: x, y, z, five features
    (zero-padded: linear-mode clouds carry three), mask; padded slots
    are masked out."""
    n, k = feat.shape
    planes = jnp.concatenate([
        pos.T.astype(jnp.float32),
        feat.T.astype(jnp.float32),
        jnp.zeros((5 - k, n), jnp.float32),
        mask.astype(jnp.float32)[None, :],
    ])
    return jnp.pad(planes, ((0, 0), (0, n_pad - n)))


def _load_planes(ref, start):
    return [ref[k, pl.ds(start, TILE)] for k in range(NPLANES)]


def _pair_tile(x, y, sc, linear, fast_exp):
    """A tile and d2 tile [TILE, TILE] from x rows and y columns, with
    exactly the gates of core/gram.se_gram (matlab_gram when linear)."""
    s2, cs2, inv_2l2, inv_2cl2, d2_thres, d2_c_thres, sp_thres, cscale = sc
    _exp = (lambda z: jnp.exp(-z)) if fast_exp else exp_neg

    def sq(a, b):
        d = a[:, None] - b[None, :]
        return d * d

    d2 = sq(x[0], y[0]) + sq(x[1], y[1]) + sq(x[2], y[2])
    k = s2 * _exp(d2 * inv_2l2)
    valid = (x[8][:, None] > 0) & (y[8][None, :] > 0)
    if linear:
        # MATLAB mode: A = CI .* K with the linear color kernel
        # CI = scale * Cx Cy' (rkhs_se3_registration.m:108, 125-127)
        ci = x[3][:, None] * y[3][None, :]
        for c in range(4, 8):
            ci = ci + x[c][:, None] * y[c][None, :]
        gate = (k >= sp_thres) & valid
        return jnp.where(gate, (cscale * ci) * k, 0.0), d2
    d2c = sq(x[3], y[3])
    for c in range(4, 8):
        d2c = d2c + sq(x[c], y[c])
    a = k * (cs2 * _exp(d2c * inv_2cl2))
    gate = (d2 < d2_thres) & (d2c < d2_c_thres) & (a > sp_thres) & valid
    return jnp.where(gate, a, 0.0), d2


def _row_range(n_tiles, splits):
    s = pl.program_id(1)
    return s * n_tiles // splits, (s + 1) * n_tiles // splits


def _sweep(body, md_ref, i, j, d2_thres, carry, extra_pred=None):
    """Run `body(carry)` for row tile i unless the tile is skipped."""
    pred = None
    if md_ref is not None:
        pred = md_ref[i, j] <= d2_thres + SKIP_MARGIN
    if extra_pred is not None:
        pred = extra_pred if pred is None else pred & extra_pred
    if pred is None:
        return body(carry)
    return jax.lax.cond(pred, body, lambda c: c, carry)


def _moments_kernel(s_ref, xs_ref, ys_ref, phi_ref, *refs, n_tiles, splits,
                    linear, fast_exp, skip):
    md_ref = refs[0] if skip else None
    mom_ref, cnt_ref = refs[-2:]
    j = pl.program_id(0)
    sc = [s_ref[k] for k in range(8)]
    y = _load_planes(ys_ref, j * TILE)
    lo, hi = _row_range(n_tiles, splits)

    def row_tile(i, carry):
        def work(carry):
            acc, cnt = carry
            x = _load_planes(xs_ref, i * TILE)
            A, _ = _pair_tile(x, y, sc, linear, fast_exp)
            phi = phi_ref[pl.ds(i * TILE, TILE), :]
            acc = acc + jax.lax.dot_general(
                A, phi, (((0,), (0,)), ((), ())),       # A^T Phi
                precision=_HI, preferred_element_type=jnp.float32,
            )
            cnt = cnt + jnp.sum((A > 0).astype(jnp.int32), axis=0)
            return acc, cnt

        return _sweep(work, md_ref, i, j, sc[4], carry)

    acc, cnt = jax.lax.fori_loop(
        lo, hi, row_tile,
        (jnp.zeros((TILE, MOM_WIDTH), jnp.float32),
         jnp.zeros((TILE,), jnp.int32)),
    )
    mom_ref[...] = acc
    cnt_ref[...] = cnt


def _wsq_kernel(s_ref, xs_ref, ys_ref, *refs, n_tiles, splits, linear,
                fast_exp, skip, symmetric):
    md_ref = refs[0] if skip else None
    wsq_ref, cnt_ref = refs[-2:]
    j = pl.program_id(0)
    sc = [s_ref[k] for k in range(8)]
    y = _load_planes(ys_ref, j * TILE)
    lo, hi = _row_range(n_tiles, splits)

    def row_tile(i, carry):
        def work(carry):
            wsq, cnt = carry
            x = _load_planes(xs_ref, i * TILE)
            A, d2 = _pair_tile(x, y, sc, linear, fast_exp)
            w = jnp.sum(A * d2, axis=0)
            c = jnp.sum((A > 0).astype(jnp.int32), axis=0)
            if symmetric:
                # A is symmetric on a self-pair: the upper triangle of
                # tiles counts twice, the diagonal once
                off = i < j
                w = jnp.where(off, 2.0 * w, w)
                c = jnp.where(off, 2 * c, c)
            return wsq + w, cnt + c

        return _sweep(work, md_ref, i, j, sc[4], carry,
                      extra_pred=(i <= j) if symmetric else None)

    wsq, cnt = jax.lax.fori_loop(
        lo, hi, row_tile,
        (jnp.zeros((TILE,), jnp.float32), jnp.zeros((TILE,), jnp.int32)),
    )
    wsq_ref[...] = wsq
    cnt_ref[...] = cnt


def _pallas(kernel, args, out_shape, out_specs, grid):
    """Run the kernel through Triton on the GPU; interpret it when the
    program is lowered for the CPU; refuse anything else."""

    def call(interpret):
        return pl.pallas_call(
            kernel, grid=grid, out_specs=out_specs, out_shape=out_shape,
            interpret=interpret, backend="triton",
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS),
        )(*args)

    return jax.lax.platform_dependent(
        cpu=lambda: call(True), cuda=lambda: call(False)
    )


def _prepare(xp, xf, xm, yp, yf, ym, ell, p):
    n, m = xp.shape[0], yp.shape[0]
    n_pad, m_pad, splits = tile_plan(n, m)
    xs = _planes(xp, xf, xm, n_pad)
    ys = _planes(yp, yf, ym, m_pad)
    sc = _scalars(ell, p)
    extra = ()
    if getattr(p, "tile_skip", True):
        lo_x, hi_x = block_bounds(xs[:3].T, xs[8], TILE)
        lo_y, hi_y = block_bounds(ys[:3].T, ys[8], TILE)
        extra = (aabb_min_d2(lo_x, hi_x, lo_y, hi_y),)
    return n_pad, m_pad, splits, sc, xs, ys, extra


def _flags(p):
    return dict(
        linear=p.color_mode == "linear",
        fast_exp=getattr(p, "exp_mode", "precise") == "fast",
        skip=getattr(p, "tile_skip", True),
    )


@functools.partial(jax.jit, static_argnames=("p",))
def fused_moments(xp, xf, xm, yp, yf, ym, phi, ell, *, p):
    """One-sweep moment accumulation: returns (Mom [M, 35], nnz).

    `xp`/`yp` are the CENTERED positions (x - c0, y - c0; pair
    distances are shift-invariant, so A is unchanged) and `phi` is
    step_factored.monomial_features(x - c0) [N, 35], loop-invariant
    because the fixed cloud never moves.  nnz is an exact count."""
    n_pad, m_pad, splits, sc, xs, ys, extra = _prepare(
        xp, xf, xm, yp, yf, ym, ell, p
    )
    phi = jnp.pad(phi.astype(jnp.float32),
                  ((0, n_pad - phi.shape[0]), (0, MOM_WIDTH - NUM_MONO)))
    kernel = functools.partial(
        _moments_kernel, n_tiles=n_pad // TILE, splits=splits, **_flags(p)
    )
    mom, cnt = _pallas(
        kernel, (sc, xs, ys, phi) + extra,
        out_shape=[
            jax.ShapeDtypeStruct((splits, m_pad, MOM_WIDTH), jnp.float32),
            jax.ShapeDtypeStruct((splits, m_pad), jnp.int32),
        ],
        out_specs=[
            pl.BlockSpec((None, TILE, MOM_WIDTH), lambda j, s: (s, j, 0)),
            pl.BlockSpec((None, TILE), lambda j, s: (s, j)),
        ],
        grid=(m_pad // TILE, splits),
    )
    m = yp.shape[0]
    mom = jnp.sum(mom, axis=0)[:m, :NUM_MONO]
    return mom, jnp.sum(cnt).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("p", "symmetric"))
def fused_wsq(xp, xf, xm, yp, yf, ym, ell, *, p, symmetric=False):
    """Lean self-kernel sweep: returns (sum A*d2, nnz), the only
    quantities the adaptive dl reduction needs from Axx/Ayy
    (adaptive_cvo.cpp:222-271).  Pass symmetric=True when x and y ARE
    the same cloud (upper-triangle evaluation)."""
    if symmetric and xp.shape[0] != yp.shape[0]:
        raise ValueError("symmetric sweep requires a self-pair (n == m)")
    n_pad, m_pad, splits, sc, xs, ys, extra = _prepare(
        xp, xf, xm, yp, yf, ym, ell, p
    )
    kernel = functools.partial(
        _wsq_kernel, n_tiles=n_pad // TILE, splits=splits,
        symmetric=symmetric, **_flags(p),
    )
    wsq, cnt = _pallas(
        kernel, (sc, xs, ys) + extra,
        out_shape=[
            jax.ShapeDtypeStruct((splits, m_pad), jnp.float32),
            jax.ShapeDtypeStruct((splits, m_pad), jnp.int32),
        ],
        out_specs=[
            pl.BlockSpec((None, TILE), lambda j, s: (s, j)),
            pl.BlockSpec((None, TILE), lambda j, s: (s, j)),
        ],
        grid=(m_pad // TILE, splits),
    )
    return jnp.sum(wsq), jnp.sum(cnt).astype(jnp.float32)


def reference_moments(xp, xf, xm, yp, yf, ym, ell, *, p):
    """Plain XLA reference of both kernels: (Mom [M, 35], nnz, wsq)
    from the dense gated Gram (core/gram) and A^T Phi in fp32."""
    fast = getattr(p, "exp_mode", "precise") == "fast"
    if p.color_mode == "linear":
        ci = gram_mod.linear_color_gram(xf, yf, p.color_scale)
        A = gram_mod.matlab_gram(xp, xm, yp, ym, ci, ell, sigma=p.sigma,
                                 sp_thres=p.sp_thres, fast_exp=fast)
    else:
        A = gram_mod.se_gram(
            xp, xf, xm, yp, yf, ym, ell, sigma=p.sigma, c_ell=p.c_ell,
            c_sigma=p.c_sigma, sp_thres=p.sp_thres,
            c_sp_thres=p.c_sp_thres, fast_exp=fast,
        )
    mom = jnp.matmul(A.T, monomial_features(xp), precision=_HI)
    d2 = gram_mod.pairwise_sqdist(xp, yp)
    return mom, jnp.sum(A > 0).astype(jnp.float32), jnp.sum(A * d2)
