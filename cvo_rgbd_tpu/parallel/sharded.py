"""Sharded registration: shard_map + collectives over the device mesh.

The reference's mutex-guarded accumulations are semantically
all-reduces (SURVEY.md section 2.6): omega/v (cvo.cpp:201-204), B..E
(cvo.cpp:283-288), dl (adaptive_cvo.cpp:234-263).  Here they become
`lax.psum` over a mesh axis:

- `align_sharded` — "Gram tensor parallelism": fixed-cloud rows shard
  over axis `sp`; each device computes its row-block of the Gram matrix
  and partial reductions; one psum per quantity per iteration.  The
  while_loop state stays replicated because every device sees the same
  psum results.
- `align_ring` — point-cloud "sequence parallelism" (the ring-attention
  analog, SURVEY.md section 5): both clouds shard; cloud blocks rotate
  around the ring via `ppermute` so no device ever holds the whole
  moving cloud.  XLA path: two sweeps per iteration (flow needs omega
  before the line-search sweep), plus a third for the adaptive Axx/Ayy
  partials.  Pallas path: ONE sweep — the visiting block carries its
  moment matrix around the ring and both reductions become epilogues.
- `align_batched` — batch DP: vmap the single-pair align over a batch
  of frame pairs, sharded over axis `dp` (multi-sequence odometry).

Local per-device compute in the sharded/ring paths runs the same
single-pass moment kernel as the single-device align when `p.backend`
selects it; the XLA dense-block path is the default and the only
yy_quirk/adaptive-linear implementation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core import flow as flow_mod
from cvo_rgbd_tpu.core import gram as gram_mod
from cvo_rgbd_tpu.core.cloud import PointCloud, transform_cloud
from cvo_rgbd_tpu.core.registration import AlignResult, AlignState, _schedule_ell
from cvo_rgbd_tpu.core.step_factored import step_coefficients_factored
from cvo_rgbd_tpu.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_tpu.params import AcvoParams


def _se_gram(p, xp, xf, xm, yp, yf, ym, ell):
    """Per-(row-shard, block) Gram evaluation, dispatching on the
    params' color mode exactly like core.registration._gram.  The
    linear-mode CI block is recomputed per call — loop-invariant work,
    but tiny (one [n,m] matmul) next to the kernel itself."""
    fast = getattr(p, "exp_mode", "precise") == "fast"
    if p.color_mode == "linear":
        ci = gram_mod.linear_color_gram(xf, yf, p.color_scale)
        return gram_mod.matlab_gram(
            xp, xm, yp, ym, ci, ell, sigma=p.sigma, sp_thres=p.sp_thres,
            fast_exp=fast,
        )
    return gram_mod.se_gram(
        xp, xf, xm, yp, yf, ym, ell,
        sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres, fast_exp=fast,
    )


def _step_from_coeffs(p, B, C, D, E):
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    return min_positive_root(roots, valid, p.min_step, p.max_step)


def _finish(final) -> AlignResult:
    return AlignResult(
        tf=final.tf, R=final.R, T=final.T,
        iterations=final.k - 1, converged=final.converged,
        ell=final.ell, omega=final.omega, v=final.v,
    )


def _init_state(p, adaptive):
    return AlignState(
        k=jnp.zeros((), jnp.int32),
        R=jnp.eye(3, dtype=jnp.float32),
        T=jnp.zeros(3, jnp.float32),
        ell=jnp.asarray(p.ell_init, jnp.float32),
        ell_max=jnp.asarray(p.ell_max_init if adaptive else 1e9, jnp.float32),
        tf=jnp.eye(4, dtype=jnp.float32),
        converged=jnp.zeros((), bool),
        omega=jnp.zeros(3, jnp.float32),
        v=jnp.zeros(3, jnp.float32),
    )


def _integrate(p, state, omega, v, step, adaptive, dl):
    """Shared tail of the loop body: stops, exp update, ell update."""
    stop1 = (jnp.linalg.norm(omega) < p.eps) & (jnp.linalg.norm(v) < p.eps)
    dR, dT = se3.exp_sek3(omega, v, step)
    # pinned (see core/registration.py / se3.py: reduced-precision 3x3
    # matmuls stall contraction above the 5e-5 stop)
    _hi = jax.lax.Precision.HIGHEST
    R_new = jnp.where(stop1, state.R, jnp.matmul(state.R, dR, precision=_hi))
    T_new = jnp.where(
        stop1, state.T,
        jnp.matmul(state.R, dT[..., None], precision=_hi)[..., 0] + state.T,
    )
    stop2 = se3.dist_se3(dR, dT) < p.eps_2
    converged = stop1 | stop2
    if adaptive:
        ell_new = state.ell + p.dl_step * dl
        hit = ell_new >= state.ell_max
        ell_max_new = jnp.where(hit, state.ell_max * p.ell_shrink, state.ell_max)
        ell_new = jnp.where(hit, state.ell_max * p.ell_shrink, ell_new)
        ell_new = jnp.maximum(ell_new, p.ell_min)
    else:
        ell_new = _schedule_ell(state.ell, state.k, p.ell_sched)
        ell_max_new = state.ell_max
    ell_new = jnp.where(converged, state.ell, ell_new)
    new_state = AlignState(
        k=state.k + 1, R=R_new, T=T_new, ell=ell_new,
        ell_max=ell_max_new, tf=state.tf, converged=converged,
        omega=omega, v=v,
    )
    # freeze once converged (vmap lanes keep running; see registration)
    return AlignState(
        *(jnp.where(state.converged, old, new)
          for old, new in zip(state, new_state))
    )


# ---------------------------------------------------------------------------
# Row-sharded align (Gram tensor parallelism)
# ---------------------------------------------------------------------------

def _use_kernel(p):
    """The moment kernel runs when the params ask for it (params
    refuse the combinations it does not implement)."""
    return getattr(p, "backend", "xla") == "pallas"


def _kernel_order(p, fixed, moving):
    """Globally kd-sort the clouds before shard_map when the moment
    kernel will run: sharded row blocks become contiguous kd cells, so
    the per-device AABB tile pruning actually prunes (see
    core/registration.kernel_order — the same order as the
    single-device align)."""
    from cvo_rgbd_tpu.core.registration import kernel_order

    return kernel_order(p, fixed), kernel_order(p, moving)


def _make_sharded_inner(p, axis, adaptive, nsp):
    """Per-shard align body: x arrays are row-shards, y replicated
    within `axis` groups.  Used by align_sharded and train_step_2d.

    With `p.backend == "pallas"` each device runs the SAME
    single-pass moment kernel as the single-device align
    (ops/moment_kernel.py) on its local [N/sp, M] row block: one tile
    sweep accumulates the local moment matrix Mom_l = A_l^T Phi(x'_l),
    the flow/step reductions are O(M) epilogues on Mom_l
    (core/moments.py — they are LINEAR in Mom, so per-shard epilogues
    psum exactly like the reference's mutex-guarded partials,
    cvo.cpp:201-204), and the iteration keeps the two packed psums of
    the XLA path."""

    use_pallas = _use_kernel(p)
    if use_pallas:
        from cvo_rgbd_tpu.core.moments import (
            flow_from_moments,
            step_from_moments,
        )
        from cvo_rgbd_tpu.core.step_factored import monomial_features
        from cvo_rgbd_tpu.ops import fused_moments, fused_wsq

    def inner(xp, xf, xm, yp0, yf, ym):
        # x_full needed only for the adaptive Axx columns; the fixed
        # cloud never moves, so gather once outside the loop.
        if adaptive:
            xp_full = jax.lax.all_gather(xp, axis, tiled=True)
            xf_full = jax.lax.all_gather(xf, axis, tiled=True)
            xm_full = jax.lax.all_gather(xm, axis, tiled=True)
            num_fixed = jnp.sum(xm_full)

        if use_pallas:
            # Loop-invariant per-align precomputation (the sharded
            # analog of registration.build_moments_pre).  c0 is the
            # GLOBAL masked centroid of the fixed cloud — every shard
            # centers identically, so the psum'd moments match the
            # single-device ones.
            w = xm.astype(jnp.float32)
            s_g, n_g = jax.lax.psum(
                (jnp.sum(xp * w[:, None], axis=0), jnp.sum(w)), axis
            )
            c0 = s_g / jnp.maximum(n_g, 1.0)
            x_c = xp - c0
            phi = monomial_features(x_c)

        def pallas_body(state):
            tf_R, tf_T = se3.se3_inv(state.R, state.T)
            tf = se3.make_se3(tf_R, tf_T)
            yp = transform_cloud(tf_R, tf_T, yp0)

            Mom_l, nnz_l = fused_moments(
                x_c, xf, xm, yp - c0, yf, ym, phi, state.ell, p=p,
            )
            om_l, v_l, wsq_l, _ = flow_from_moments(
                Mom_l, yp, c0, c=p.c, d=p.d
            )
            if adaptive:
                # self-kernels only feed dl (lean sweeps).  Axx spans
                # local rows x the full fixed cloud — symmetric
                # upper-triangle evaluation only applies at sp=1 where
                # the block IS the full self-pair.  Ayy is replicated
                # (full y x y), exactly like the XLA path's s_yy.
                wsq_xx_l, nnz_xx_l = fused_wsq(
                    xp, xf, xm, xp_full, xf_full, xm_full,
                    state.ell, p=p, symmetric=(nsp == 1),
                )
                wsq_yy, nnz_yy = fused_wsq(
                    yp, yf, ym, yp, yf, ym, state.ell,
                    p=p, symmetric=True,
                )
                omega, v, s_xy, s_xx, nnz_xx, nnz_xy = jax.lax.psum(
                    (om_l, v_l, wsq_l, wsq_xx_l, nnz_xx_l, nnz_l), axis
                )
                numer = (wsq_yy - 2.0 * s_xy + s_xx) / state.ell ** 3
                denom = nnz_xx + nnz_yy - 2.0 * nnz_xy
                dl = numer / jnp.where(denom == 0, 1.0, denom)
            else:
                omega, v = jax.lax.psum((om_l, v_l), axis)
                dl = jnp.zeros((), jnp.float32)

            Bl, Cl, Dl, El = step_from_moments(
                Mom_l, yp, c0, omega, v, state.ell
            )
            B, C, D, E = jax.lax.psum((Bl, Cl, Dl, El), axis)
            step = _step_from_coeffs(p, B, C, D, E)

            new = _integrate(p, state, omega, v, step, adaptive, dl)
            return new._replace(tf=tf)

        def body(state):
            tf_R, tf_T = se3.se3_inv(state.R, state.T)
            tf = se3.make_se3(tf_R, tf_T)
            yp = transform_cloud(tf_R, tf_T, yp0)

            # PACKED collectives: the iteration has exactly two data
            # dependencies on cross-shard sums (flow before the
            # omega-dependent line search), so all partial reductions
            # ride TWO psum calls instead of up to eleven.  Small
            # psums are pure latency, so packing them matters most for
            # sp-sharded per-iteration time.
            A = _se_gram(p, xp, xf, xm, yp, yf, ym, state.ell)
            om_l, v_l = flow_mod.flow(A, xp, yp, c=p.c, d=p.d)

            if adaptive:
                Axx = _se_gram(p, xp, xf, xm, xp_full, xf_full, xm_full, state.ell)
                Ayy = _se_gram(p, yp, yf, ym, yp, yf, ym, state.ell)
                pack_l = (
                    om_l, v_l,
                    flow_mod.weighted_sqdist_sum(A, xp, yp),
                    flow_mod.weighted_sqdist_sum(Axx, xp, xp_full),
                    flow_mod.nnz(Axx),
                    flow_mod.nnz(A),
                )
                omega, v, s_xy, s_xx, nnz_xx, nnz_xy = jax.lax.psum(
                    pack_l, axis)
                ell3 = state.ell ** 3
                if p.yy_quirk:
                    m = yp.shape[-2]
                    keep = (jnp.arange(m) >= num_fixed).astype(Ayy.dtype)
                    Ayy_eff = Ayy * keep[:, None]
                else:
                    Ayy_eff = Ayy
                s_yy = flow_mod.weighted_sqdist_sum(Ayy_eff, yp, yp)  # replicated
                numer = (s_yy - 2.0 * s_xy + s_xx) / ell3
                denom = nnz_xx + flow_mod.nnz(Ayy) - 2 * nnz_xy
                denom = jnp.where(denom == 0, 1, denom).astype(numer.dtype)
                dl = numer / denom
            else:
                omega, v = jax.lax.psum((om_l, v_l), axis)
                dl = jnp.zeros((), jnp.float32)

            # moment-factored on the local block (one matmul per
            # device, no [N/sp, M] field materialization); the
            # per-shard A-weighted centering is exact, so the psum'd
            # coefficients match the unsharded ones
            Bl, Cl, Dl, El = step_coefficients_factored(
                A, xp, yp, omega, v, state.ell
            )
            B, C, D, E = jax.lax.psum((Bl, Cl, Dl, El), axis)
            step = _step_from_coeffs(p, B, C, D, E)

            new = _integrate(p, state, omega, v, step, adaptive, dl)
            return new._replace(tf=tf)

        final = jax.lax.while_loop(
            lambda s: (s.k < p.max_iter) & ~s.converged,
            pallas_body if use_pallas else body,
            _init_state(p, adaptive),
        )
        return _finish(final)

    return inner


def align_sharded(p, mesh, fixed: PointCloud, moving: PointCloud,
                  axis: str = "sp") -> AlignResult:
    """Fixed-cloud rows sharded over `axis`; moving cloud replicated.

    Call under jit:  jax.jit(align_sharded, static_argnums=(0, 4))
    (or via functools.partial).  Capacity of `fixed` must divide by the
    axis size.
    """
    adaptive = isinstance(p, AcvoParams)
    nsp = mesh.shape[axis]
    if fixed.capacity % nsp:
        raise ValueError(
            f"fixed capacity {fixed.capacity} not divisible by {axis}={nsp}"
        )
    fixed, moving = _kernel_order(p, fixed, moving)
    inner = _make_sharded_inner(p, axis, adaptive, nsp)
    spec_x = (P(axis, None), P(axis, None), P(axis))
    spec_y = (P(None, None), P(None, None), P(None))
    out = jax.tree_util.tree_map(lambda _: P(), _finish(_init_state(p, adaptive)))
    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=spec_x + spec_y,
        out_specs=out,
        check_vma=False,
    )
    return fn(fixed.positions, fixed.features, fixed.mask,
              moving.positions, moving.features, moving.mask)


def train_step_2d(p, mesh, fixed_b: PointCloud, moving_b: PointCloud,
                  dp: str = "dp", sp: str = "sp") -> AlignResult:
    """The full production step over a 2-D mesh: frame-pair batch
    sharded over `dp` (data parallelism), fixed-cloud points sharded
    over `sp` (Gram tensor parallelism with psum collectives).

    fixed_b/moving_b hold a leading batch axis; batch size must divide
    by mesh[dp], point capacity by mesh[sp].  Returns a batched
    AlignResult.
    """
    adaptive = isinstance(p, AcvoParams)
    ndp, nsp = mesh.shape[dp], mesh.shape[sp]
    B = fixed_b.positions.shape[0]
    if B % ndp or fixed_b.capacity % nsp:
        raise ValueError(
            f"batch {B} must divide {dp}={ndp}; capacity "
            f"{fixed_b.capacity} must divide {sp}={nsp}"
        )
    fixed_b, moving_b = jax.vmap(
        functools.partial(_kernel_order, p)
    )(fixed_b, moving_b)
    inner = _make_sharded_inner(p, sp, adaptive, nsp)

    def batched_inner(xp, xf, xm, yp, yf, ym):
        # local shapes: [B/ndp, N/nsp, ...] for x, [B/ndp, M, ...] for y
        def one(_, args):
            return None, inner(*args)

        _, res = jax.lax.scan(one, None, (xp, xf, xm, yp, yf, ym))
        return res

    spec_x = (P(dp, sp, None), P(dp, sp, None), P(dp, sp))
    spec_y = (P(dp, None, None), P(dp, None, None), P(dp, None))
    proto = _finish(_init_state(p, adaptive))
    out = jax.tree_util.tree_map(
        lambda a: P(dp, *([None] * jnp.ndim(a))), proto
    )
    fn = jax.shard_map(
        batched_inner, mesh=mesh,
        in_specs=spec_x + spec_y, out_specs=out, check_vma=False,
    )
    return fn(fixed_b.positions, fixed_b.features, fixed_b.mask,
              moving_b.positions, moving_b.features, moving_b.mask)


# ---------------------------------------------------------------------------
# Ring-streamed align (point-cloud sequence parallelism)
# ---------------------------------------------------------------------------

def align_ring(p, mesh, fixed: PointCloud, moving: PointCloud,
               axis: str = "sp") -> AlignResult:
    """Both clouds sharded over `axis`; cloud blocks ride the ring.

    Per iteration (XLA block path): sweep 1 rotates moving blocks to
    accumulate the flow partials (plus, for adaptive params, the Axy
    weighted-distance/nnz partials); for adaptive params sweep 1b
    rotates fixed *and* moving blocks together against the resident
    row-shards for the Axx/Ayy self-kernel partials of dl
    (adaptive_cvo.cpp:222-271); sweep 2 (after omega/v are known)
    rotates moving blocks again for the line-search coefficients.
    Peak per-device Gram block is [N/sp, M/sp] — no device ever holds
    a whole cloud or a whole Gram matrix.

    With `p.backend == "pallas"` the iteration collapses to ONE sweep:
    the visiting y block carries its moment block
    Mom_b = A[:, b]^T Phi(x') around the ring — each device adds its
    resident rows' contribution (ops/moment_kernel.py fused_moments) and, for adaptive params, the Axx/Ayy wsq partials
    (fused_wsq) in the same hop.  After a full cycle every block is
    home with its complete moments, and flow AND line-search
    coefficients are O(M/sp) epilogues (core/moments.py) + two packed
    psums — the omega-dependent second Gram sweep disappears
    entirely (the reference's second nnz(A) traversal,
    cvo.cpp:213-308).  Color kernels are recomputed in-kernel.
    """
    adaptive = isinstance(p, AcvoParams)
    nsp = mesh.shape[axis]
    if fixed.capacity % nsp or moving.capacity % nsp:
        raise ValueError("cloud capacities must divide the ring size")

    fixed, moving = _kernel_order(p, fixed, moving)
    use_pallas_cfg = _use_kernel(p)
    if use_pallas_cfg:
        from cvo_rgbd_tpu.core.moments import (
            flow_from_moments,
            step_from_moments,
        )
        from cvo_rgbd_tpu.core.step_factored import monomial_features
        from cvo_rgbd_tpu.ops import fused_moments, fused_wsq

    def inner(xp, xf, xm, yp0_blk, yf_blk, ym_blk):
        m_local = yp0_blk.shape[0]
        if adaptive:
            # total valid fixed points + this shard's global row base in
            # the moving cloud (P(axis) shards are contiguous), for the
            # yy_quirk row gate (adaptive_cvo.cpp:190/256)
            num_fixed = jax.lax.psum(jnp.sum(xm), axis)
            blk_m = yp0_blk.shape[0]
            y_row_base = jax.lax.axis_index(axis) * blk_m

        def ring_sweep(carry_init, payload, blk_fn):
            """Rotate `payload` blocks through all devices."""
            perm = [(i, (i + 1) % nsp) for i in range(nsp)]

            def step_fn(i, val):
                carry, blk = val
                carry = blk_fn(carry, blk)
                blk = jax.tree_util.tree_map(
                    lambda a: jax.lax.ppermute(a, axis, perm), blk
                )
                return carry, blk

            return jax.lax.fori_loop(
                0, nsp, step_fn, (carry_init, payload)
            )[0]

        y_payload = (yp0_blk, yf_blk, ym_blk)

        if use_pallas_cfg:
            # loop-invariant precomputation (see _make_sharded_inner):
            # global fixed-cloud centroid + centered monomial features
            # of the resident rows
            w = xm.astype(jnp.float32)
            s_g, n_g = jax.lax.psum(
                (jnp.sum(xp * w[:, None], axis=0), jnp.sum(w)), axis
            )
            c0 = s_g / jnp.maximum(n_g, 1.0)
            x_c = xp - c0
            phi = monomial_features(x_c)

        def ring_sweep_carrying(carry_init, payload, blk_fn):
            """Like ring_sweep, but blk_fn also UPDATES the payload —
            after the full cycle each device's payload is its home
            block again, with whatever blk_fn accumulated riding it."""
            perm = [(i, (i + 1) % nsp) for i in range(nsp)]

            def step_fn(i, val):
                carry, blk = val
                carry, blk = blk_fn(carry, blk)
                blk = jax.tree_util.tree_map(
                    lambda a: jax.lax.ppermute(a, axis, perm), blk
                )
                return carry, blk

            return jax.lax.fori_loop(
                0, nsp, step_fn, (carry_init, payload)
            )

        def pallas_body(state):
            tf_R, tf_T = se3.se3_inv(state.R, state.T)
            tf = se3.make_se3(tf_R, tf_T)
            yp_home = transform_cloud(tf_R, tf_T, yp0_blk)

            mom0 = jnp.zeros((m_local, 35), jnp.float32)

            def blk_fn(carry, blk):
                if adaptive:
                    xpb, xfb, xmb, ypb0, yfb, ymb, mom = blk
                else:
                    ypb0, yfb, ymb, mom = blk
                ypb = transform_cloud(tf_R, tf_T, ypb0)
                contrib, nnz = fused_moments(
                    x_c, xf, xm, ypb - c0, yfb, ymb, phi, state.ell, p=p,
                )
                mom = mom + contrib
                if adaptive:
                    sxx_c, nxx_c = fused_wsq(
                        xp, xf, xm, xpb, xfb, xmb, state.ell, p=p,
                    )
                    syy_c, nyy_c = fused_wsq(
                        yp_home, yf_blk, ym_blk, ypb, yfb, ymb,
                        state.ell, p=p,
                    )
                    # carry order (sxx, syy, nxx, nyy, nxy) matches the
                    # psum unpack below and the XLA ring body's tuple —
                    # a (sxx, nxx, syy, ...) swap here silently feeds dl
                    # a pair COUNT as its yy distance sum and slams ell
                    # to the floor on iteration 1.
                    carry = (
                        carry[0] + sxx_c, carry[1] + syy_c,
                        carry[2] + nxx_c, carry[3] + nyy_c,
                        carry[4] + nnz,
                    )
                    return carry, (xpb, xfb, xmb, ypb0, yfb, ymb, mom)
                return carry, (ypb0, yfb, ymb, mom)

            if adaptive:
                carry0 = tuple(jnp.zeros((), jnp.float32) for _ in range(5))
                payload0 = (xp, xf, xm) + y_payload + (mom0,)
            else:
                carry0 = ()
                payload0 = y_payload + (mom0,)
            carry, payload = ring_sweep_carrying(carry0, payload0, blk_fn)
            mom_home = payload[-1]

            om_l, v_l, wsq_l, _ = flow_from_moments(
                mom_home, yp_home, c0, c=p.c, d=p.d
            )
            if adaptive:
                omega, v, sxy_g, sxx_g, syy_g, nxx_g, nyy_g, nxy_g = (
                    jax.lax.psum((om_l, v_l, wsq_l) + carry, axis)
                )
                numer = (syy_g - 2.0 * sxy_g + sxx_g) / state.ell ** 3
                denom = nxx_g + nyy_g - 2.0 * nxy_g
                dl = numer / jnp.where(denom == 0, 1.0, denom)
            else:
                omega, v = jax.lax.psum((om_l, v_l), axis)
                dl = jnp.zeros((), jnp.float32)

            Bl, Cl, Dl, El = step_from_moments(
                mom_home, yp_home, c0, omega, v, state.ell
            )
            B, C, D, E = jax.lax.psum((Bl, Cl, Dl, El), axis)
            step = _step_from_coeffs(p, B, C, D, E)

            new = _integrate(p, state, omega, v, step, adaptive, dl)
            return new._replace(tf=tf)

        def body(state):
            tf_R, tf_T = se3.se3_inv(state.R, state.T)
            tf = se3.make_se3(tf_R, tf_T)

            # sweep 1: flow partials (+ Axy dl partials when adaptive)
            def flow_blk(carry, blk):
                om, vv, sxy, nxy = carry
                ypb = transform_cloud(tf_R, tf_T, blk[0])
                A = _se_gram(p, xp, xf, xm, ypb, blk[1], blk[2], state.ell)
                o_l, v_l = flow_mod.flow(A, xp, ypb, c=p.c, d=p.d)
                if adaptive:
                    sxy = sxy + flow_mod.weighted_sqdist_sum(A, xp, ypb)
                    nxy = nxy + flow_mod.nnz(A)
                return (om + o_l, vv + v_l, sxy, nxy)

            om, vv, sxy, nxy = ring_sweep(
                (jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
                 jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)),
                y_payload, flow_blk,
            )
            # packed collectives (see _make_sharded_inner): omega/v are
            # first needed by the omega-dependent sweep 2, so the
            # adaptive path defers them into ONE psum with the dl
            # partials after sweep 1b — two psum calls per iteration
            # total in either variant.

            if adaptive:
                # sweep 1b: self-kernel partials.  Rows stay resident
                # (x row-shard; transformed y block), columns rotate.
                yp_rows = transform_cloud(tf_R, tf_T, yp0_blk)

                def adapt_blk(carry, blk):
                    sxx, nxx, syy, nyy = carry
                    xpb, xfb, xmb, ypb0, yfb, ymb = blk
                    Axx = _se_gram(p, xp, xf, xm, xpb, xfb, xmb, state.ell)
                    ypb = transform_cloud(tf_R, tf_T, ypb0)
                    Ayy = _se_gram(
                        p, yp_rows, yf_blk, ym_blk, ypb, yfb, ymb, state.ell
                    )
                    sxx = sxx + flow_mod.weighted_sqdist_sum(Axx, xp, xpb)
                    nxx = nxx + flow_mod.nnz(Axx)
                    nyy = nyy + flow_mod.nnz(Ayy)
                    if p.yy_quirk:
                        rows = y_row_base + jnp.arange(blk_m)
                        Ayy_eff = Ayy * (rows >= num_fixed).astype(
                            Ayy.dtype
                        )[:, None]
                    else:
                        Ayy_eff = Ayy
                    syy = syy + flow_mod.weighted_sqdist_sum(
                        Ayy_eff, yp_rows, ypb
                    )
                    return (sxx, nxx, syy, nyy)

                sxx, nxx, syy, nyy = ring_sweep(
                    (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32),
                     jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)),
                    (xp, xf, xm) + y_payload, adapt_blk,
                )
                omega, v, sxy_g, sxx_g, syy_g, nxx_g, nyy_g, nxy_g = (
                    jax.lax.psum(
                        (om, vv, sxy, sxx, syy, nxx, nyy, nxy), axis
                    )
                )
                numer = (syy_g - 2.0 * sxy_g + sxx_g) / state.ell ** 3
                denom = nxx_g + nyy_g - 2 * nxy_g
                denom = jnp.where(denom == 0, 1, denom).astype(numer.dtype)
                dl = numer / denom
            else:
                omega, v = jax.lax.psum((om, vv), axis)
                dl = jnp.zeros((), jnp.float32)

            # sweep 2: line-search coefficients
            def step_blk(carry, blk):
                B, C, D, E = carry
                ypb = transform_cloud(tf_R, tf_T, blk[0])
                A = _se_gram(p, xp, xf, xm, ypb, blk[1], blk[2], state.ell)
                Bl, Cl, Dl, El = step_coefficients_factored(
                    A, xp, ypb, omega, v, state.ell
                )
                return (B + Bl, C + Cl, D + Dl, E + El)

            zeros = tuple(jnp.zeros((), jnp.float32) for _ in range(4))
            B, C, D, E = ring_sweep(zeros, y_payload, step_blk)
            B, C, D, E = (jax.lax.psum(t, axis) for t in (B, C, D, E))
            step = _step_from_coeffs(p, B, C, D, E)

            new = _integrate(p, state, omega, v, step, adaptive, dl)
            return new._replace(tf=tf)

        final = jax.lax.while_loop(
            lambda s: (s.k < p.max_iter) & ~s.converged,
            pallas_body if use_pallas_cfg else body,
            _init_state(p, adaptive),
        )
        return _finish(final)

    spec = (P(axis, None), P(axis, None), P(axis))
    out = jax.tree_util.tree_map(
        lambda _: P(), _finish(_init_state(p, adaptive))
    )
    fn = jax.shard_map(
        inner, mesh=mesh, in_specs=spec + spec, out_specs=out,
        check_vma=False,
    )
    return fn(fixed.positions, fixed.features, fixed.mask,
              moving.positions, moving.features, moving.mask)


# ---------------------------------------------------------------------------
# Batch data parallelism over frame pairs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _compiled_align_batched(p):
    from cvo_rgbd_tpu.core.registration import align

    return jax.jit(jax.vmap(functools.partial(align, p)))


def align_batched(p, fixed_batch: PointCloud, moving_batch: PointCloud,
                  mesh=None, dp_axis: str = "dp",
                  R0=None, T0=None, ell0=None):
    """vmap align over leading batch axis; shard the batch over `dp`.

    Returns a batched AlignResult.  The vmapped while_loop runs until
    the slowest pair in the batch converges (standard vmap semantics).
    Compiled once per (params, batch/cloud shape) — rebuilding the
    vmapped closure per call would defeat jit's cache and pay a full
    recompile every invocation.

    `R0` [B,3,3] / `T0` [B,3] / `ell0` [B] warm-start each lane (the
    reference's across-pair R/T/ell persistence — see
    core.registration.align); all three must be given together or not
    at all (one compiled signature each way).
    """
    fn = _compiled_align_batched(p)
    warm = (R0, T0, ell0)
    if any(w is not None for w in warm):
        if any(w is None for w in warm):
            raise ValueError("pass R0, T0 and ell0 together")
    if mesh is not None:
        sharding = NamedSharding(mesh, P(dp_axis))
        fixed_batch = jax.tree_util.tree_map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(*( (dp_axis,) + (None,) * (a.ndim - 1) )))
            ),
            fixed_batch,
        )
        moving_batch = jax.tree_util.tree_map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P(*( (dp_axis,) + (None,) * (a.ndim - 1) )))
            ),
            moving_batch,
        )
        del sharding
    if any(w is not None for w in warm):
        return fn(fixed_batch, moving_batch, *warm)
    return fn(fixed_batch, moving_batch)
