"""Frame-to-frame RKHS SE(3) registration — the align loop under jit.

Re-design of cvo::align (cvo.cpp:361-420) and acvo::align
(adaptive_cvo.cpp:490-555): the whole gradient flow runs as a single
`lax.while_loop` inside one XLA program — early exit without recompiles,
static shapes throughout, dense masked Gram per iteration.

Reference loop semantics reproduced exactly (order matters):

  per iteration k (cvo.cpp:366-411):
    tf   = [R', -R'T]                  (update_tf, cvo.cpp:83-87)
    y    = tf * y0                     (transform_pcd, cvo.cpp:310-315)
    A    = se_kernel(ell)              (cvo.cpp:99-161)
    omega, v [, dl]                    (compute_flow)
    step                               (compute_step_size)
    if |omega|<eps and |v|<eps: break  (BEFORE the update, cvo.cpp:380)
    dR, dT = Exp_SEK3([omega;v], step) (cvo.cpp:391)
    T = R dT + T ; R = R dR            (cvo.cpp:398-399)
    if dist_se3(dR,dT)<eps_2: break    (AFTER the update, cvo.cpp:402)
    ell schedule / adaptive update     (cvo.cpp:408-410 / adaptive_cvo.cpp:537-545)

  postlude (cvo.cpp:413-415): accum uses the tf computed at the *top* of
  the last executed iteration — i.e. when the loop breaks on the
  eps_2 test the final (dR,dT) update is NOT folded into accum.  We
  return that same `tf` so the odometry driver chains identically.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core import flow as flow_mod
from cvo_rgbd_tpu.core import gram as gram_mod
from cvo_rgbd_tpu.core.cloud import LANE, PointCloud, kd_sort, transform_cloud
from cvo_rgbd_tpu.core.step import step_size
from cvo_rgbd_tpu.params import AcvoParams


class AlignState(NamedTuple):
    k: jnp.ndarray          # iteration counter
    R: jnp.ndarray          # [3,3]
    T: jnp.ndarray          # [3]
    ell: jnp.ndarray        # current length-scale
    ell_max: jnp.ndarray    # adaptive ceiling (unused for cvo)
    tf: jnp.ndarray         # [4,4] inverse transform from top of last iter
    converged: jnp.ndarray  # bool
    omega: jnp.ndarray      # [3] last flow (for diagnostics)
    v: jnp.ndarray          # [3]


class AlignResult(NamedTuple):
    tf: jnp.ndarray         # [4,4] the transform the reference chains into accum
    R: jnp.ndarray          # final R (internal state)
    T: jnp.ndarray          # final T
    iterations: jnp.ndarray
    converged: jnp.ndarray
    ell: jnp.ndarray
    omega: jnp.ndarray
    v: jnp.ndarray


def _schedule_ell(ell, k, sched):
    """Fixed schedule (cvo.cpp:408-410): applied at end of iteration k."""
    for thresh, val in sched:
        ell = jnp.where(k > thresh, jnp.asarray(val, ell.dtype), ell)
    return ell


def _gram(p, x: PointCloud, y_pos, y_cloud: PointCloud, ell, ci):
    fast = getattr(p, "exp_mode", "precise") == "fast"
    if p.color_mode == "linear":
        return gram_mod.matlab_gram(
            x.positions, x.mask, y_pos, y_cloud.mask, ci, ell,
            sigma=p.sigma, sp_thres=p.sp_thres, fast_exp=fast,
        )
    return gram_mod.se_gram(
        x.positions, x.features, x.mask,
        y_pos, y_cloud.features, y_cloud.mask,
        ell,
        sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
        sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres, fast_exp=fast,
    )


def make_align_step(p, adaptive: bool):
    """Build the per-iteration body shared by cvo/acvo align."""

    use_pallas = getattr(p, "backend", "xla") == "pallas"
    if use_pallas:
        from cvo_rgbd_tpu.core.cubic import cubic_roots, min_positive_root
        from cvo_rgbd_tpu.core.moments import (
            flow_from_moments, step_from_moments,
        )
        from cvo_rgbd_tpu.ops import fused_moments, fused_wsq

    def body(state: AlignState, fixed: PointCloud, moving: PointCloud, ci,
             moments_pre=None, cheb_pre=None):
        tf_R, tf_T = se3.se3_inv(state.R, state.T)
        tf = se3.make_se3(tf_R, tf_T)
        y_pos = transform_cloud(tf_R, tf_T, moving.positions)

        if use_pallas:
            # SINGLE tile sweep per iteration (ops/moment_kernel.py):
            # accumulate the moment matrix A^T Phi(x - c0)
            # (omega-independent), then both the flow AND the
            # line-search coefficients are O(M) epilogues
            # (core/moments.py) — the reference's two nnz(A)
            # traversals (cvo.cpp:164-308) collapse into one pass.
            c0, x_c, phi = moments_pre
            Mom, nnz_xy = fused_moments(
                x_c, fixed.features, fixed.mask,
                y_pos - c0, moving.features, moving.mask,
                phi, state.ell, p=p,
            )
            omega, v, wsq_xy, _ = flow_from_moments(
                Mom, y_pos, c0, c=p.c, d=p.d
            )
            if adaptive:
                # self-kernels only feed the dl reduction — lean sweeps
                # (adaptive_cvo.cpp:156-160, 222-271)
                if cheb_pre is not None:
                    # self_mode="cheb": the four reductions are
                    # functions of ell ALONE — interpolate the per-
                    # align log-space Chebyshev tables instead of
                    # sweeping (build_selfsweep_cheb; params.self_mode)
                    logv, (lo_t, hi_t, xch, wts) = cheb_pre
                    t = jnp.log(1.0 / (2.0 * state.ell * state.ell))
                    x = jnp.clip(
                        (2.0 * t - (lo_t + hi_t)) / (hi_t - lo_t),
                        -1.0, 1.0,
                    )
                    dch = x - xch
                    hit = jnp.abs(dch) < 1e-10
                    tt = wts / jnp.where(hit, 1.0, dch)
                    interp = (jnp.sum(tt[None, :] * logv, axis=1)
                              / jnp.sum(tt))
                    exact_row = jnp.sum(
                        jnp.where(hit[None, :], logv, 0.0), axis=1
                    )
                    logvals = jnp.where(jnp.any(hit), exact_row, interp)
                    wsq_xx, nnz_xx, wsq_yy, nnz_yy = jnp.exp(logvals)
                else:
                    wsq_xx, nnz_xx = fused_wsq(
                        fixed.positions, fixed.features, fixed.mask,
                        fixed.positions, fixed.features, fixed.mask,
                        state.ell, p=p, symmetric=True,
                    )
                    wsq_yy, nnz_yy = fused_wsq(
                        y_pos, moving.features, moving.mask,
                        y_pos, moving.features, moving.mask, state.ell,
                        p=p, symmetric=True,
                    )
                ell3 = state.ell ** 3
                numer = (wsq_yy - 2.0 * wsq_xy + wsq_xx) / ell3
                denom = nnz_xx + nnz_yy - 2.0 * nnz_xy
                denom = jnp.where(denom == 0, 1.0, denom)
                dl = numer / denom
            else:
                dl = jnp.zeros((), jnp.float32)

            B, C, D, E = step_from_moments(
                Mom, y_pos, c0, omega, v, state.ell
            )
            roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
            step = min_positive_root(roots, valid, p.min_step, p.max_step)
        else:
            A = _gram(p, fixed, y_pos, moving, state.ell, ci)
            omega, v = flow_mod.flow(A, fixed.positions, y_pos, c=p.c, d=p.d)

            if adaptive:
                # self-kernels Axy/Axx/Ayy (adaptive_cvo.cpp:156-160); Axx is
                # iteration-dependent only through ell; Ayy moves with y.
                Axx = _gram(p, fixed, fixed.positions, fixed, state.ell, ci)
                Ayy = gram_mod.se_gram(
                    y_pos, moving.features, moving.mask,
                    y_pos, moving.features, moving.mask,
                    state.ell,
                    sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
                    sp_thres=p.sp_thres, c_sp_thres=p.c_sp_thres,
                    fast_exp=getattr(p, "exp_mode", "precise") == "fast",
                )
                dl = flow_mod.adaptive_dl(
                    A, Axx, Ayy, fixed.positions, y_pos, state.ell,
                    num_fixed=fixed.num_valid(), yy_quirk=p.yy_quirk,
                )
            else:
                dl = jnp.zeros((), jnp.float32)

            if getattr(p, "step_mode", "factored") == "factored":
                from cvo_rgbd_tpu.core.cubic import (
                    cubic_roots as _roots, min_positive_root as _minroot,
                )
                from cvo_rgbd_tpu.core.step_factored import (
                    step_coefficients_factored,
                )

                B, C, D, E = step_coefficients_factored(
                    A, fixed.positions, y_pos, omega, v, state.ell
                )
                r_, v_ = _roots(4.0 * E, 3.0 * D, 2.0 * C, B)
                step = _minroot(r_, v_, p.min_step, p.max_step)
            else:
                step = step_size(
                    A, fixed.positions, y_pos, omega, v, state.ell,
                    min_step=p.min_step, max_step=p.max_step,
                )

        # stop 1: flow norm, BEFORE the update (cvo.cpp:380)
        stop1 = (jnp.linalg.norm(omega) < p.eps) & (jnp.linalg.norm(v) < p.eps)

        dR, dT = se3.exp_sek3(omega, v, step)
        # pinned matmuls: a reduced-precision default (bf16 passes, or
        # TF32 on a GPU) makes the R @ dR chain rough enough to stall
        # contraction above the 5e-5 stop (se3.py note)
        _hi = jax.lax.Precision.HIGHEST
        R_new = jnp.where(
            stop1, state.R, jnp.matmul(state.R, dR, precision=_hi)
        )
        T_new = jnp.where(
            stop1, state.T,
            jnp.matmul(state.R, dT[..., None], precision=_hi)[..., 0]
            + state.T,
        )

        # stop 2: se3 distance, AFTER the update (cvo.cpp:402)
        stop2 = se3.dist_se3(dR, dT) < p.eps_2
        converged = stop1 | stop2

        if adaptive:
            # ell update + shrinking ceiling + floor (adaptive_cvo.cpp:537-545)
            ell_new = state.ell + p.dl_step * dl
            hit = ell_new >= state.ell_max
            ell_max_new = jnp.where(hit, state.ell_max * p.ell_shrink, state.ell_max)
            ell_new = jnp.where(hit, state.ell_max * p.ell_shrink, ell_new)
            ell_new = jnp.maximum(ell_new, p.ell_min)
        else:
            ell_new = _schedule_ell(state.ell, state.k, p.ell_sched)
            ell_max_new = state.ell_max

        # the reference `break` skips the ell update; keep ell frozen when
        # converged so diagnostics match
        ell_new = jnp.where(converged, state.ell, ell_new)

        new_state = AlignState(
            k=state.k + 1,
            R=R_new,
            T=T_new,
            ell=ell_new,
            ell_max=ell_max_new,
            tf=tf,
            converged=converged,
            omega=omega,
            v=v,
        )
        # Freeze everything once converged.  Under plain while_loop the
        # body never runs with converged=True, but under vmap the loop
        # continues until ALL batch lanes converge and converged lanes
        # must not move.
        return AlignState(
            *(jnp.where(state.converged, old, new)
              for old, new in zip(state, new_state))
        )

    return body


def prepare_ci(p, fixed: PointCloud, moving: PointCloud):
    """Linear-mode CI tile (rkhs_se3_registration.m:108), precomputed
    once per pair for the XLA path; None for se mode and for the
    moment kernel, which recomputes the 5-wide dot per tile."""
    if p.color_mode != "linear" or getattr(p, "backend", "xla") == "pallas":
        return None
    return gram_mod.linear_color_gram(
        fixed.features, moving.features, p.color_scale
    )


def build_moments_pre(p, fixed: PointCloud):
    """Per-pair precomputation for the moment kernel: (c0, x - c0,
    Phi(x - c0)).  The fixed cloud never transforms, so its centered
    monomial features are loop-invariant; c0 (the masked centroid)
    bounds |x'| at cloud-extent scale, which keeps the degree-4
    monomial cancellation in fp32 range (see core/step_factored.py's
    centering note)."""
    if getattr(p, "backend", "xla") != "pallas":
        return None
    from cvo_rgbd_tpu.core.step_factored import monomial_features

    w = fixed.mask.astype(jnp.float32)
    c0 = jnp.sum(fixed.positions * w[:, None], axis=0) / jnp.maximum(
        jnp.sum(w), 1.0
    )
    x_c = fixed.positions - c0
    return c0, x_c, monomial_features(x_c)


def kernel_order(p, cloud: PointCloud) -> PointCloud:
    """kd-sort a cloud for the moment kernel (core/cloud.kd_sort):
    point order is semantically irrelevant, but compact tiles are what
    lets the AABB pruning skip — raster/sample order gives every tile
    a scene-wide bounding box.  Unconditional under the pallas backend
    (tile_skip on/off stays bitwise comparable); capacities that are
    not whole kd cells keep their order."""
    if getattr(p, "backend", "xla") != "pallas" or cloud.capacity % LANE:
        return cloud
    return kd_sort(cloud)


def build_selfsweep_cheb(p, adaptive, fixed: PointCloud,
                         moving: PointCloud, ell0=None):
    """Per-align Chebyshev tables for the adaptive self-kernel
    reductions (params.self_mode="cheb"): wsq_xx/nnz_xx/wsq_yy/nnz_yy
    are functions of ell ALONE (the self distances are rigid-invariant,
    adaptive_cvo.cpp:156-160's per-iteration recomputation carries no
    information), so K lean sweeps at log-u Chebyshev nodes replace a
    sweep pair EVERY iteration.  Measured accuracy: ~0.4% on the
    values (the a>sp_thres gate kinks bound polynomial convergence),
    a few percent on dl after its cancelling numerator.  Returns
    (log_values [4, K], (lo, hi, nodes, weights)) or None."""
    if (
        not adaptive
        or getattr(p, "backend", "xla") != "pallas"
        or getattr(p, "self_mode", "exact") != "cheb"
    ):
        return None
    import numpy as _np

    from cvo_rgbd_tpu.ops import fused_wsq

    K = int(getattr(p, "self_cheb_k", 12))
    # table span [ell_min, ell_hi].  ell never exceeds ell_max_init
    # during a run (ell_max only shrinks) and warm-start ell0 handles
    # from a previous align are therefore in-range by construction —
    # but a user-supplied CONCRETE ell0 above ell_max_init would
    # otherwise clamp to the table edge and evaluate the self sweeps
    # at the wrong length-scale (round-5 review finding).  Traced
    # ell0 keeps the static default span.
    ell_hi = p.ell_max_init
    if ell0 is not None:
        try:
            ell_hi = max(ell_hi, float(ell0))
        except (TypeError, jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError):
            pass
    lo = float(_np.log(1.0 / (2.0 * ell_hi ** 2)))
    hi = float(_np.log(1.0 / (2.0 * p.ell_min ** 2)))
    kk = _np.arange(K)
    xch = _np.cos(_np.pi * (kk + 0.5) / K)
    t_nodes = 0.5 * (lo + hi) + 0.5 * (hi - lo) * xch
    ell_nodes = 1.0 / _np.sqrt(2.0 * _np.exp(t_nodes))
    wts = ((-1.0) ** kk) * _np.sin(_np.pi * (kk + 0.5) / K)

    cols = []
    for e in ell_nodes:
        ell = jnp.float32(e)
        wxx, nxx = fused_wsq(
            fixed.positions, fixed.features, fixed.mask,
            fixed.positions, fixed.features, fixed.mask,
            ell, p=p, symmetric=True,
        )
        wyy, nyy = fused_wsq(
            moving.positions, moving.features, moving.mask,
            moving.positions, moving.features, moving.mask,
            ell, p=p, symmetric=True,
        )
        cols.append(jnp.stack([wxx, nxx, wyy, nyy]))
    logv = jnp.log(jnp.maximum(jnp.stack(cols, axis=1), 1e-30))
    meta = (
        jnp.float32(lo), jnp.float32(hi),
        jnp.asarray(xch, jnp.float32), jnp.asarray(wts, jnp.float32),
    )
    return logv, meta


def align(
    p,
    fixed: PointCloud,
    moving: PointCloud,
    R0=None,
    T0=None,
    ell0=None,
) -> AlignResult:
    """Register `moving` onto `fixed`; pure function of its inputs.

    `p` (CvoParams/AcvoParams) is static — jit with
    `jax.jit(align, static_argnums=0)` or use the cached wrapper in
    `cvo_rgbd_tpu.api`.

    `R0`/`T0` seed the internal R, T state.  The reference never resets
    its R/T members between pairs (cvo.cpp:43-45 initialize them once;
    align at cvo.cpp:398-399 leaves the converged values behind), so a
    sequential odometry run warm-starts every pair after the first with
    the previous pair's relative transform — pass `AlignResult.R/.T` of
    the preceding pair for that semantics (odometry.run_odometry does).

    `ell0` seeds the kernel length-scale.  cvo also never resets `ell`
    between pairs, so iterations 0-2 of every pair after the first run
    at the ell the previous align ended on (the k>2/9/19 schedule,
    cvo.cpp:408-410, overwrites it with absolute values from iteration
    3 on).  acvo DOES reset ell per pair (adaptive_cvo.cpp:475).
    Defaults to `p.ell_init`.
    """
    adaptive = isinstance(p, AcvoParams)
    fixed = kernel_order(p, fixed)
    moving = kernel_order(p, moving)
    dtype = jnp.float32
    R0 = jnp.eye(3, dtype=dtype) if R0 is None else jnp.asarray(R0, dtype)
    T0 = jnp.zeros(3, dtype=dtype) if T0 is None else jnp.asarray(T0, dtype)
    ell0 = p.ell_init if ell0 is None else ell0

    ci = prepare_ci(p, fixed, moving)

    ell_max0 = p.ell_max_init if adaptive else 1e9
    init = AlignState(
        k=jnp.zeros((), jnp.int32),
        R=R0,
        T=T0,
        ell=jnp.asarray(ell0, dtype),
        ell_max=jnp.asarray(ell_max0, dtype),
        tf=jnp.eye(4, dtype=dtype),
        converged=jnp.zeros((), bool),
        omega=jnp.zeros(3, dtype),
        v=jnp.zeros(3, dtype),
    )

    body = make_align_step(p, adaptive)
    moments_pre = build_moments_pre(p, fixed)
    cheb_pre = build_selfsweep_cheb(p, adaptive, fixed, moving, ell0=ell0)

    def cond_fn(s: AlignState):
        return (s.k < p.max_iter) & ~s.converged

    def body_fn(s: AlignState):
        return body(s, fixed, moving, ci, moments_pre, cheb_pre)

    final = jax.lax.while_loop(cond_fn, body_fn, init)

    # postlude (cvo.cpp:413-415): accum chains `tf` from the top of the
    # last executed iteration.  `iter` is k of the breaking iteration.
    return AlignResult(
        tf=final.tf,
        R=final.R,
        T=final.T,
        iterations=final.k - 1,
        converged=final.converged,
        ell=final.ell,
        omega=final.omega,
        v=final.v,
    )


def function_inner_product(p, cloud_a: PointCloud, cloud_b: PointCloud,
                           ell=None):
    """Mean kernel value over gated pairs (adaptive_cvo.cpp:385-439).

    A keyframe-selection hook in the reference (defined, not called by
    the shipped mains).  Note the reference uses sp_thres — not
    c_sp_thres — for the color gate here (adaptive_cvo.cpp:392).

    `ell`: the reference evaluates the kernel at the *current* member
    length-scale (adaptive_cvo.cpp:393) — i.e. whatever the last align
    left behind.  Pass `AlignResult.ell` of the preceding pair for
    reference semantics; defaults to `p.ell_init` (a fresh-state
    evaluation, which is what a keyframe scorer called before any align
    would see — acvo resets ell per pair, adaptive_cvo.cpp:476-485).

    Linear color mode (`p.color_mode == "linear"`, MATLAB_PARAMS)
    evaluates the mean of the MATLAB-mode A = CI .* K instead — the se
    color kernel was never calibrated for that parameter set
    (rkhs_se3_registration.m:40-53 vs adaptive_cvo.cpp:392); keyframe
    scoring under MATLAB params must use the same product kernel the
    align flow maximizes.
    """
    if ell is None:
        ell = p.ell_init
    if p.color_mode == "linear":
        ci = gram_mod.linear_color_gram(
            cloud_a.features, cloud_b.features, p.color_scale
        )
        A = gram_mod.matlab_gram(
            cloud_a.positions, cloud_a.mask,
            cloud_b.positions, cloud_b.mask,
            ci, jnp.asarray(ell, jnp.float32),
            sigma=p.sigma, sp_thres=p.sp_thres,
        )
    else:
        A = gram_mod.se_gram(
            cloud_a.positions, cloud_a.features, cloud_a.mask,
            cloud_b.positions, cloud_b.features, cloud_b.mask,
            jnp.asarray(ell, jnp.float32),
            sigma=p.sigma, c_ell=p.c_ell, c_sigma=p.c_sigma,
            sp_thres=p.sp_thres, c_sp_thres=p.sp_thres,
        )
    n = flow_mod.nnz(A)
    return jnp.sum(A) / jnp.maximum(n, 1).astype(jnp.float32)
