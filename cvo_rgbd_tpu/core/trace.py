"""Structured per-iteration diagnostics for convergence debugging.

The reference prints raw couts (cvo.cpp:380-405); the MATLAB prototype
prints an iteration table every 5 iterations
(rkhs_se3_registration.m:252-258).  `align_trace` runs a fixed number
of align iterations under `lax.scan` and returns the full per-iteration
record — exactly the quantities SURVEY.md section 5 names for
convergence debugging: |omega|, |v|, step, ell, and the se3 distance of
each update.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cvo_rgbd_tpu import se3
from cvo_rgbd_tpu.core.registration import (
    AlignState,
    build_moments_pre,
    build_selfsweep_cheb,
    kernel_order,
    make_align_step,
    prepare_ci,
)
from cvo_rgbd_tpu.params import AcvoParams

_HI = jax.lax.Precision.HIGHEST


class IterRecord(NamedTuple):
    omega_norm: jnp.ndarray
    v_norm: jnp.ndarray
    ell: jnp.ndarray
    dist: jnp.ndarray       # se3 distance of the applied update
    converged: jnp.ndarray


def align_trace(p, fixed, moving, n_iters: int):
    """Run exactly `n_iters` iterations, recording each one.

    Stopping rules still freeze the state (matching `align`); the scan
    just keeps emitting the frozen values afterwards.  Returns
    (final_state, IterRecord stacked over iterations).
    """
    adaptive = isinstance(p, AcvoParams)
    # mirror align(): the same point order, so the trace records the
    # fp32 reductions that align computes
    fixed = kernel_order(p, fixed)
    moving = kernel_order(p, moving)
    body = make_align_step(p, adaptive)
    ci = prepare_ci(p, fixed, moving)

    init = AlignState(
        k=jnp.zeros((), jnp.int32),
        R=jnp.eye(3, dtype=jnp.float32),
        T=jnp.zeros(3, jnp.float32),
        ell=jnp.asarray(p.ell_init, jnp.float32),
        ell_max=jnp.asarray(
            p.ell_max_init if adaptive else 1e9, jnp.float32
        ),
        tf=jnp.eye(4, dtype=jnp.float32),
        converged=jnp.zeros((), bool),
        omega=jnp.zeros(3, jnp.float32),
        v=jnp.zeros(3, jnp.float32),
    )

    moments_pre = build_moments_pre(p, fixed)
    cheb_pre = build_selfsweep_cheb(p, adaptive, fixed, moving)

    def scan_body(state, _):
        prev_R, prev_T = state.R, state.T
        new = jax.lax.cond(
            state.converged,
            lambda s: s,
            lambda s: body(s, fixed, moving, ci, moments_pre, cheb_pre),
            state,
        )
        prev_Rt = jnp.swapaxes(prev_R, -1, -2)
        dR = jnp.matmul(prev_Rt, new.R, precision=_HI)
        dT = jnp.matmul(prev_Rt, new.T - prev_T, precision=_HI)
        rec = IterRecord(
            omega_norm=jnp.linalg.norm(new.omega),
            v_norm=jnp.linalg.norm(new.v),
            ell=new.ell,
            dist=se3.dist_se3(dR, dT),
            converged=new.converged,
        )
        return new, rec

    final, recs = jax.lax.scan(scan_body, init, None, length=n_iters)
    return final, recs
