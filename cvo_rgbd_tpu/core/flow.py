"""Flow (twist) computation from the Gram matrix — matmul-factored.

The reference accumulates, per nonzero A_ij, cross/difference terms under
a spin mutex (cvo.cpp:164-210).  Those reductions factor exactly into
dense contractions — no [N*M,3] intermediates, no mutex, no fp64
accumulators needed:

    sum_ij A_ij (x_i x y_j)  =  sum_i x_i x (A @ Y)_i
    sum_ij A_ij (y_j - x_i)  =  (1^T A) @ Y  -  (A @ 1) @ X

and for adaptive CVO (adaptive_cvo.cpp:154-272):

    sum_ij A_ij |x_i - y_j|^2
        = (A@1).|X|^2 + (1^T A).|Y|^2 - 2 sum_i x_i.(A @ Y)_i
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Reduced-precision matmul passes (bf16 passes, or TF32 on a GPU) put a
# ~1e-3 relative noise floor on the distance/reduction contractions,
# which breaks the Gram symmetry cancellations and leaves a mm-level
# pose bias.  All contractions here pin full fp32 precision.
_HI = jax.lax.Precision.HIGHEST


def _cross(a, b):
    return jnp.cross(a, b, axis=-1)


def flow(A, x_pos, y_pos, *, c, d):
    """omega, v from dense masked A (cvo.cpp:164-210).

    DIFFERENCE-FORM reductions: the flow vanishes at convergence, so
    the naive factored forms (col@Y - row@X for v) subtract two LARGE
    sums whose fp32 rounding noise (~W*|y|*eps_mach, W = sum A) sits
    around 1e-5..1e-4 at reference scale — above the C++ stopping
    threshold eps=5e-5 (cvo.cpp:40; the reference converges because its
    accumulators are double, cvo.cpp:171-204).  Rewriting per-i,

        r_i = (A y)_i - (A 1)_i x_i = sum_j A_ij (y_j - x_i),

    every r_i is a kernel-weighted sum of SMALL differences (|y_j-x_i|
    <~ a few ell wherever A_ij > 0), so cancellation happens before the
    big reduction: measured flow error drops from ~1e-5 to ~1e-8 at
    N=3072 (PERF.md), restoring convergence at the reference's own
    tolerances in fp32 — no fp64 and no compensated accumulation
    needed.  Exactly the same algebra:
        sum_ij A_ij (y_j - x_i)   = sum_i r_i
        sum_ij A_ij (x_i x y_j)   = sum_i x_i x r_i      (x x x = 0)
    and the cross term is centered about the x centroid (exact for any
    center) to shrink the per-term magnitudes further.  r_i is
    row-local, so x-sharded / ring column-block callers (parallel/
    sharded.py) psum partials unchanged.

    A y is computed as elementwise row reductions (multiply + sum),
    NOT as a matmul: on the accelerator this was first written for,
    the [N,M]x[M,3] dot even at Precision.HIGHEST left |flow| floored
    ~3e-4 at N=3072 (vs ~1e-8 from the same code on CPU BLAS) — a
    narrow-RHS matmul's effective accumulation precision can fall far
    below fp32, and r_i inherits it before the cancellation.  The row
    reductions are exact fp32 and XLA fuses each into one pass over
    A."""
    row = jnp.sum(A, axis=-1)                                    # A @ 1, [N]
    Ay = jnp.stack(
        [jnp.sum(A * y_pos[..., None, :, k], axis=-1) for k in range(3)],
        axis=-1,
    )                                                            # [N,3]
    r = Ay - row[..., None] * x_pos                              # [N,3]
    r_sum = jnp.sum(r, axis=-2)
    v = r_sum / d
    c0 = jnp.mean(x_pos, axis=-2, keepdims=True)
    omega = (
        jnp.sum(_cross(x_pos - c0, r), axis=-2)
        + _cross(jnp.squeeze(c0, axis=-2), r_sum)
    ) / c
    return omega, v


def weighted_sqdist_sum(A, x_pos, y_pos):
    """sum_ij A_ij |x_i - y_j|^2, matmul-factored."""
    Ay = jnp.dot(A, y_pos, preferred_element_type=jnp.float32, precision=_HI)
    row = jnp.sum(A, axis=-1)
    col = jnp.sum(A, axis=-2)
    x2 = jnp.sum(x_pos * x_pos, axis=-1)
    y2 = jnp.sum(y_pos * y_pos, axis=-1)
    return (
        jnp.dot(row, x2, preferred_element_type=jnp.float32, precision=_HI)
        + jnp.dot(col, y2, preferred_element_type=jnp.float32, precision=_HI)
        - 2.0 * jnp.sum(x_pos * Ay)
    )


def nnz(A):
    """Count of surviving (gated-in) kernel entries."""
    return jnp.sum(A > 0)


def adaptive_dl(A, Axx, Ayy, x_pos, y_pos, ell, *, num_fixed=None, yy_quirk=False):
    """Length-scale gradient dl (adaptive_cvo.cpp:222-271).

    dl = [ sum Ayy|dyy|^2 - 2 sum Axy|dyx|^2 + sum Axx|dxx|^2 ] / ell^3,
    normalized by (nnz(Axx) + nnz(Ayy) - 2 nnz(A)).

    yy_quirk=True reproduces the reference bug where Ayy rows
    i < num_fixed read a zero |diff_yy|^2 buffer (adaptive_cvo.cpp:190,
    256), so Ayy contributes to the numerator only via rows
    i in [num_fixed, num_moving).  num_fixed must then be the *valid*
    fixed-point count (scalar).
    """
    ell3 = ell * ell * ell
    s_xy = weighted_sqdist_sum(A, x_pos, y_pos)
    s_xx = weighted_sqdist_sum(Axx, x_pos, x_pos)
    if yy_quirk:
        if num_fixed is None:
            raise ValueError("yy_quirk requires num_fixed")
        m = y_pos.shape[-2]
        rows = jnp.arange(m)
        keep = (rows >= num_fixed).astype(Ayy.dtype)
        Ayy_eff = Ayy * keep[:, None]
        s_yy = weighted_sqdist_sum(Ayy_eff, y_pos, y_pos)
    else:
        s_yy = weighted_sqdist_sum(Ayy, y_pos, y_pos)
    numer = (s_yy - 2.0 * s_xy + s_xx) / ell3
    denom = nnz(Axx) + nnz(Ayy) - 2 * nnz(A)
    denom = jnp.where(denom == 0, 1, denom).astype(numer.dtype)
    return numer / denom
