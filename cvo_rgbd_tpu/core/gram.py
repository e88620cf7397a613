"""Masked dense Gram (kernel) matrix — the heart of CVO, on an accelerator.

The reference sparsifies the N x M squared-exponential kernel with a
kd-tree radius search plus threshold gates (cvo.cpp:99-161).  Here the
Gram matrix is evaluated *densely* (squared distances in difference
form, see pairwise_sqdist), and every gate of the reference becomes a
mask:

    d2      <  d2_thres    (the kd-tree radius test, cvo.cpp:119-125 —
                            identical by construction: the radius *is*
                            -2 l^2 log(sp_thres / s2), cvo.cpp:102)
    d2_col  <  d2_c_thres  (color gate, cvo.cpp:148)
    a       >  sp_thres    (final sparsity gate, cvo.cpp:152)
    valid_x, valid_y       (padding masks, no reference analog)

At the reference workload (N ~ M ~ 3000) this is ~9M pairs per
iteration, and it removes the entire nanoflann/triplet machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cvo_rgbd_tpu.core.numerics import exp_neg

# Reduced-precision matmul passes (bf16 passes, or TF32 on a GPU) put a
# ~1e-3 relative noise floor on the distance/reduction contractions,
# which breaks the Gram symmetry cancellations and leaves a mm-level
# pose bias.  All contractions here pin full fp32 precision.
_HI = jax.lax.Precision.HIGHEST


def pairwise_sqdist(x, y):
    """[N,d],[M,d] -> [N,M] squared distances, DIFFERENCE form.

    Matches rkhs_se3_registration.m:68-69 (the MATLAB dense spec).

    Computed per component as (x_k - y_k)^2 — NOT as the expanded
    |x|^2 + |y|^2 - 2 x.y matmul: with |pos|^2 up to ~16 m^2 and
    kernel-relevant d2 down at ell^2 ~ 1e-3, the expanded form's fp32
    cancellation leaves ~1e-6 m^2 absolute noise, which the exponent's
    1/(2 ell^2) = 556 turns into ~4e-5 relative noise on every Gram
    entry — that roughness floored the align flow at ~2.5e-4 and
    blocked the reference's eps=5e-5 stop (PERF.md).
    The difference form subtracts nearby coordinates FIRST (exact at
    fp32), then squares; three fused elementwise passes instead of one
    matmul — the moment kernel does it this way too (_pair_tile).
    """
    d2 = None
    for k in range(x.shape[-1]):
        dk = x[..., :, None, k] - y[..., None, :, k]
        d2 = dk * dk if d2 is None else d2 + dk * dk
    return d2


def se_gram(
    x_pos,
    x_feat,
    x_mask,
    y_pos,
    y_feat,
    y_mask,
    ell,
    *,
    sigma,
    c_ell,
    c_sigma,
    sp_thres,
    c_sp_thres,
    fast_exp=False,
):
    """Masked dense A = (s^2 e^{-d2/2l^2}) * (cs^2 e^{-d2c/2cl^2}).

    Reference: cvo::se_kernel (cvo.cpp:99-161) and the parameterized
    acvo::se_kernel (adaptive_cvo.cpp:92-151).  Returns the dense [N,M]
    coefficient matrix with gated-out entries exactly 0.
    """
    s2 = sigma * sigma
    cs2 = c_sigma * c_sigma
    d2_thres = -2.0 * ell * ell * jnp.log(sp_thres / s2)
    d2_c_thres = -2.0 * c_ell * c_ell * jnp.log(c_sp_thres / cs2)

    d2 = pairwise_sqdist(x_pos, y_pos)
    d2c = pairwise_sqdist(x_feat, y_feat)

    # exp_neg by default, not jnp.exp: hardware exp's ~1e-6 error flips
    # gate membership as the pose moves and stalls convergence at
    # reference scale (core/numerics.py).  fast_exp
    # (params.exp_mode="fast") trades that for ~30% cheaper kernels —
    # fine at the MATLAB stops.
    _exp = (lambda z: jnp.exp(-z)) if fast_exp else exp_neg
    k = s2 * _exp(d2 / (2.0 * ell * ell))
    ck = cs2 * _exp(d2c / (2.0 * c_ell * c_ell))
    a = k * ck

    gate = (
        (d2 < d2_thres)
        & (d2c < d2_c_thres)
        & (a > sp_thres)
        & (x_mask[..., :, None] > 0)
        & (y_mask[..., None, :] > 0)
    )
    return jnp.where(gate, a, 0.0)


def linear_color_gram(x_feat, y_feat, color_scale):
    """MATLAB-mode color weights: CI = scale * Cx Cz' — a *linear* color
    kernel computed once per pair (rkhs_se3_registration.m:40-53),
    unlike the C++ squared-exponential color kernel (cvo.cpp:150)."""
    return color_scale * jnp.dot(
        x_feat, y_feat.T, preferred_element_type=jnp.float32, precision=_HI
    )


def matlab_gram(x_pos, x_mask, y_pos, y_mask, ci, ell, *, sigma, sp_thres,
                fast_exp=False):
    """MATLAB-mode A: K = se_kernel; K[K < sp] = 0; A = CI .* K
    (rkhs_se3_registration.m:125-127)."""
    s2 = sigma * sigma
    d2 = pairwise_sqdist(x_pos, y_pos)
    _exp = (lambda z: jnp.exp(-z)) if fast_exp else exp_neg
    k = s2 * _exp(d2 / (2.0 * ell * ell))
    gate = (
        (k >= sp_thres)
        & (x_mask[..., :, None] > 0)
        & (y_mask[..., None, :] > 0)
    )
    return jnp.where(gate, ci * k, 0.0)
