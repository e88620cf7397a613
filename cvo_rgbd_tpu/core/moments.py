"""Flow + line-search reductions from the A-weighted x-monomial moments.

The single-pass moment kernel (ops/moment_kernel.py) accumulates, in
ONE sweep over the Gram tiles, the omega-independent moment matrix

    Mom[j, m] = sum_i A_ij phi_m(x_i - c0)        [M, 35]

with phi the degree<=4 monomial basis of step_factored and c0 a fixed
per-pair center (the masked centroid of the fixed cloud).  Every
reduction of the reference iteration is then an O(M) epilogue:

- flow omega, v (cvo.cpp:164-210) and the adaptive weighted
  squared-distance sum (adaptive_cvo.cpp:222-271) are contractions of
  the degree<=2 moments with the (current) moving points;
- the quartic line-search coefficients B..E (cvo.cpp:213-289) contract
  the full moment matrix with the line-search polynomials of
  step_factored.line_search_polys — the only omega-dependent part, and
  it never touches an [N, M] object.

This removes the second Gram sweep per align iteration: the reference
traverses nnz(A) once for the flow and once for the step coefficients
(cvo.cpp:164-308); here both come from the same tile pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cvo_rgbd_tpu.core.step_factored import M_INDEX, line_search_polys

_HI = jax.lax.Precision.HIGHEST

_I000 = M_INDEX[(0, 0, 0)]
_I100 = M_INDEX[(1, 0, 0)]
_I010 = M_INDEX[(0, 1, 0)]
_I001 = M_INDEX[(0, 0, 1)]
_I200 = M_INDEX[(2, 0, 0)]
_I020 = M_INDEX[(0, 2, 0)]
_I002 = M_INDEX[(0, 0, 2)]


def flow_from_moments(Mom, y_pos, c0, *, c, d):
    """(omega, v, wsq, sum_A) from the moment matrix.

    DIFFERENCE-FORM epilogue (same rationale as core.flow.flow — the
    flow vanishes at convergence, so global cancellation between large
    sums leaves an fp32 noise floor above the reference's eps=5e-5;
    cvo.cpp:40, 171-204 converges on double accumulators).  Per-j,

        r_j = S0_j y'_j - S1'_j = sum_i A_ij (y_j - x_i)   (x'=x-c0,
                                                            y'=y-c0)

    cancels INSIDE each column before the j-reduction; measured flow
    error at N=3072 drops ~1000x to ~1e-8 (PERF.md), restoring
    convergence at the C++ tolerances with no extra precision, and
    equivalent in convergence to an in-kernel per-row residual
    accumulation once the SE(3) matmuls are precision-pinned.  Exact
    algebra (no
    approximation vs core.flow.flow):
      sum_ij A_ij (y_j - x_i)   = sum_j r_j
      sum_ij A_ij (x_i x y_j)   = sum_j S1full_j x y_j
                                = sum_j S1'_j x y'_j + c0 x sum_j r_j
        (S1full = S1' + S0 c0; the c0 x c0 and (sum S1') x c0 terms
         regroup exactly into the r_j sum)
      sum_ij A_ij |x_i-y_j|^2   = sum_j [tr S2'_j - 2 S1'_j.y'_j
                                         + S0_j |y'_j|^2]
    """
    S0 = Mom[:, _I000]                                        # [M]
    S1 = jnp.stack([Mom[:, _I100], Mom[:, _I010], Mom[:, _I001]], axis=1)
    S2tr = Mom[:, _I200] + Mom[:, _I020] + Mom[:, _I002]      # [M]

    y_c = y_pos - c0
    r = S0[:, None] * y_c - S1                                # [M,3]
    r_sum = jnp.sum(r, axis=0)
    v = r_sum / d
    omega = (
        jnp.sum(jnp.cross(S1, y_c, axis=-1), axis=0)
        + jnp.cross(c0, r_sum)
    ) / c

    s0_sum = jnp.sum(S0)
    wsq = (
        jnp.sum(S2tr)
        - 2.0 * jnp.sum(S1 * y_c)
        + jnp.dot(S0, jnp.sum(y_c * y_c, axis=-1),
                  preferred_element_type=jnp.float32, precision=_HI)
    )
    return omega, v, wsq, s0_sum


def step_from_moments(Mom, y_pos, c0, omega, v, ell):
    """B, C, D, E (cvo.cpp:249-289) by contracting the moment matrix
    directly against the line-search polynomials in their sparse
    monomial-dict form — no [M,140] coefficient stack, no matmuls.

    The previous form built the dense per-j coefficient stack (seven
    [M,140]x[140,35] HIGHEST-precision matmuls + ~27 MB of [M,140]
    intermediates per iteration at M=3072) and then contracted it
    against Mom.  But the contraction sum_j sum_e c_e[j] Mom[j,e] never
    needs the dense stack: each polynomial is ~15-35 monomial terms
    whose [M]-vector coefficients come straight out of the Poly product
    engine, so the whole epilogue is a fused elementwise chain over [M]
    vectors plus one reduction per polynomial.  Algebraically identical,
    with far fewer bytes moved per iteration."""
    P_B, P_C, P_D, P_E = line_search_polys(
        y_pos, y_pos - c0, omega, v, ell
    )

    def contract(P):
        acc = None
        for e, c in P.terms.items():
            t = c * Mom[:, M_INDEX[e]]
            acc = t if acc is None else acc + t
        return jnp.sum(acc)

    return contract(P_B), contract(P_C), contract(P_D), contract(P_E)
