"""Precision helpers for the compute path.

`exp_neg` exists because an accelerator's hardware `exp` may be a fast
approximation: the one this system was first written for had ~1e-6
median relative error, vs ~3e-8 for host libm.  That looks harmless,
but the Gram gates (`a > sp_thres`, cvo.cpp:152) turn it into
flow-field ROUGHNESS: an entry whose kernel value wiggles across
the threshold as the pose moves flips in/out of the support, each flip
jolting the flow by ~sp_thres*|x-y|/d ~ 2e-5 — and at reference scale
(N=M=3072, ell=0.03) those jolts stalled the align's contraction in a
limit cycle at |flow| ~ 3e-4, above the reference's eps=5e-5 stop
(which the C++ meets with libm exp + double accumulators; see
PERF.md).  Whether the H100's exp needs it is an open question
(ROADMAP S6); `params.exp_mode="fast"` selects the hardware exp.

exp_neg(z) = 2^-n * p(-r),  n = round(z*log2 e),  r = z - n*ln 2

with a Cody-Waite two-part ln2 reduction (r exact to ~1e-12: n*ln2_hi
is exact for n < 2^12 since ln2_hi carries 11 significand bits, and
z - n*ln2_hi is a Sterbenz-exact nearby subtraction) and a degree-7
least-squares polynomial on [-ln2/2, ln2/2] (fit error 1e-10).  The
whole fp32 pipeline measures max 9.5e-8 relative error over z in
[0, 12] — libm quality, ~8 elementwise ops, no tables, and it lowers
under XLA and inside the Triton kernels (floor, int shift, bitcast).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LN2_HI = 0.693145751953125      # 11 significand bits, exact n* products
_LN2_LO = 1.42860677e-06
_LOG2E = 1.4426950408889634
# degree-7 relative-error LSQ fit of e^x on [-ln2/2, ln2/2]
_EXP_COEF = (
    9.9999999997e-01, 1.0000000002e+00, 5.0000000815e-01,
    1.6666665277e-01, 4.1666287710e-02, 8.3335634999e-03,
    1.3944149940e-03, 1.9761959601e-04,
)
# exp(-80) ~ 1.8e-35 is still a normal fp32; everything beyond is
# gated off by construction (sp_thres ~ 1e-2 corresponds to z ~ 5)
_Z_MAX = 80.0


def exp_neg(z):
    """Accurate exp(-z) for z >= 0 (fp32, ~1e-7 relative; see module
    docstring).  Elementwise; safe inside Pallas kernels."""
    z = jnp.minimum(z, _Z_MAX)
    # round-half-up via floor: Triton has no round-to-nearest-even, and
    # a tie only moves r to the other end of [-ln2/2, ln2/2]
    n = jnp.floor(z * _LOG2E + 0.5)
    r = (z - n * _LN2_HI) - n * _LN2_LO
    p = jnp.full_like(z, _EXP_COEF[7])
    for c in _EXP_COEF[6::-1]:
        p = p * (-r) + c
    ni = n.astype(jnp.int32)
    two_pow = jax.lax.bitcast_convert_type(
        (jnp.int32(127) - ni) << 23, jnp.float32
    )
    return p * two_pow
