"""Moment-factored line-search coefficients — one matmul instead of
four [N, M] field materializations.

Each per-pair quantity of cvo::compute_step_size (cvo.cpp:249-289) is a
product of *affine* functions of x_i:

    beta_ij  = p_j . x~_i        (x~ = [1, x], p_j from xiz_j, y_j)
    gamma_ij = q_j . x~_i        etc.

so B, C, D, E = sum_ij A_ij P_k(x_i) with P_k polynomials of degree
<= 4 in x_i whose coefficients depend only on j.  Expanding the
polynomials in the 35-dim monomial basis of degree <= 4 over
(x0, x1, x2):

    O_k = sum( (A @ C_k) * Phi )

with Phi [N, 35] the monomial features of the fixed cloud and C_k
[M, 35] the per-j coefficients — the entire line-search reduction is
one [N,M]x[M,140] matmul, no [N,M] intermediates at all.

The polynomial algebra (products of affine forms) is done by a tiny
static Poly engine at trace time; everything lowers to elementwise
[M]-vector arithmetic.

Numerical note: the expansion evaluates large monomial terms whose
difference is the small direct value (relative cancellation ~|x-y|/|x|),
so coefficients carry ~1e-3 relative fp32 error vs the direct path —
irrelevant for a line search (the quartic model is itself a Taylor
approximation), and covered by tests against the direct implementation.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

# monomial basis: exponent triples (e0, e1, e2) with sum <= 4
MONOMIALS = [
    e
    for total in range(5)
    for e in sorted(
        {
            tuple(m)
            for m in itertools.product(range(5), repeat=3)
            if sum(m) == total
        }
    )
]
M_INDEX = {e: i for i, e in enumerate(MONOMIALS)}
NUM_MONO = len(MONOMIALS)  # 35


class Poly:
    """Polynomial in (x0, x1, x2), coefficients are [M]-vectors."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})  # {exponent_triple: [M] array}

    @staticmethod
    def affine(a, b):
        """a + b . x with a [M], b [M,3]."""
        return Poly({
            (0, 0, 0): a,
            (1, 0, 0): b[:, 0],
            (0, 1, 0): b[:, 1],
            (0, 0, 1): b[:, 2],
        })

    def __add__(self, other):
        out = dict(self.terms)
        for e, c in other.terms.items():
            out[e] = out[e] + c if e in out else c
        return Poly(out)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return Poly({e: c * other for e, c in self.terms.items()})
        out = {}
        for e1, c1 in self.terms.items():
            for e2, c2 in other.terms.items():
                e = (e1[0] + e2[0], e1[1] + e2[1], e1[2] + e2[2])
                if sum(e) > 4:
                    raise ValueError("degree > 4")
                c = c1 * c2
                out[e] = out[e] + c if e in out else c
        return Poly(out)

    __rmul__ = __mul__

    def coeffs(self, m):
        """Stack into a dense [M, 35] coefficient matrix."""
        cols = []
        zero = None
        for e in MONOMIALS:
            if e in self.terms:
                cols.append(self.terms[e])
                zero = jnp.zeros_like(self.terms[e])
            else:
                cols.append(None)
        zero = zero if zero is not None else jnp.zeros((m,), jnp.float32)
        return jnp.stack([c if c is not None else zero for c in cols], axis=1)


def monomial_features(x):
    """[N,3] -> [N,35] monomial features (static unroll)."""
    x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
    pows = [
        [jnp.ones_like(x0), x0, x0 * x0, x0**3, x0**4],
        [jnp.ones_like(x1), x1, x1 * x1, x1**3, x1**4],
        [jnp.ones_like(x2), x2, x2 * x2, x2**3, x2**4],
    ]
    feats = [
        pows[0][e[0]] * pows[1][e[1]] * pows[2][e[2]] for e in MONOMIALS
    ]
    return jnp.stack(feats, axis=1)


# ---------------------------------------------------------------------------
# Vectorized polynomial algebra: dense [M,35] coefficient arrays with
# multiplication-by-affine as ONE outer product + ONE static sparse
# matmul.  The scalar Poly engine above emits ~90 tiny column fusions
# per align iteration (each a separate kernel launch); this form
# lowers to ~2 kernels per product.
# ---------------------------------------------------------------------------

_AFFINE_MONOS = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]


def _product_map():
    """[140, 35] 0/1 matrix scattering (mono_i, affine_a) -> mono.

    Kept as a host numpy constant: caching a jnp array built inside a
    trace would leak a tracer into later traces.
    """
    import numpy as _np

    S = _np.zeros((NUM_MONO * 4, NUM_MONO), _np.float32)
    for i, mono in enumerate(MONOMIALS):
        for a, am in enumerate(_AFFINE_MONOS):
            tgt = (mono[0] + am[0], mono[1] + am[1], mono[2] + am[2])
            if sum(tgt) <= 4:
                S[i * 4 + a, M_INDEX[tgt]] = 1.0
    return S


_PRODUCT_MAP_NP = _product_map()


def _dense_affine(a, b):
    """a [M], b [M,3] -> dense [M,35] polynomial a + b.x."""
    m = a.shape[0]
    out = jnp.zeros((m, NUM_MONO), jnp.float32)
    out = out.at[:, M_INDEX[(0, 0, 0)]].set(a)
    out = out.at[:, M_INDEX[(1, 0, 0)]].set(b[:, 0])
    out = out.at[:, M_INDEX[(0, 1, 0)]].set(b[:, 1])
    out = out.at[:, M_INDEX[(0, 0, 1)]].set(b[:, 2])
    return out


def _affine4(a, b):
    """[M,4] compact affine coefficients [a, b0, b1, b2]."""
    return jnp.stack([a, b[:, 0], b[:, 1], b[:, 2]], axis=1)


def _mul_affine(P, Q4):
    """P [M,35] (degree <= 3) times affine Q4 [M,4] -> [M,35]."""
    m = P.shape[0]
    outer = (P[:, :, None] * Q4[:, None, :]).reshape(m, NUM_MONO * 4)
    return jnp.dot(outer, jnp.asarray(_PRODUCT_MAP_NP),
                   preferred_element_type=jnp.float32, precision=_HI)


def affine_forms(y_field, y_pair, omega, v, ell):
    """Per-j affine coefficients (a [M], b [M,3]) of the four line-search
    integrand factors beta/gamma/delta/epsilon (cvo.cpp:262-271), as
    functions of the fixed point x:  factor_ij = a_j + b_j . x_i.

    `y_field`: ORIGINAL (uncentered) moving points — the derivative
    fields xi^k z are built from them (cvo.cpp:226-238).
    `y_pair`: the same points shifted by whatever center the x monomials
    use — only the (x - y) pairings see the shift, which is exact.
    """
    from cvo_rgbd_tpu.se3 import skew

    w_hat = skew(omega)
    _mm = lambda a, b: jnp.matmul(a, b, precision=_HI)  # noqa: E731
    w2 = _mm(w_hat, w_hat)
    w3 = _mm(w2, w_hat)
    w4 = _mm(w3, w_hat)

    xiz = jnp.cross(jnp.broadcast_to(omega, y_field.shape), y_field,
                    axis=-1) + v
    xi2z = jnp.matmul(y_field, w2.T, precision=_HI) + _mm(w_hat, v[..., None])[..., 0]
    xi3z = jnp.matmul(y_field, w3.T, precision=_HI) + _mm(w2, v[..., None])[..., 0]
    xi4z = jnp.matmul(y_field, w4.T, precision=_HI) + _mm(w3, v[..., None])[..., 0]

    normxiz2 = jnp.sum(xiz * xiz, axis=-1)
    xzx2 = -jnp.sum(xiz * xi2z, axis=-1)
    eps_const = jnp.sum(xi2z * xi2z, axis=-1) + 2.0 * jnp.sum(
        xiz * xi3z, axis=-1
    )

    tc = 1.0 / (2.0 * ell * ell)
    b_a = 2.0 * tc * jnp.sum(xiz * y_pair, -1)
    b_b = -2.0 * tc * xiz
    g_a = -tc * normxiz2 + 2.0 * tc * jnp.sum(xi2z * y_pair, -1)
    g_b = -2.0 * tc * xi2z
    d_a = 2.0 * tc * xzx2 + 2.0 * tc * jnp.sum(xi3z * y_pair, -1)
    d_b = -2.0 * tc * xi3z
    e_a = -tc * eps_const + 2.0 * tc * jnp.sum(xi4z * y_pair, -1)
    e_b = -2.0 * tc * xi4z
    return (b_a, b_b), (g_a, g_b), (d_a, d_b), (e_a, e_b)


def line_search_polys(y_field, y_pair, omega, v, ell):
    """The four line-search polynomials P_B..P_E (cvo.cpp:249-289) as
    `Poly` objects over the centered fixed-point coordinate x', with
    [M]-vector coefficients.  Shared by the dense-stack form below and
    the moment-contraction epilogue (core/moments.py)."""
    (b_a, b_b), (g_a, g_b), (d_a, d_b), (e_a, e_b) = affine_forms(
        y_field, y_pair, omega, v, ell
    )
    beta = Poly.affine(b_a, b_b)
    gamma = Poly.affine(g_a, g_b)
    delta = Poly.affine(d_a, d_b)
    epsil = Poly.affine(e_a, e_b)
    beta2 = beta * beta
    P_B = beta
    P_C = gamma + 0.5 * beta2
    P_D = delta + beta * gamma + (1.0 / 6.0) * (beta2 * beta)
    P_E = (
        epsil
        + beta * delta
        + 0.5 * (beta2 * gamma)
        + 0.5 * (gamma * gamma)
        + (1.0 / 24.0) * (beta2 * beta2)
    )
    return P_B, P_C, P_D, P_E


def line_search_coeff_stack(y_field, y_pair, omega, v, ell):
    """[M, 140] per-j monomial coefficients of the four line-search
    polynomials P_B..P_E (cvo.cpp:249-289) in the *centered* fixed-point
    coordinate x'.
    """
    (b_a, b_b), (g_a, g_b), (d_a, d_b), (e_a, e_b) = affine_forms(
        y_field, y_pair, omega, v, ell
    )

    beta4 = _affine4(b_a, b_b)
    beta = _dense_affine(b_a, b_b)
    gamma = _dense_affine(g_a, g_b)
    delta = _dense_affine(d_a, d_b)
    epsil = _dense_affine(e_a, e_b)

    beta2 = _mul_affine(beta, beta4)            # deg 2
    beta3 = _mul_affine(beta2, beta4)           # deg 3
    beta4p = _mul_affine(beta3, beta4)          # deg 4
    beta_gamma = _mul_affine(gamma, beta4)      # deg 2
    beta2_gamma = _mul_affine(beta_gamma, beta4)  # deg 3
    gamma2 = _mul_affine(gamma, _affine4(g_a, g_b))  # deg 2
    beta_delta = _mul_affine(delta, beta4)      # deg 2

    P_B = beta
    P_C = gamma + 0.5 * beta2
    P_D = delta + beta_gamma + (1.0 / 6.0) * beta3
    P_E = (
        epsil
        + beta_delta
        + 0.5 * beta2_gamma
        + 0.5 * gamma2
        + (1.0 / 24.0) * beta4p
    )

    return jnp.concatenate([P_B, P_C, P_D, P_E], axis=1)  # [M, 140]


def step_coefficients_factored(A, x_pos, y_pos, omega, v, ell):
    """B, C, D, E matching core.step.step_coefficients, via the
    moment-factored single-matmul reduction."""
    # Center on the A-weighted centroid: every per-pair quantity only
    # involves (x - y), so shifting both clouds is exact — and it keeps
    # |x| at cloud-extent scale, bounding the monomial cancellation
    # error that grows as |x|^4.
    row = jnp.sum(A, axis=1)
    tot = jnp.maximum(jnp.sum(row), 1e-30)
    centroid = jnp.dot(row, x_pos, preferred_element_type=jnp.float32,
                       precision=_HI) / tot
    x_pos = x_pos - centroid

    C_all = line_search_coeff_stack(y_pos, y_pos - centroid, omega, v, ell)
    AC = jnp.dot(A, C_all, preferred_element_type=jnp.float32,
                 precision=_HI)  # [N, 140] — the only big op
    phi = monomial_features(x_pos)  # [N, 35]
    out = jnp.sum(AC.reshape(AC.shape[0], 4, NUM_MONO) * phi[:, None, :],
                  axis=(0, 2))
    return out[0], out[1], out[2], out[3]
