"""Closed-form jittable cubic root solver for the CVO line search.

The reference finds the roots of  4E t^3 + 3D t^2 + 2C t + B  (the
derivative of the quartic line-search objective) with a companion-matrix
eigensolve (cvo.cpp:53-69, 291-307).  A nonsymmetric 3x3 eigensolve is
hostile to jit; the closed form (Cardano + trigonometric method)
is exact, branch-free via `jnp.where`, and vmappable.

fp32 robustness measures (the align loop runs in fp32):
- the variable is rescaled by a Fujiwara-type root bound so the
  depressed cubic works on O(1) numbers regardless of coefficient
  spread;
- every candidate gets two Newton polish steps on the original
  polynomial;
- candidates are *validated by residual* — a borderline discriminant can
  project a complex pair onto the real axis, and the residual test
  rejects those spurious roots (the eigensolver's `imag() == 0` test in
  the reference plays the same role, cvo.cpp:300).

`min_positive_root` reproduces the reference selection semantics:
min positive real root, else `min_step`, clamped to `max_step`
(cvo.cpp:298-307).
"""

from __future__ import annotations

import jax.numpy as jnp

_BIG = jnp.inf


def _eval(a, b, c, d, t):
    return ((a * t + b) * t + c) * t + d


def cubic_roots(a, b, c, d):
    """Real roots of a t^3 + b t^2 + c t + d, degenerate-degree safe.

    Returns (roots [..,3], valid [..,3]); invalid slots hold +inf.
    """
    a, b, c, d = (jnp.asarray(v, jnp.float32) for v in (a, b, c, d))
    coef_scale = jnp.maximum(
        jnp.maximum(jnp.abs(a), jnp.abs(b)),
        jnp.maximum(jnp.abs(c), jnp.abs(d)),
    )
    # degree-degradation threshold: must be far below any coefficient
    # ratio fp32 can represent — a leading coefficient 1e-6 of the
    # others still produces a genuine (huge) third root, and the tau
    # rescale + backward deflation below handle that spread exactly;
    # classifying it as a quadratic silently drops the root.
    # Tradeoff acknowledged: when `a` is pure cancellation noise the
    # huge ~-b/a root is noise too (it can turn a no-positive-root
    # min_step case into max_step) — but that matches the reference,
    # whose companion matrix divides by the leading coefficient
    # unconditionally (cvo.cpp:53-69) and would surface the same root.
    tiny = 1e-12 * jnp.maximum(coef_scale, 1e-30)
    is_cubic = jnp.abs(a) > tiny
    is_quad = ~is_cubic & (jnp.abs(b) > tiny)
    is_lin = ~is_cubic & ~is_quad & (jnp.abs(c) > tiny)

    # --- cubic branch, rescaled: t = tau * u with tau a root bound ---
    a_s = jnp.where(is_cubic, a, 1.0)
    tau = jnp.maximum(
        jnp.maximum(jnp.abs(b / a_s), jnp.sqrt(jnp.abs(c / a_s))),
        jnp.cbrt(jnp.abs(d / a_s)),
    )
    tau = jnp.maximum(tau, 1e-20)
    # monic in u:  u^3 + p u^2 + q u + r
    p = b / (a_s * tau)
    q = c / (a_s * tau * tau)
    r = d / (a_s * tau * tau * tau)
    # depressed: u = s - p/3 ;  s^3 + ps*s + qs
    ps = q - p * p / 3.0
    qs = 2.0 * p**3 / 27.0 - p * q / 3.0 + r
    delta = (qs / 2.0) ** 2 + (ps / 3.0) ** 3

    # one real root (delta > 0)
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    s_single = jnp.cbrt(-qs / 2.0 + sq) + jnp.cbrt(-qs / 2.0 - sq)

    # three real roots (delta <= 0, ps <= 0)
    ps_neg = jnp.minimum(ps, -1e-30)
    m = 2.0 * jnp.sqrt(-ps_neg / 3.0)
    denom = ps_neg * m
    denom = jnp.where(jnp.abs(denom) < 1e-30, -1e-30, denom)
    acos_arg = jnp.clip(3.0 * qs / denom, -1.0, 1.0)
    phi = jnp.arccos(acos_arg)
    k = jnp.arange(3, dtype=jnp.float32)
    s_triple = m * jnp.cos((phi - 2.0 * jnp.pi * k) / 3.0)

    three = delta <= 0
    # one guaranteed-real root: the largest-magnitude one (max |s| in the
    # trig branch), well-conditioned under the tau scaling
    u_triple = s_triple - p[..., None] / 3.0
    u_dom3 = jnp.take_along_axis(
        u_triple, jnp.argmax(jnp.abs(u_triple), axis=-1)[..., None], axis=-1
    )[..., 0]
    t1 = tau * jnp.where(three, u_dom3, s_single - p / 3.0)

    # deflate by (t - t1): remaining pair solves a t^2 + b2 t + c2 in the
    # ORIGINAL scale — this resolves root spreads far beyond fp32's reach
    # of a single scaling (e.g. roots {-1e4, +0.01, -0.01}).  t1 is the
    # dominant root, so use BACKWARD deflation (match constant term
    # first): forward deflation cancels catastrophically when dividing
    # out the largest root.
    t1_s = jnp.where(jnp.abs(t1) < 1e-20, 1.0, t1)
    c2_back = -d / t1_s
    b2_back = (c2_back - c) / t1_s
    b2_fwd = b + a * t1
    c2_fwd = c + t1 * b2_fwd
    use_back = jnp.abs(t1) >= 1e-20
    b2 = jnp.where(use_back, b2_back, b2_fwd)
    c2 = jnp.where(use_back, c2_back, c2_fwd)
    ddisc = b2 * b2 - 4.0 * a_s * c2
    dsq = jnp.sqrt(jnp.maximum(ddisc, 0.0))
    dtmp = -0.5 * (b2 + jnp.sign(b2 + (b2 == 0)) * dsq)
    d1 = dtmp / a_s
    d2r = jnp.where(jnp.abs(dtmp) > 1e-30, c2 / dtmp, 0.0)
    cub_roots = jnp.stack([t1, d1, d2r], axis=-1)
    cub_valid = jnp.stack(
        [
            jnp.ones_like(ddisc, bool),
            ddisc >= 0,
            (ddisc >= 0) & (jnp.abs(dtmp) > 1e-30),
        ],
        axis=-1,
    )

    # --- quadratic branch ---
    b_s = jnp.where(is_quad, b, 1.0)
    qdisc = c * c - 4.0 * b_s * d
    qsq = jnp.sqrt(jnp.maximum(qdisc, 0.0))
    qtmp = -0.5 * (c + jnp.sign(c + (c == 0)) * qsq)
    q1 = qtmp / b_s
    q2 = jnp.where(jnp.abs(qtmp) > 1e-30, d / qtmp, 0.0)
    quad_roots = jnp.stack([q1, q2, jnp.zeros_like(q1)], axis=-1)
    quad_valid = jnp.stack(
        [qdisc >= 0, (qdisc >= 0) & (jnp.abs(qtmp) > 1e-30), jnp.zeros_like(qdisc, bool)],
        axis=-1,
    )

    # --- linear branch ---
    c_s = jnp.where(is_lin, c, 1.0)
    lin_roots = jnp.stack(
        [-d / c_s, jnp.zeros_like(p), jnp.zeros_like(p)], axis=-1
    )
    lin_valid = jnp.stack(
        [jnp.ones_like(qdisc, bool), jnp.zeros_like(qdisc, bool), jnp.zeros_like(qdisc, bool)],
        axis=-1,
    )

    no_valid = jnp.zeros(3, dtype=bool)
    roots = jnp.where(
        is_cubic[..., None],
        cub_roots,
        jnp.where(is_quad[..., None], quad_roots, jnp.where(is_lin[..., None], lin_roots, 0.0)),
    )
    valid = jnp.where(
        is_cubic[..., None],
        cub_valid,
        jnp.where(is_quad[..., None], quad_valid, jnp.where(is_lin[..., None], lin_valid, no_valid)),
    )

    # --- Newton polish (3 steps) + residual validation ---
    ab, bb, cb, db = (v[..., None] for v in (a, b, c, d))

    def polish(t):
        pv = _eval(ab, bb, cb, db, t)
        dp = (3.0 * ab * t + 2.0 * bb) * t + cb
        dp = jnp.where(jnp.abs(dp) < 1e-30, 1e-30, dp)
        return t - pv / dp

    polished = polish(polish(polish(roots)))
    near = jnp.abs(polished - roots) <= 0.25 * (jnp.abs(roots) + 1.0)
    roots = jnp.where(jnp.isfinite(polished) & near, polished, roots)

    # residual test: |p(t)| must be small relative to the term magnitudes
    res = jnp.abs(_eval(ab, bb, cb, db, roots))
    term = jnp.maximum(
        jnp.maximum(jnp.abs(ab * roots**3), jnp.abs(bb * roots**2)),
        jnp.maximum(jnp.abs(cb * roots), jnp.abs(db)),
    )
    valid = valid & (res <= 1e-3 * jnp.maximum(term, 1e-30))
    roots = jnp.where(valid, roots, _BIG)
    return roots, valid


def min_positive_root(roots, valid, min_step, max_step):
    """Reference step selection (cvo.cpp:298-307): min positive real
    root; if none, min_step; clamped to max_step."""
    ok = valid & (roots > 0) & jnp.isfinite(roots)
    candidates = jnp.where(ok, roots, _BIG)
    best = jnp.min(candidates, axis=-1)
    step = jnp.where(jnp.isfinite(best), best, min_step)
    return jnp.minimum(step, max_step)
