"""Lie-group math for SO(3)/SE(3)/SE_K(3) — jittable, vmap-safe, fp32-first.

Re-design of the reference Lie group library
(reference: cpp/rkhs_registration/src/LieGroup.cpp:20-199).  Differences
from the reference are deliberate:

- every function is a pure jnp program with `jnp.where` small-angle
  branches instead of `if (theta < TOLERANCE)` (LieGroup.cpp:18, 52, 168),
  so everything is traceable, batchable (vmap) and differentiable;
- `dist_se3` uses the closed-form SE(3) log (2*|w|^2 + |u|^2 under the
  Frobenius norm) instead of Eigen's generic dense `MatrixBase::log()`
  (cvo.cpp:71-81), which would be a nonsymmetric eigendecomposition and
  is hostile to jit;
- small-angle limits use second-order Taylor series so gradients stay
  finite (the reference just snaps to identity).

One reference quirk is reproduced on purpose: `exp_sek3(v, dt)` with
`theta < TOLERANCE` uses `Jl = I` (not `dt*I`; LieGroup.cpp:168-170), so
a pure-translation flow integrates with an implicit unit step.  Trajectory
parity with the reference binaries is the acceptance metric, so we match
behavior; see `exp_sek3`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# EVERY matmul in the SE(3) algebra is precision-pinned: a reduced-
# precision default (bf16 passes, or TF32 on a GPU) makes the R @ dR update chain rough enough to stall the
# align loop's contraction at reference scale in a |flow| ~ 3e-4 limit
# cycle, above the reference's eps=5e-5 stop.  See PERF.md,
# "Numerics that the C++ stops need".
import functools as _functools

_mm = _functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


# Small-angle guard, matches reference TOLERANCE (LieGroup.cpp:18).
TOLERANCE = 1e-6


def skew(v):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix (LieGroup.cpp:20-27)."""
    v = jnp.asarray(v)
    z = jnp.zeros_like(v[..., 0])
    rows = [
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def unskew(m):
    """[..., 3, 3] -> [..., 3] (LieGroup.cpp:29-33)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _theta(w):
    return jnp.linalg.norm(w, axis=-1)


def _safe_theta(w):
    """(theta, theta^2, small) with NaN-free gradients at w == 0.

    `jnp.linalg.norm` has a 0/0 gradient at the origin; computing
    sqrt on a guarded sum-of-squares keeps the whole small-angle branch
    differentiable (the Taylor branches below only consume theta^2,
    whose gradient at 0 is exactly 0).
    """
    th2 = jnp.sum(w * w, axis=-1)
    small = th2 < TOLERANCE * TOLERANCE
    th_s = jnp.sqrt(jnp.where(small, jnp.ones_like(th2), th2))
    return th_s, th2, small


def _safe(x, small):
    """Replace near-zero denominators by 1 so the other `where` branch
    never sees a NaN (keeps grads finite)."""
    return jnp.where(small, jnp.ones_like(x), x)


def exp_so3(w):
    """Rodrigues formula, [...,3] -> [...,3,3] (LieGroup.cpp:148-157)."""
    w = jnp.asarray(w)
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = _mm(A, A)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), A.shape)
    s = jnp.sin(th_s) / th_s
    c = (1.0 - jnp.cos(th_s)) / (th_s * th_s)
    # Taylor: sin(t)/t -> 1 - t^2/6 ; (1-cos t)/t^2 -> 1/2 - t^2/24
    s = jnp.where(small, 1.0 - th2 / 6.0, s)
    c = jnp.where(small, 0.5 - th2 / 24.0, c)
    return eye + s[..., None, None] * A + c[..., None, None] * A2


def left_jacobian_so3(w):
    """SO(3) left Jacobian (LieGroup.cpp:49-59)."""
    w = jnp.asarray(w)
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = _mm(A, A)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), A.shape)
    a = (1.0 - jnp.cos(th_s)) / (th_s * th_s)
    b = (th_s - jnp.sin(th_s)) / (th_s**3)
    a = jnp.where(small, 0.5 - th2 / 24.0, a)
    b = jnp.where(small, 1.0 / 6.0 - th2 / 120.0, b)
    return eye + a[..., None, None] * A + b[..., None, None] * A2


def left_jacobian_inv_so3(w):
    """Inverse SO(3) left Jacobian (LieGroup.cpp:61-69)."""
    w = jnp.asarray(w)
    th_s, th2, small = _safe_theta(w)
    A = skew(w)
    A2 = _mm(A, A)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), A.shape)
    # 1/t^2 - (1+cos t)/(2 t sin t); Taylor -> 1/12 + t^2/720
    c = 1.0 / (th_s * th_s) - (1.0 + jnp.cos(th_s)) / (
        2.0 * th_s * jnp.sin(th_s)
    )
    c = jnp.where(small, 1.0 / 12.0 + th2 / 720.0, c)
    return eye - 0.5 * A + c[..., None, None] * A2


def log_so3(R):
    """SO(3) log, [...,3,3] -> [...,3] (LieGroup.cpp:120-126)."""
    R = jnp.asarray(R)
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos_th = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    th = jnp.arccos(cos_th)
    small = th < TOLERANCE
    th_s = _safe(th, small)
    # th / (2 sin th); Taylor -> 1/2 + th^2/12
    f = th_s / (2.0 * jnp.sin(th_s))
    f = jnp.where(small, 0.5 + th * th / 12.0, f)
    m = R - jnp.swapaxes(R, -1, -2)
    return f[..., None] * unskew(m)


def exp_se3(xi):
    """se(3) exp, [...,6] (w first, u second) -> [...,4,4] (LieGroup.cpp:139-146)."""
    xi = jnp.asarray(xi)
    w, u = xi[..., :3], xi[..., 3:]
    R = exp_so3(w)
    t = (_mm(left_jacobian_so3(w), u[..., None]))[..., 0]
    return make_se3(R, t)


def log_se3(X):
    """SE(3) log, [...,4,4] -> [...,6] (LieGroup.cpp:128-136)."""
    X = jnp.asarray(X)
    w = log_so3(X[..., :3, :3])
    u = (_mm(left_jacobian_inv_so3(w), X[..., :3, 3:4]))[..., 0]
    return jnp.concatenate([w, u], axis=-1)


def make_se3(R, t):
    """Assemble [...,4,4] from [...,3,3] and [...,3]."""
    R = jnp.asarray(R)
    t = jnp.asarray(t)
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bot = jnp.zeros(batch + (1, 4), dtype=R.dtype)
    bot = bot.at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bot], axis=-2)


def se3_inv(R, t):
    """[R', -R't] — the reference's `update_tf` (cvo.cpp:83-87)."""
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(_mm(Rt, t[..., None]))[..., 0]


def exp_sek3(omega, v, dt):
    """Scaled SE(3) exponential — the flow integrator (LieGroup.cpp:159-186).

    Returns (dR, dT) with dR = exp(dt * skew(omega)) and
    dT = Jl(dt, omega) @ v.

    Reference quirk reproduced: for |omega| < TOLERANCE the reference
    sets Jl = I — NOT the correct limit dt*I (LieGroup.cpp:168-170) — so
    near-zero rotational flow integrates translation with a unit step.
    We replicate for trajectory parity.
    """
    omega = jnp.asarray(omega)
    v = jnp.asarray(v)
    th_s, th2_raw, small = _safe_theta(omega)
    A = skew(omega)
    A2 = _mm(A, A)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), A.shape)
    th2 = th_s * th_s
    st = jnp.sin(dt * th_s)
    ct = jnp.cos(dt * th_s)
    one_m_ct = (1.0 - ct) / th2
    R = eye + (st / th_s)[..., None, None] * A + one_m_ct[..., None, None] * A2
    Jl = (
        dt * eye
        + one_m_ct[..., None, None] * A
        + ((dt * th_s - st) / (th2 * th_s))[..., None, None] * A2
    )
    R = jnp.where(small[..., None, None], eye, R)
    Jl = jnp.where(small[..., None, None], eye, Jl)  # reference quirk (see docstring)
    dT = (_mm(Jl, v[..., None]))[..., 0]
    return R, dT


def dist_se3(R, t):
    """Frobenius norm of the SE(3) matrix log (cvo.cpp:71-81).

    || log [R t; 0 1] ||_F = sqrt(2 |w|^2 + |u|^2) with w = log_so3(R),
    u = Jl^{-1}(w) t — closed form replacing Eigen's generic `.log()`.
    """
    w = log_so3(R)
    u = (_mm(left_jacobian_inv_so3(w), jnp.asarray(t)[..., None]))[..., 0]
    return jnp.sqrt(
        2.0 * jnp.sum(w * w, axis=-1) + jnp.sum(u * u, axis=-1)
    )


def adjoint_se3(X):
    """SE(3) adjoint, [...,4,4] -> [...,6,6] (LieGroup.cpp:188-199, K=1)."""
    X = jnp.asarray(X)
    R = X[..., :3, :3]
    p = X[..., :3, 3]
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, z], axis=-1)
    bot = jnp.concatenate([_mm(skew(p), R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def left_jacobian_se3(xi):
    """SE(3) left Jacobian, [...,6] -> [...,6,6] (LieGroup.cpp:71-101)."""
    xi = jnp.asarray(xi)
    Phi, Rho = xi[..., :3], xi[..., 3:]
    phi_s, _, small = _safe_theta(Phi)
    Px = skew(Phi)
    Rx = skew(Rho)
    J = left_jacobian_so3(Phi)
    phi2 = phi_s * phi_s
    phi3 = phi2 * phi_s
    phi4 = phi3 * phi_s
    phi5 = phi4 * phi_s
    sp = jnp.sin(phi_s)
    cp = jnp.cos(phi_s)
    c1 = (phi_s - sp) / phi3
    c2 = (1.0 - 0.5 * phi2 - cp) / phi4
    c3 = 0.5 * (c2 - 3.0 * (phi_s - sp - phi3 / 6.0) / phi5)
    # Taylor limits
    c1 = jnp.where(small, 1.0 / 6.0, c1)
    c2 = jnp.where(small, 1.0 / 24.0, c2)
    c3 = jnp.where(small, 1.0 / 120.0, c3)

    def b(c):
        return c[..., None, None]

    Q = (
        0.5 * Rx
        + b(c1) * (_mm(Px, Rx) + _mm(Rx, Px) + _mm(Px, _mm(Rx, Px)))
        - b(c2) * (_mm(Px, _mm(Px, Rx)) + _mm(Rx, _mm(Px, Px)) - 3.0 * _mm(Px, _mm(Rx, Px)))
        - b(c3) * (_mm(Px, _mm(Rx, _mm(Px, Px))) + _mm(Px, _mm(Px, _mm(Rx, Px))))
    )
    Q = jnp.where(small[..., None, None], 0.5 * Rx, Q)
    z = jnp.zeros_like(J)
    # Correct block layout for [w; u] ordering: rotation rows do not
    # depend on the translation perturbation, so Q sits bottom-left:
    # [[J, 0], [Q, J]].  The reference places Q top-right
    # (LieGroup.cpp:96-98), which assumes [rho; phi] ordering while its
    # own exp/log use [w; u] — the function is never called by the
    # registration, so we ship the consistent version.
    top = jnp.concatenate([J, z], axis=-1)
    bot = jnp.concatenate([Q, J], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
