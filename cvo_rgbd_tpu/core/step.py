"""Line-search step size — quartic Taylor coefficients, matmul-factored.

The reference re-traverses nnz(A) computing per-pair beta/gamma/delta/
epsilon dot products (cvo.cpp:213-308).  Each of those is affine in
diff_xy = x_i - y_j, so over the dense Gram the [N,M] fields factor as

    w_j . (x_i - y_j)  =  (X @ W^T)_ij - (w_j . y_j)_j

i.e. one [N,3]x[3,M] matmul per derivative order plus per-column
broadcasts.  The polynomial combinations and the A-weighted reduction
are elementwise over the same [N,M] tiles XLA already has in registers
from the Gram computation — the whole thing fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Reduced-precision matmul passes (bf16 passes, or TF32 on a GPU) put a
# ~1e-3 relative noise floor on the distance/reduction contractions,
# which breaks the Gram symmetry cancellations and leaves a mm-level
# pose bias.  All contractions here pin full fp32 precision.
_HI = jax.lax.Precision.HIGHEST

from cvo_rgbd_tpu.core.cubic import cubic_roots, min_positive_root
from cvo_rgbd_tpu.se3 import skew


def step_coefficients(A, x_pos, y_pos, omega, v, ell):
    """B, C, D, E of the quartic objective (cvo.cpp:213-289)."""
    w_hat = skew(omega)
    _mm = lambda a, b: jnp.matmul(a, b, precision=_HI)  # noqa: E731
    w2 = _mm(w_hat, w_hat)
    w3 = _mm(w2, w_hat)
    w4 = _mm(w3, w_hat)

    # per-j derivative fields [M,3] (cvo.cpp:226-238)
    xiz = jnp.cross(jnp.broadcast_to(omega, y_pos.shape), y_pos, axis=-1) + v
    xi2z = jnp.matmul(y_pos, w2.T, precision=_HI) + _mm(w_hat, v[..., None])[..., 0]
    xi3z = jnp.matmul(y_pos, w3.T, precision=_HI) + _mm(w2, v[..., None])[..., 0]
    xi4z = jnp.matmul(y_pos, w4.T, precision=_HI) + _mm(w3, v[..., None])[..., 0]

    normxiz2 = jnp.sum(xiz * xiz, axis=-1)                     # [M]
    xiz_dot_xi2z = -jnp.sum(xiz * xi2z, axis=-1)               # [M]
    epsil_const = jnp.sum(xi2z * xi2z, axis=-1) + 2.0 * jnp.sum(
        xiz * xi3z, axis=-1
    )                                                           # [M]

    def dotfield(w_field):
        """[N,M] matrix of w_j . (x_i - y_j)."""
        s = jnp.dot(x_pos, w_field.T, preferred_element_type=jnp.float32, precision=_HI)
        wy = jnp.sum(w_field * y_pos, axis=-1)
        return s - wy[..., None, :]

    tc = 1.0 / (2.0 * ell * ell)
    beta = -2.0 * tc * dotfield(xiz)
    gamma = -tc * (normxiz2[..., None, :] + 2.0 * dotfield(xi2z))
    delta = 2.0 * tc * (xiz_dot_xi2z[..., None, :] - dotfield(xi3z))
    epsil = -tc * (epsil_const[..., None, :] + 2.0 * dotfield(xi4z))

    beta2 = beta * beta
    bg = beta * gamma
    B = jnp.sum(A * beta)
    C = jnp.sum(A * (gamma + 0.5 * beta2))
    D = jnp.sum(A * (delta + bg + beta2 * beta / 6.0))
    E = jnp.sum(
        A
        * (
            epsil
            + beta * delta
            + 0.5 * beta2 * gamma
            + 0.5 * gamma * gamma
            + beta2 * beta2 / 24.0
        )
    )
    return B, C, D, E


def step_size(A, x_pos, y_pos, omega, v, ell, *, min_step, max_step):
    """Integration step (cvo.cpp:291-307): min positive real root of
    4E t^3 + 3D t^2 + 2C t + B, else min_step, clamped to max_step."""
    B, C, D, E = step_coefficients(A, x_pos, y_pos, omega, v, ell)
    roots, valid = cubic_roots(4.0 * E, 3.0 * D, 2.0 * C, B)
    return min_positive_root(roots, valid, min_step, max_step)
