"""cvo_rgbd_tpu — accelerator-native Continuous Visual Odometry for RGB-D.

A from-scratch JAX/XLA/Pallas re-design of MaaniGhaffari/cvo-rgbd:
correspondence-free RGB-D registration by maximizing an RKHS inner
product via gradient flow on SE(3).  See SURVEY.md at the repo root
for the reference layer map this framework mirrors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cvo_rgbd_tpu.core import AlignResult, PointCloud, align, pad_cloud
from cvo_rgbd_tpu.core.registration import function_inner_product
from cvo_rgbd_tpu.params import MATLAB_PARAMS, AcvoParams, CvoParams

__all__ = [
    "AlignResult",
    "PointCloud",
    "align",
    "align_jit",
    "pad_cloud",
    "function_inner_product",
    "CvoParams",
    "AcvoParams",
    "MATLAB_PARAMS",
]

__version__ = "0.1.0"


@functools.lru_cache(maxsize=None)
def _compiled_align(params):
    return jax.jit(functools.partial(align, params))


def align_jit(params, fixed, moving, R0=None, T0=None,
              ell0=None) -> AlignResult:
    """jitted `align`; compiled once per (params, cloud capacity).

    `R0`/`T0`/`ell0` warm-start the align state (the reference's
    across-pair R/T/ell persistence — see core.registration.align)."""
    fn = _compiled_align(params)
    if R0 is None and T0 is None and ell0 is None:
        return fn(fixed, moving)
    R0 = jnp.eye(3, dtype=jnp.float32) if R0 is None else R0
    T0 = jnp.zeros(3, dtype=jnp.float32) if T0 is None else T0
    ell0 = jnp.asarray(params.ell_init, jnp.float32) if ell0 is None else ell0
    return fn(fixed, moving, R0, T0, ell0)
