"""Frozen hyperparameter sets for CVO and Adaptive CVO.

The reference exposes no config system: every hyperparameter is a
constructor-time constant (cvo.cpp:18-48, adaptive_cvo.cpp:18-50).  Here
they are frozen, hashable dataclasses, passed to jitted functions as
static arguments — changing params recompiles, running doesn't.

Defaults reproduce the reference constants exactly:
- CvoParams     <- cvo.cpp:25-41
- AcvoParams    <- adaptive_cvo.cpp:25-43
"""

from __future__ import annotations

import dataclasses


BACKENDS = ("xla", "pallas")


def _check_backend(p):
    if p.backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {p.backend!r}; expected one of {BACKENDS}"
        )


@dataclasses.dataclass(frozen=True)
class CvoParams:
    """Fixed-schedule CVO (cvo.cpp:25-41)."""

    ell_init: float = 0.15      # kernel length-scale (cvo.cpp:25)
    sigma: float = 0.1          # kernel signal std (cvo.cpp:26)
    sp_thres: float = 8e-3      # sparsification threshold (cvo.cpp:27)
    c: float = 7.0              # so(3) inner-product scale (cvo.cpp:28)
    d: float = 7.0              # R^3 inner-product scale (cvo.cpp:29)
    color_scale: float = 1e-5   # linear color-kernel scale (cvo.cpp:30)
    c_ell: float = 200.0        # color kernel length-scale (cvo.cpp:31)
    c_sigma: float = 1.0        # color kernel signal std (cvo.cpp:32)
    max_iter: int = 2000        # (cvo.cpp:38)
    min_step: float = 0.2       # (cvo.cpp:39)
    max_step: float = 0.8       # step clamp (cvo.cpp:307)
    # The C++ shipped stops, reachable in fp32 (the difference-form
    # flow epilogues + precise exp + pinned SE(3) matmuls; PERF.md
    # "Numerics that the C++ stops need"): reference-scale pairs
    # converge in about as many iterations as the float64 oracle.  The
    # MATLAB set (5e-4/1e-4, MATLAB_PARAMS below) about halves
    # iteration counts at a ~1 mm pose delta — use it when wall time
    # matters.
    eps: float = 5e-5           # flow-norm stop (cvo.cpp:40)
    eps_2: float = 1e-5         # se3-distance stop (cvo.cpp:41)
    # ell schedule: k>2 -> 0.10, k>9 -> 0.06, k>19 -> 0.03 (cvo.cpp:408-410)
    ell_sched: tuple = ((2, 0.10), (9, 0.06), (19, 0.03))
    # color mode: "se" = squared-exponential on 5-dim features, re-gated
    # each iteration (cvo.cpp:143-153); "linear" = MATLAB's linear color
    # inner product, precomputed once (rkhs_se3_registration.m:40-53).
    color_mode: str = "se"
    # compute backend for the inner loop: "xla" (dense masked Gram in
    # device memory) or "pallas" (the single-sweep moment kernel,
    # ops/moment_kernel.py: the Gram is never materialized).
    backend: str = "xla"
    # line-search reduction: "factored" = moment-factored single matmul
    # (no [N,M] intermediates, centered for fp32 stability); "direct" =
    # literal per-pair field evaluation (cvo.cpp:249-289).
    step_mode: str = "factored"
    # Gram exponential: "precise" = libm-grade exp_neg
    # (core/numerics.py; needed for the C++ shipped stops 5e-5/1e-5
    # where the hardware exp is approximate enough to jitter the
    # sparsity gates; whether the H100 needs it is ROADMAP S6);
    # "fast" = hardware exp, which converges at the MATLAB stops.
    exp_mode: str = "precise"
    # pallas backend only: EXACT tile-level sparsity skipping — per-tile
    # AABB lower bounds prune tile pairs wholly outside the position
    # gate radius (the kd-tree radius pruning of cvo.cpp:119-125 at
    # tile granularity; skipped tiles contribute exactly 0).  At
    # converged length-scales most tiles of a room-scale cloud skip.
    tile_skip: bool = True

    def __post_init__(self):
        _check_backend(self)

    @property
    def c_sp_thres(self) -> float:
        # cvo uses sp_thres for the color gate too (cvo.cpp:103)
        return self.sp_thres


@dataclasses.dataclass(frozen=True)
class AcvoParams:
    """Adaptive CVO (adaptive_cvo.cpp:25-43)."""

    ell_init: float = 0.1       # (adaptive_cvo.cpp:25)
    ell_min: float = 0.0391     # (adaptive_cvo.cpp:27)
    ell_max_init: float = 0.15  # reset per pair (adaptive_cvo.cpp:28, 477)
    dl_step: float = 0.3        # (adaptive_cvo.cpp:30)
    sigma: float = 0.1          # (adaptive_cvo.cpp:33)
    sp_thres: float = 8.315e-3  # (adaptive_cvo.cpp:34)
    c: float = 7.0              # (adaptive_cvo.cpp:35)
    d: float = 7.0              # (adaptive_cvo.cpp:36)
    c_ell: float = 0.5          # HSV-scale color length (adaptive_cvo.cpp:37)
    c_sigma: float = 1.0        # (adaptive_cvo.cpp:38)
    c_sp_thres: float = 8.315e-3  # separate color gate (adaptive_cvo.cpp:39)
    max_iter: int = 2000        # (adaptive_cvo.cpp:40)
    min_step: float = 0.2       # (adaptive_cvo.cpp:41)
    max_step: float = 0.8       # (adaptive_cvo.cpp:369)
    eps: float = 5e-5           # (adaptive_cvo.cpp:42)
    eps_2: float = 1e-5         # (adaptive_cvo.cpp:43)
    ell_shrink: float = 0.7     # ceiling shrink factor (adaptive_cvo.cpp:542-543)
    color_mode: str = "se"
    # Reference quirk (adaptive_cvo.cpp:190, 256; SURVEY.md section 3.2):
    # Ayy rows i < num_fixed read a zero-initialized |diff_yy|^2 buffer, so
    # they never contribute to the dl numerator.  False = correct math,
    # True = bit-faithful emulation.
    #
    # Parity experiment (fr1/desk fixture pairs, round 1): with the
    # quirk, dl loses Ayy's positive term and goes systematically
    # negative, so ell collapses to the ell_min floor (0.0391) within a
    # few iterations; correct math keeps ell adapting around 0.11-0.13.
    # Both converge, translations agree to a few mm.  Correct math is
    # the default; the quirk stays available for bit-level comparisons
    # against the reference binaries.
    yy_quirk: bool = False
    backend: str = "xla"  # "xla" | "pallas" (yy_quirk needs "xla")
    step_mode: str = "factored"  # see CvoParams.step_mode
    exp_mode: str = "precise"  # see CvoParams.exp_mode
    tile_skip: bool = True  # see CvoParams.tile_skip
    # pallas backend only: how the Axx/Ayy self-kernel reductions that
    # feed dl (adaptive_cvo.cpp:222-271) are evaluated per iteration.
    # "exact" (default) sweeps both self-kernels every iteration.
    # "cheb": the four reduction values are functions of ell ALONE
    # (self-distances are rigid-invariant), so they are tabulated ONCE
    # per align at Chebyshev nodes in log(1/2ell^2) and interpolated
    # per iteration — removes both per-iteration self sweeps (about
    # the whole acvo-over-cvo cost) at a ~0.4% value error that heavy
    # cancellation in dl's numerator amplifies to a few percent of dl.
    # The perturbed ell trajectory costs ~15% more iterations and
    # shifts the converged pose at the C++ stops by sub-mm typically,
    # 2.7 mm worst-case across 8 reference-scale probe pairs.  Keep
    # "exact" (default) when dl parity or worst-case pose fidelity
    # matters; "cheb" is the throughput configuration.
    self_mode: str = "exact"
    self_cheb_k: int = 12  # Chebyshev node count for self_mode="cheb"

    def __post_init__(self):
        _check_backend(self)
        if self.backend == "pallas" and (
            self.yy_quirk or self.color_mode == "linear"
        ):
            raise ValueError(
                "the pallas backend runs acvo in se color mode without "
                "yy_quirk; use backend='xla'"
            )


# MATLAB prototype parameter set (rkhs_se3_registration.m:7-36): linear
# color kernel precomputed once, looser tolerances.  The MATLAB schedule
# (1-based k > 3/10/20, rkhs_se3_registration.m:242-250) is the same as
# the C++ one (0-based k > 2/9/19, cvo.cpp:408-410).
MATLAB_PARAMS = CvoParams(
    sp_thres=1e-3,
    eps=5e-4,
    eps_2=1e-4,
    color_mode="linear",
)
