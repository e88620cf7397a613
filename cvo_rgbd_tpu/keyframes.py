"""Keyframe selection + keyframe-referenced odometry.

The reference defines `function_inner_product` (adaptive_cvo.cpp:
385-439) as a keyframe-selection hook but never wires it into the
shipped mains (SURVEY.md section 3.2).  This module completes the
feature: the normalized cross inner product

    score(a, b) = <f_a, f_b> / sqrt(<f_a, f_a> <f_b, f_b>)

measures overlap between a keyframe and the current frame; when it
drops below `threshold`, the current frame is promoted.  Registering
every frame against the keyframe (rather than the previous frame)
removes per-frame drift accumulation between promotions.

Self inner products <f,f> are rigid-invariant per cloud, so they are
computed once and cached (`self_inner_product`) instead of re-derived
on every score call; loop-closure search scores one frame against K
candidate keyframes in a single batched device call
(`keyframe_scores_batched`, padded to a power-of-two K to bound
recompiles).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from cvo_rgbd_tpu.core.cloud import transform_cloud
from cvo_rgbd_tpu.core.registration import function_inner_product


@functools.lru_cache(maxsize=None)
def _compiled_fip(params):
    return jax.jit(functools.partial(function_inner_product, params))


@functools.lru_cache(maxsize=None)
def _compiled_fip_batched(params):
    """fip of ONE cloud against a stacked batch of candidate clouds."""

    def cross(cands, cloud):
        return jax.vmap(
            lambda c: function_inner_product(params, c, cloud)
        )(cands)

    return jax.jit(cross)


@functools.lru_cache(maxsize=None)
def _compiled_aligned_fip(params):
    """fip of cloud_a against cloud_b TRANSFORMED by each of K
    candidate SE(3)s — the post-align quality of K registrations of the
    same pair in one device call."""

    def fip_at(ca, cb, tfs):
        def one(tf):
            pos = transform_cloud(tf[:3, :3], tf[:3, 3], cb.positions)
            return function_inner_product(
                params, ca, cb._replace(positions=pos)
            )

        return jax.vmap(one)(tfs)

    return jax.jit(fip_at)


def aligned_fip(params, cloud_a, cloud_b, tfs):
    """Inner product of `cloud_a` vs `cloud_b` moved by each transform.

    `tfs`: [K,4,4] array or sequence of [4,4] (stacked on device — pass
    align results' .tf directly to keep the dispatch pipeline async).
    Returns a device array [K]; the registration flow maximizes exactly
    this quantity, so it ranks competing registrations of one pair."""
    if isinstance(tfs, (list, tuple)):
        tfs = jnp.stack(tfs)
    return _compiled_aligned_fip(params)(cloud_a, cloud_b, tfs)


def self_inner_product(params, cloud):
    """<f,f> of one cloud — rigid-invariant, cache per keyframe."""
    return float(_compiled_fip(params)(cloud, cloud))


def inner_product_async(params, cloud_a, cloud_b):
    """<f_a, f_b> as a DEVICE scalar (no blocking fetch).

    Callers that need several per-frame quantities (align result, self
    product, cross score) should dispatch them all and fetch together —
    each separate blocking fetch waits on the device."""
    return _compiled_fip(params)(cloud_a, cloud_b)


def keyframe_score(params, key_cloud, cloud, key_self=None, cloud_self=None):
    """Normalized function inner product in [0, ~1].

    `key_self` / `cloud_self` are optional precomputed self inner
    products (see `self_inner_product`) — passing them skips two of the
    three Gram evaluations.
    """
    fip = _compiled_fip(params)
    cross = fip(key_cloud, cloud)
    aa = fip(key_cloud, key_cloud) if key_self is None else key_self
    bb = fip(cloud, cloud) if cloud_self is None else cloud_self
    return float(cross / np.sqrt(float(aa) * float(bb) + 1e-30))


def keyframe_scores_batched(params, cand_clouds, cloud, cand_selfs,
                            cloud_self, min_pad=32):
    """Score `cloud` against K candidate clouds in one device call.

    cand_clouds: list[PointCloud] (same capacity); cand_selfs: list of
    their cached self inner products.  Returns np.ndarray [K] of
    normalized scores.  The batch is padded to the next power of two,
    floored at `min_pad`, so the compiled kernel is reused across
    growing keyframe sets — the floor keeps the compile count at
    log2(K_max/min_pad)+1 (each recompile of the vmapped Gram costs
    seconds, while the padded lanes' extra device work is small);
    padded lanes are all-masked clouds (score 0).
    """
    from cvo_rgbd_tpu.core.cloud import stack_clouds

    k = len(cand_clouds)
    if k == 0:
        return np.zeros((0,), np.float32)
    pad = min_pad
    while pad < k:
        pad *= 2
    if pad > k:
        empty = jax.tree_util.tree_map(jnp.zeros_like, cand_clouds[0])
        cand_clouds = list(cand_clouds) + [empty] * (pad - k)
    batch = stack_clouds(cand_clouds)
    cross = np.asarray(_compiled_fip_batched(params)(batch, cloud))[:k]
    selfs = np.asarray(cand_selfs, np.float64)
    return (cross / np.sqrt(selfs * float(cloud_self) + 1e-30)).astype(
        np.float32
    )


@dataclasses.dataclass
class KeyframePolicy:
    threshold: float = 0.6    # promote when overlap drops below this
    max_span: int = 30        # force promotion after this many frames


class KeyframeSelector:
    """Tracks the active keyframe; call `update` once per frame."""

    def __init__(self, params, policy: KeyframePolicy | None = None):
        self.params = params
        self.policy = policy or KeyframePolicy()
        self.key_cloud = None
        self.key_self = None      # cached <f,f> of the active keyframe
        self.key_index = -1
        self.frames_since = 0

    def update(self, index, cloud, cloud_self=None):
        """Returns (is_new_keyframe, score).

        `cloud_self`: optional precomputed <f,f> of `cloud` (callers
        that also score `cloud` elsewhere should compute it once and
        share it).
        """
        if cloud_self is None:
            cloud_self = self_inner_product(self.params, cloud)
        if self.key_cloud is None:
            self._promote(index, cloud, cloud_self)
            return True, 1.0
        score = keyframe_score(
            self.params, self.key_cloud, cloud,
            key_self=self.key_self, cloud_self=cloud_self,
        )
        return self.update_scored(index, cloud, cloud_self, score)

    def update_scored(self, index, cloud, cloud_self, score):
        """`update` with the normalized overlap score already in hand.

        For callers that batch their per-frame device fetches (slam):
        they dispatch the cross inner product (`inner_product_async`)
        alongside the align and fetch everything in one transfer, then
        apply the promotion policy here without further device work.
        Must not be called for the very first frame (no active
        keyframe).
        """
        self.frames_since += 1
        if (
            score < self.policy.threshold
            or self.frames_since >= self.policy.max_span
        ):
            self._promote(index, cloud, cloud_self)
            return True, score
        return False, score

    def tick(self):
        """Advance the frame counter WITHOUT scoring — for callers that
        process a frame but must skip the promotion check (e.g. a
        batched-decision driver whose in-group scores went stale after
        a mid-group promotion).  Keeps max_span promotion cadence
        frame-accurate."""
        self.frames_since += 1

    def _promote(self, index, cloud, cloud_self):
        self.key_cloud = cloud
        self.key_self = cloud_self
        self.key_index = index
        self.frames_since = 0
