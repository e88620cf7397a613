"""Semi-dense pixel selection — stateless, jittable DSO redesign.

The reference vendors DSO's PixelSelector (PixelSelector2.cpp:71-433):
per-32x32-block gradient-histogram thresholds, a 3-scale blocked argmax
with per-level down-weighting, a *stateful* recursion that adapts the
block "potential" across frames to hit `num_want`, and a fixed-seed
random subsample.  That design is hostile to jit (recursion, RNG state,
data-dependent counts), so this module re-derives it for XLA:

- the histogram-quantile threshold map is computed exactly as DSO does
  (quantile 0.5 of clipped sqrt-gradients per 32x32 block, +7,
  3x3-neighbor mean, squared — PixelSelector2.cpp:71-136);
- selection is a 3-scale blocked argmax (pot / 2pot / 4pot blocks with
  thresholds down-weighted by 0.75 per level, PixelSelector2.h:30,
  PixelSelector2.cpp:334-429) where each scale's winners get a
  priority tier;
- the stateful potential-recursion + random subsample
  (PixelSelector2.cpp:193-244) is replaced by a deterministic global
  top-k over (tier, gradient) scores, which hits exactly `num_want`
  candidates by construction;
- the Canny top-up fallback (pcd_generator.cpp:135-163) is replaced by
  a gated, block-distributed gradient refill with the reference's exact
  semantics: it fires ONLY when the tier selection yields fewer than
  num_want/3 pixels (pcd_generator.cpp:135), and contributes at most
  one pixel per 8x8 block (the reference adds one Canny-edge pixel per
  8x8 block, pcd_generator.cpp:138,144-161), ranked by gradient.  On
  adequately textured scenes the cloud therefore carries exactly the
  tier winners (possibly fewer than num_want, like DSO), and
  weak-texture pixels never pad it out.

Output is a fixed-size [num_want] index array + validity mask: bit
parity with DSO masks is a non-goal, trajectory parity is (SURVEY.md
section 7 step 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIST_BLOCK = 32          # PixelSelector2.cpp:79-80
HIST_CUT = 0.5           # setting_minGradHistCut (PixelSelector2.h:32)
HIST_ADD = 7.0           # setting_minGradHistAdd (PixelSelector2.h:33)
DOWNWEIGHT = 0.75        # setting_gradDownweightPerLevel (PixelSelector2.h:30)
NUM_BINS = 49            # sqrt-gradient clipped to 48 (PixelSelector2.cpp:96-98)


def _block_threshold_map(abs_sq_grad):
    """Per-pixel smoothed threshold, DSO makeHists
    (PixelSelector2.cpp:71-136).  Returns [H,W] of squared thresholds."""
    h, w = abs_sq_grad.shape
    h32, w32 = h // HIST_BLOCK, w // HIST_BLOCK
    hc, wc = h32 * HIST_BLOCK, w32 * HIST_BLOCK

    g = jnp.sqrt(jnp.maximum(abs_sq_grad[:hc, :wc], 0.0))
    g = jnp.minimum(jnp.floor(g), 48.0)

    # DSO skips pixels within 1 px of the full-image border
    # (PixelSelector2.cpp:95)
    ys = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
    valid = (xs >= 1) & (xs <= w - 2) & (ys >= 1) & (ys <= h - 2)

    blocks = g.reshape(h32, HIST_BLOCK, w32, HIST_BLOCK)
    vblocks = valid.reshape(h32, HIST_BLOCK, w32, HIST_BLOCK)

    # per-block histogram over NUM_BINS integer bins via one-hot
    onehot = (
        blocks[..., None] == jnp.arange(NUM_BINS, dtype=g.dtype)
    ) & vblocks[..., None]
    hist = jnp.sum(onehot, axis=(1, 3))            # [h32, w32, BINS]
    total = jnp.sum(hist, axis=-1)                 # [h32, w32]

    # computeHistQuantil (PixelSelector2.cpp:59-68): min i with
    # cumsum_i > floor(N*cut + 0.5); empty blocks get 90
    th0 = jnp.floor(total * HIST_CUT + 0.5)
    cum = jnp.cumsum(hist, axis=-1)
    exceeded = cum > th0[..., None]
    idx = jnp.argmax(exceeded, axis=-1)
    quant = jnp.where(jnp.any(exceeded, axis=-1), idx, 90)
    ths = quant.astype(jnp.float32) + HIST_ADD

    # 3x3 neighbor mean then square (PixelSelector2.cpp:107-131)
    pad = jnp.pad(ths, 1, mode="constant")
    cnt = jnp.pad(jnp.ones_like(ths), 1, mode="constant")
    sm = sum(
        pad[1 + dy : 1 + dy + h32, 1 + dx : 1 + dx + w32]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    )
    n = sum(
        cnt[1 + dy : 1 + dy + h32, 1 + dx : 1 + dx + w32]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    )
    ths_sm = (sm / n) ** 2

    # broadcast back to pixels; pixels beyond the 32-divisible crop get
    # an infinite threshold (DSO never selects there either)
    per_pix = jnp.repeat(jnp.repeat(ths_sm, HIST_BLOCK, axis=0), HIST_BLOCK, axis=1)
    full = jnp.full((h, w), jnp.inf, dtype=jnp.float32)
    return full.at[:hc, :wc].set(per_pix)


def _blockwise_argmax(score, block):
    """[H,W] -> per-block (flat_idx, value) for block x block tiles.

    H, W must be padded to multiples of `block` by the caller.
    """
    h, w = score.shape
    hb, wb = h // block, w // block
    tiles = score.reshape(hb, block, wb, block).transpose(0, 2, 1, 3).reshape(hb, wb, block * block)
    best = jnp.argmax(tiles, axis=-1)
    val = jnp.take_along_axis(tiles, best[..., None], axis=-1)[..., 0]
    by, bx = best // block, best % block
    ys = jax.lax.broadcasted_iota(jnp.int32, (hb, wb), 0) * block + by
    xs = jax.lax.broadcasted_iota(jnp.int32, (hb, wb), 1) * block + bx
    return ys * w + xs, val


def select_pixels(pyramid, num_want, pot=3):
    """Select ~num_want semi-dense pixels.  Returns (idx [num_want],
    valid [num_want]) into the flattened level-0 image.

    pyramid: output of image.make_pyramid (3 levels of
    (intensity, dx, dy, abs_sq_grad)).
    """
    asg0 = pyramid[0][3]
    asg1 = pyramid[1][3]
    asg2 = pyramid[2][3]
    h, w = asg0.shape

    ths = _block_threshold_map(asg0)

    # in-border test (PixelSelector2.cpp:364): 4 <= x < w-5, 4 <= y <= h-4
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inb = (xs >= 4) & (xs < w - 5) & (ys >= 4) & (ys <= h - 4)

    # upsample coarse gradient maps to level-0 coordinates, using DSO's
    # index mapping (PixelSelector2.cpp:384, 396)
    x1 = (xs // 2).clip(0, asg1.shape[1] - 1)
    y1 = (ys // 2).clip(0, asg1.shape[0] - 1)
    ag1 = asg1[y1, x1]
    x2 = (xs // 4).clip(0, asg2.shape[1] - 1)
    y2 = (ys // 4).clip(0, asg2.shape[0] - 1)
    ag2 = asg2[y2, x2]

    neg = jnp.float32(-jnp.inf)
    pass0 = inb & (asg0 > ths)
    pass1 = inb & (ag1 > ths * DOWNWEIGHT)
    pass2 = inb & (ag2 > ths * DOWNWEIGHT * DOWNWEIGHT)

    def pad_to(a, blk, fill):
        hp = -(-h // blk) * blk
        wp = -(-w // blk) * blk
        return jnp.pad(a, ((0, hp - h), (0, wp - w)), constant_values=fill)

    score = jnp.zeros((h * w,), jnp.float32)

    # Tier scores: lvl0 winners highest, then lvl1, lvl2 (codes 1/2/4 in
    # DSO, PixelSelector2.cpp:408-428).  Within a tier, rank by the
    # squashed gradient val/(val+1) in [0,1) — an fp32-safe composite
    # key (tier_base + fraction) that preserves gradient ordering.
    def squash(v):
        return v / (v + 1.0)

    tiers = [
        (jnp.where(pass0, asg0, neg), pot, 3.0),
        (jnp.where(pass1, ag1, neg), 2 * pot, 2.0),
        (jnp.where(pass2, ag2, neg), 4 * pot, 1.0),
    ]
    for s, blk, base in tiers:
        sp = pad_to(s, blk, neg)
        hp, wp = sp.shape
        idx_p, val = _blockwise_argmax(sp, blk)
        yy, xx = idx_p // wp, idx_p % wp
        ok = jnp.isfinite(val) & (yy < h) & (xx < w)
        flat = (yy * w + xx).reshape(-1)
        contrib = jnp.where(ok.reshape(-1), base + squash(val.reshape(-1)), 0.0)
        score = score.at[flat].max(contrib)

    # refill tier in (0, 1) — the Canny-top-up analog with the
    # reference's gate and distribution (pcd_generator.cpp:135-163):
    # fires only when the tier selection found fewer than num_want/3
    # pixels, and contributes at most ONE pixel per 8x8 block (the
    # reference scans each 8x8 block for its first Canny-edge pixel),
    # here the block's strongest in-border gradient.
    n_tier = jnp.sum(score >= 1.0)
    gate = n_tier < (num_want // 3)
    refill_src = jnp.where(inb & (asg0 > 0), asg0, neg)
    rp = pad_to(refill_src, 8, neg)
    hp, wp = rp.shape
    idx_p, val = _blockwise_argmax(rp, 8)
    yy, xx = idx_p // wp, idx_p % wp
    ok = jnp.isfinite(val) & (yy < h) & (xx < w)
    flat = (yy * w + xx).reshape(-1)
    contrib = jnp.where(ok.reshape(-1) & gate, squash(val.reshape(-1)), 0.0)
    refill = jnp.zeros((h * w,), jnp.float32).at[flat].max(contrib)
    score = jnp.maximum(score, refill)

    val, idx = jax.lax.top_k(score, num_want)
    return idx, val > 0.0
