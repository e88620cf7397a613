"""Pure-JAX image pipeline: color conversion, pyramid, gradients.

Replacement of the reference frame preparation
(pcd_generator.cpp:33-120 `make_pyramid`, :384-396 `load_image`):
`reduce_window` 2x2-mean pyramid, central-difference gradients as
shifted adds — all fused by XLA, static shapes.

Color-convention note (documented deviation): the reference loads BGR
via `cv::imread` but converts with `COLOR_RGB2GRAY` / `COLOR_RGB2HSV`
(pcd_generator.cpp:390-391), i.e. it runs RGB formulas on BGR data.
Since the registration kernel only *compares* features between frames,
any consistent transformation works; we use the correct RGB formulas on
RGB input.  Bit-parity with the reference's selection masks is
explicitly a non-goal (SURVEY.md section 7 step 4) — trajectory-level
parity is the target.
"""

from __future__ import annotations

import jax.numpy as jnp

PYR_LEVELS = 3  # data_type.h:25


def rgb_to_gray(rgb):
    """[H,W,3] float (0..255) -> [H,W] luma, OpenCV Y weights."""
    return (
        0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    )


def rgb_to_hsv_cv(rgb):
    """[H,W,3] float 0..255 -> OpenCV 8-bit HSV ranges: H in 0..180,
    S,V in 0..255 (matches cv::COLOR_RGB2HSV on uint8 inputs, which the
    acvo features consume, adaptive_cvo feature_type 0)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    diff = v - mn
    diff_safe = jnp.where(diff == 0, 1.0, diff)
    s = jnp.where(v == 0, 0.0, 255.0 * diff / jnp.where(v == 0, 1.0, v))
    h = jnp.where(
        v == r,
        60.0 * (g - b) / diff_safe,
        jnp.where(
            v == g,
            120.0 + 60.0 * (b - r) / diff_safe,
            240.0 + 60.0 * (r - g) / diff_safe,
        ),
    )
    h = jnp.where(diff == 0, 0.0, h)
    h = jnp.where(h < 0, h + 360.0, h) / 2.0  # OpenCV stores H/2 in 8 bits
    return jnp.stack([h, s, v], axis=-1)


def downsample2(img):
    """2x2 mean pooling (pcd_generator.cpp:84-91)."""
    h, w = img.shape
    return jnp.mean(img[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2), axis=(1, 3))


def gradients(img):
    """Central differences, zero on all borders.

    The reference zeroes only the first/last rows and lets column
    gradients wrap across row boundaries (pcd_generator.cpp:96-106, a
    flat-index artifact); we zero the edge columns too.
    """
    dx = jnp.zeros_like(img)
    dy = jnp.zeros_like(img)
    dx = dx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    dy = dy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    dx = dx.at[0, :].set(0.0).at[-1, :].set(0.0)
    return dx, dy


def make_pyramid(gray):
    """[H,W] intensity -> list of (intensity, dx, dy, abs_sq_grad)
    per level (pcd_generator.cpp:33-120)."""
    levels = []
    img = gray
    for _ in range(PYR_LEVELS):
        dx, dy = gradients(img)
        levels.append((img, dx, dy, dx * dx + dy * dy))
        img = downsample2(img)
    return levels
