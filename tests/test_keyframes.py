"""Keyframe selection tests."""

import numpy as np

from cvo_rgbd_tpu import AcvoParams, pad_cloud
from cvo_rgbd_tpu.keyframes import KeyframePolicy, KeyframeSelector, keyframe_score

P = AcvoParams()


def _cloud(rng, offset=0.0, n=60):
    pos = rng.standard_normal((n, 3)).astype(np.float32) * 0.4
    pos[:, 0] += offset
    feat = rng.random((n, 5)).astype(np.float32) * 0.5
    return pad_cloud(pos, feat)


def test_score_self_is_one(rng):
    c = _cloud(rng)
    assert abs(keyframe_score(P, c, c) - 1.0) < 1e-5


def test_score_decreases_with_offset(rng):
    base = np.random.default_rng(3)
    c0 = _cloud(base)
    scores = []
    for off in [0.0, 0.05, 0.2]:
        b2 = np.random.default_rng(3)
        scores.append(keyframe_score(P, c0, _cloud(b2, offset=off)))
    assert scores[0] > scores[1] >= scores[2] - 1e-6


def test_selector_promotes_on_low_overlap(rng):
    sel = KeyframeSelector(P, KeyframePolicy(threshold=0.9, max_span=100))
    base = np.random.default_rng(5)
    c0 = _cloud(base)
    new, s = sel.update(0, c0)
    assert new and sel.key_index == 0
    # same cloud: no promotion
    new, s = sel.update(1, c0)
    assert not new
    # far-away cloud: promotion
    far = np.random.default_rng(5)
    new, s = sel.update(2, _cloud(far, offset=1.0))
    assert new and sel.key_index == 2


def test_selector_max_span(rng):
    sel = KeyframeSelector(P, KeyframePolicy(threshold=0.0, max_span=2))
    c = _cloud(rng)
    sel.update(0, c)
    assert not sel.update(1, c)[0]
    assert sel.update(2, c)[0]  # forced by span


def test_function_inner_product_ell_argument(rng):
    """The reference evaluates at the *current* member ell
    (adaptive_cvo.cpp:393); the ell argument exposes that, defaulting to
    ell_init.  A larger ell admits more pairs -> different score."""
    from cvo_rgbd_tpu.core.registration import function_inner_product

    p = AcvoParams()
    a, b = _cloud(rng), _cloud(rng, offset=0.05)
    default = float(function_inner_product(p, a, b))
    at_init = float(function_inner_product(p, a, b, ell=p.ell_init))
    wide = float(function_inner_product(p, a, b, ell=5.0 * p.ell_init))
    assert default == at_init
    assert wide != default
    assert np.isfinite(wide)


def test_aligned_fip_ranks_true_transform(rng):
    """aligned_fip scores a pair under K candidate SE(3)s in one call;
    the TRUE registration must outrank drift-scale offsets (this is the
    arbiter slam loop closure uses to choose between prior-init and
    cold-init registrations)."""
    from cvo_rgbd_tpu import se3
    from cvo_rgbd_tpu.keyframes import aligned_fip

    base = np.random.default_rng(11)
    c0 = _cloud(base, n=120)
    R = np.asarray(se3.exp_so3(np.array([0.02, -0.01, 0.015], np.float32)))
    t = np.array([0.03, -0.02, 0.01], np.float32)
    # moving cloud = fixed cloud displaced by inv(true_tf)
    pos1 = ((np.asarray(c0.positions) - t) @ R).astype(np.float32)
    c1 = c0._replace(positions=pos1)
    true_tf = np.eye(4, dtype=np.float32)
    true_tf[:3, :3] = R
    true_tf[:3, 3] = t
    off = true_tf.copy()
    off[:3, 3] += [0.1, 0.0, 0.0]      # 10 cm drift-scale offset
    far = np.eye(4, dtype=np.float32)  # identity (un-registered)
    quals = np.asarray(aligned_fip(P, c0, c1, [true_tf, off, far]))
    assert quals.shape == (3,)
    assert quals[0] > quals[1], quals
    assert quals[0] > quals[2], quals


def test_linear_mode_keyframe_scoring(rng):
    """function_inner_product under MATLAB_PARAMS (linear color mode)
    must evaluate the MATLAB product kernel A = CI .* K — not the se
    color kernel that parameter set never calibrated.  Scoring semantics still hold: self-score 1, overlap
    decays with displacement."""
    from cvo_rgbd_tpu import MATLAB_PARAMS
    from cvo_rgbd_tpu.core.registration import function_inner_product
    from cvo_rgbd_tpu.core.gram import linear_color_gram, matlab_gram

    base = np.random.default_rng(11)
    pos = base.standard_normal((60, 3)).astype(np.float32) * 0.4
    col = base.random((60, 3)).astype(np.float32) * 255.0  # MATLAB colors
    c0 = pad_cloud(pos, col)

    fip = float(function_inner_product(MATLAB_PARAMS, c0, c0))
    assert np.isfinite(fip) and fip > 0

    # oracle: mean of the gated MATLAB-mode A at ell_init
    import jax.numpy as jnp
    ci = linear_color_gram(c0.features, c0.features,
                           MATLAB_PARAMS.color_scale)
    A = matlab_gram(c0.positions, c0.mask, c0.positions, c0.mask, ci,
                    jnp.float32(MATLAB_PARAMS.ell_init),
                    sigma=MATLAB_PARAMS.sigma,
                    sp_thres=MATLAB_PARAMS.sp_thres)
    expect = float(jnp.sum(A) / jnp.maximum(jnp.sum(A > 0), 1))
    assert abs(fip - expect) < 1e-6 * max(1.0, abs(expect))

    assert abs(keyframe_score(MATLAB_PARAMS, c0, c0) - 1.0) < 1e-5
    scores = []
    for off in [0.0, 0.1, 0.4]:
        moved = pad_cloud(pos + np.array([off, 0, 0], np.float32), col)
        scores.append(keyframe_score(MATLAB_PARAMS, c0, moved))
    assert scores[0] > scores[1] > scores[2]


def test_selector_tick_keeps_span_cadence(rng):
    """tick() advances frames_since without scoring, so a driver that
    skips promotion checks mid-group still forces max_span promotions
    at frame-accurate cadence (ADVICE r3)."""
    sel = KeyframeSelector(P, KeyframePolicy(threshold=0.0, max_span=3))
    c = _cloud(rng)
    sel.update(0, c)
    assert not sel.update_scored(1, c, 1.0, 1.0)[0]
    sel.tick()   # frame 2 processed without scoring
    assert sel.update_scored(3, c, 1.0, 1.0)[0]  # forced at span 3
