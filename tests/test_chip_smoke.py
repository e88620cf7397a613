"""chip_smoke.py and the compile-cache helper, on the CPU.

What the script checks needs the card (it runs there as
`python chip_smoke.py`); here the guard that refuses any other
platform, the cache placement, and the four-card phase on the
virtual CPU mesh at a tiny size.
"""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cvo_rgbd_tpu.utils import compile_cache  # noqa: E402


def test_device_guard_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert "no CPU fallback" in str(e.value)


def test_device_guard_counts_cards():
    class Gpu:
        platform = "gpu"

    assert chip_smoke.require_gpu([Gpu()] * 4, count=4)
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([Gpu()], count=4)


def test_script_exits_nonzero_on_cpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_default(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path on every call: no pid, time or temp name in it
        assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_four_card_phase_on_cpu_mesh(rng):
    """The --four phase's comparisons, rehearsed on 4 virtual CPU
    devices with small clouds."""
    import numpy as np

    from cvo_rgbd_tpu import pad_cloud, se3

    clouds = []
    base = rng.standard_normal((120, 3)).astype(np.float32) * 0.3
    feat = (rng.random((120, 5)) * 255).astype(np.float32)
    for k in range(3):
        R = np.asarray(se3.exp_so3(np.array([0, 0.01 * k, 0], np.float32)))
        clouds.append(pad_cloud(base @ R.T, feat, capacity=128))
    chip_smoke.four_card_phase(
        jax.devices(), clouds, seed=0, lanes=8, points=64,
        sharded_cloud_pair=(clouds[0], clouds[1]),
    )
