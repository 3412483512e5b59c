"""Utilities: where the persistent compilation cache lives, and the
numpy + zlib PNG writer (read back here with PIL)."""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from vkvolume.utils import compile_cache_dir, enable_compile_cache
from vkvolume.utils.image import encode_png, write_png

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "relative/cache"])
def test_compile_cache_placement(monkeypatch, tmp_path, env):
    """``$JAX_COMPILATION_CACHE_DIR`` when set (made absolute), else the
    fixed ``<repo>/.cache/jax`` whatever the working directory."""
    monkeypatch.chdir(tmp_path)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(_REPO, ".cache", "jax")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = str(tmp_path / env)
    assert compile_cache_dir() == want


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    target = tmp_path / "jax-cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(target)
        assert jax.config.jax_compilation_cache_dir == str(target)
        assert target.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (6, 3, 3), (4, 9, 4)])
def test_png_roundtrip(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(img))
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, img.reshape(back.shape))


def test_write_png_composites_premultiplied_rgba(tmp_path):
    """Float RGBA is premultiplied colour: written as RGB over black."""
    rgba = np.zeros((2, 3, 4), np.float32)
    rgba[0, 0] = (0.5, 0.25, 0.0, 0.5)
    rgba[1, 2] = (1.0, 1.0, 1.0, 1.0)
    path = tmp_path / "c.png"
    write_png(str(path), rgba)
    back = np.asarray(Image.open(path))
    assert back.shape == (2, 3, 3)
    np.testing.assert_array_equal(back[0, 0], (128, 64, 0))
    np.testing.assert_array_equal(back[1, 2], (255, 255, 255))
    assert back[0, 1].max() == 0


def test_encode_png_rejects_non_u8():
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        encode_png(np.zeros((2, 2, 2), np.uint8))
