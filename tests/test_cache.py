"""Persistent compile cache location (utils/cache.py)."""
import os

import jax
import pytest

from voxelray_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def keep_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_used_exactly(monkeypatch, tmp_path, keep_config):
    want = str(tmp_path / "xla-cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_default_dir_is_fixed_inside_checkout(monkeypatch, keep_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.cache_dir() == want
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
