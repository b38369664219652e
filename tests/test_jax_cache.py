"""Persistent compilation cache placement (`utils.jax_cache`)."""

import jax
import pytest

from densemonoslam_tpu.utils import jax_cache


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_left_to_jax(monkeypatch, cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, `enable` sets no directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    jax.config.update("jax_compilation_cache_dir", "/left/alone")
    assert jax_cache.enable() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == "/left/alone"


def test_default_dir_is_the_checkout(monkeypatch, cache_config):
    """Without it, the cache goes to the fixed `<checkout>/.jax_cache`."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax_cache.enable() == jax_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == jax_cache.DEFAULT_DIR
    assert jax_cache.DEFAULT_DIR.endswith(".jax_cache")
