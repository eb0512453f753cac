"""utils.compile_cache: one fixed place for JAX's persistent cache."""

import os

import jax

from sapling_tpu.utils.compile_cache import use_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_unset_env_uses_checkout_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = use_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_set_env_is_left_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set
