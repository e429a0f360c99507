"""The persistent compilation cache goes where JAX_COMPILATION_CACHE_DIR
says, or to ``<checkout>/.jax_cache``, and nowhere else."""

import os

import jax

from fdc_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir():
    return jax.config.jax_compilation_cache_dir


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """JAX reads the variable itself; the helper sets nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = _cache_dir()
    assert enable_compile_cache() == str(tmp_path)
    assert _cache_dir() == before


def test_default_dir_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = _cache_dir()
    try:
        got = enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert _cache_dir() == got
        assert enable_compile_cache() == got  # a fixed path, every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
