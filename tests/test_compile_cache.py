"""The persistent compile cache location follows JAX_COMPILATION_CACHE_DIR."""

import os

import jax
import pytest

from colmap_tpu.util import compile_cache


@pytest.fixture
def restore_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_cache_honours_env_var(monkeypatch, tmp_path, restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_cache_defaults_to_fixed_repo_dir(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.setup_compile_cache() == compile_cache.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == compile_cache.REPO_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.REPO_CACHE_DIR == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()
