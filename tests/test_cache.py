"""The compile-cache rule (utils/cache.py): JAX_COMPILATION_CACHE_DIR wins
and nothing is set in code; without it the cache lives at the fixed path
<checkout>/.jax_cache, whatever the working directory or home."""

import pathlib

import jax
import pytest

from loltracer_tpu.utils import cache

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def restore_config():
    keep = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", keep[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", keep[1])


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    jax.config.update("jax_compilation_cache_dir", "/unchanged")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 7.0)
    assert cache.cache_dir() is None
    cache.enable_cache()
    assert jax.config.jax_compilation_cache_dir == "/unchanged"
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 7.0
    assert not (tmp_path / "c").exists()


def test_default_is_checkout_jax_cache(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_cache()
    assert jax.config.jax_compilation_cache_dir == str(
        CHECKOUT / ".jax_cache"
    )
    assert (CHECKOUT / ".jax_cache").is_dir()


def test_default_ignores_cwd_and_home(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert cache.cache_dir() == str(CHECKOUT / ".jax_cache")
