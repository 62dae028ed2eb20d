"""The compile-cache location: JAX_COMPILATION_CACHE_DIR, else
<checkout>/.jax_cache."""

import pathlib

import jax

from csa_jax.utils import compile_cache


def _spy(monkeypatch):
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    return seen


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = _spy(monkeypatch)
    compile_cache.enable_compile_cache()
    assert seen == {}


def test_default_dir_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = _spy(monkeypatch)
    compile_cache.enable_compile_cache()
    root = pathlib.Path(__file__).resolve().parents[1]
    assert seen == {"jax_compilation_cache_dir": str(root / ".jax_cache")}
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()
