"""Persistent compilation cache location: JAX_COMPILATION_CACHE_DIR, when
set, is left to JAX (no directory is set in code); otherwise the cache is
the fixed in-checkout path <repo>/.cache/jax."""

import os

import jax

from collocfem_tpu.utils import cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_cache_honours_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    got = cache.enable_persistent_cache()
    assert got == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_cache_falls_back_to_fixed_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    got = cache.enable_persistent_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".cache", "jax")
    assert calls["jax_compilation_cache_dir"] == got
    assert os.path.isdir(got)
