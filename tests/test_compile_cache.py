"""fhe_jax.utils.compile_cache: one fixed compile-cache location."""

import os

import jax
import pytest

from fhe_jax.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing the session."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured_and_nothing_is_set(monkeypatch, updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache.configure() == "/somewhere/else"
    assert compile_cache.configure(subdir="tests-cpu-gw0") == "/somewhere/else"
    assert updates == []


def test_default_is_inside_the_checkout(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure()
    assert path == os.path.join(REPO, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]


def test_subdir_stays_under_the_same_root(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure(subdir="tests-cpu-gw3")
    assert path == os.path.join(REPO, ".jax_cache", "tests-cpu-gw3")


def test_path_is_fixed_across_calls(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.configure() == compile_cache.configure()
    assert str(os.getpid()) not in compile_cache.configure()


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
