"""Where JAX keeps compiled executables between runs.

Every entry point (``bench.py``, ``chip_smoke.py``, ``__graft_entry__.py``,
``scripts/fuzz.py``, ``scripts/multihost_bench.py``) calls ``configure()``
before its first compile.  The cache key includes the directory, so the
path is fixed: never built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure(subdir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``,
    or to ``<checkout>/.jax_cache/<subdir>`` when ``subdir`` is given.
    Returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = DEFAULT_DIR / subdir if subdir else DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", str(path))
    return str(path)
