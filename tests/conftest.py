"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite never opens an accelerator: sharding logic is validated on
host-platform virtual devices, and pytest-xdist workers stay off the card.
Must set flags before jax initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from fhe_jax.utils import compile_cache

# XLA compiles dominate test time, so the persistent compilation cache is on
# by default: one CPU-only directory per xdist worker (no cross-process
# sharing), under the same root every entry point uses, and only executables
# that took >= 3 s to compile are serialized.  FHE_TEST_CACHE=0 opts out.
if os.environ.get("FHE_TEST_CACHE", "1") == "1":
    worker = os.environ.get("PYTEST_XDIST_WORKER", "solo")
    compile_cache.configure(subdir=f"tests-cpu-{worker}")
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 3.0)
else:
    jax.config.update("jax_enable_compilation_cache", False)
