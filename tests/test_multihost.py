"""Execute the multi-process (jax.distributed) path once, for real.

This test has scripts/multihost_bench.py launch TWO localhost processes
(its one-process-per-card launcher), each with 2 virtual CPU devices,
initialize jax.distributed between them, and run the data-parallel
multiply benchmark end-to-end (4 global devices, decrypt-checked on the
first shard).  The reference claims multi-GPU scaling in its
docs/ARCHITECTURE.md:499-511 with no implementation.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multihost_bench.py")


def test_two_process_localhost_smoke(tmp_path):
    out_file = tmp_path / "multihost.json"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("PYTEST_CURRENT_TEST", None)
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--local-processes=2", "--n=1024",
         "--batch-per-chip=1", f"--out={out_file}"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=1100)
    assert proc.returncode == 0, (
        f"launcher failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")

    rec = json.loads(out_file.read_text())
    assert rec["processes"] == 2
    assert rec["chips_global"] == 4
    assert rec["global_batch"] == 4
    assert rec["ct_mul_per_s"] > 0
    assert rec["platform"] == "cpu"
