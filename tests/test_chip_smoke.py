"""chip_smoke.py refuses to run anywhere but on a GPU.

Its checks on the card are functions of chip_smoke.py itself; here only its
refusal is tested: on the CPU, and without the rest of the repository, it
must exit non-zero and print no ``"ok": true`` line."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    env.pop("PYTEST_XDIST_WORKER", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("args", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_refuses_the_cpu(args):
    proc = _run(REPO, args)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fails_without_the_repository(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    proc = _run(tmp_path, [], {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
