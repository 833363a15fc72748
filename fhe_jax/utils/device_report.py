"""Which device a measurement ran on.

Every timed number names the device: JAX's platform, ``device_kind`` and
device count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load).
A measurement that finds no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess

import jax

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


def parse_nvidia_smi(text: str) -> list[dict]:
    """Parse ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output: one ``{"name", "power_limit"}`` per card, in card order."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


def query_nvidia_smi() -> str:
    """Raw ``name, power.limit`` lines from nvidia-smi, or a placeholder
    saying why they could not be read."""
    if shutil.which(NVIDIA_SMI_QUERY[0]) is None:
        return "nvidia-smi not found"
    proc = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                          timeout=60, check=False)
    if proc.returncode != 0:
        return f"nvidia-smi failed (rc={proc.returncode})"
    return proc.stdout.strip()


def require_gpu() -> dict:
    """The device report of this process; raises RuntimeError unless JAX's
    default backend is a GPU with at least one device."""
    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or not devices:
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r} "
            f"({len(devices)} devices); refusing to measure on it")
    smi = query_nvidia_smi()
    try:
        cards = parse_nvidia_smi(smi)
    except ValueError:
        cards = []
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": smi,
        "cards": cards,
    }
