"""Device reports (fhe_jax.utils.device_report) and the trace reduction of
scripts/trace_breakdown.py, on canned inputs."""

import os
import sys

import pytest

from fhe_jax.utils import device_report

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import trace_breakdown  # noqa: E402

ONE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W\n"
FOUR_CARDS = "".join(f"NVIDIA H100 80GB HBM3, {w} W\n"
                     for w in ("700.00", "700.00", "650.00", "700.00"))


def test_parse_one_card():
    assert device_report.parse_nvidia_smi(ONE_CARD) == [
        {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}]


def test_parse_four_cards_keeps_order_and_limits():
    cards = device_report.parse_nvidia_smi(FOUR_CARDS)
    assert len(cards) == 4
    assert [c["power_limit"] for c in cards] == [
        "700.00 W", "700.00 W", "650.00 W", "700.00 W"]


def test_parse_name_with_comma_and_na_limit():
    cards = device_report.parse_nvidia_smi("Some, Card, [N/A]")
    assert cards == [{"name": "Some, Card", "power_limit": "[N/A]"}]


@pytest.mark.parametrize("text", ["no comma here", ", 700.00 W"])
def test_parse_rejects_malformed_lines(text):
    with pytest.raises(ValueError):
        device_report.parse_nvidia_smi(text)


def test_missing_nvidia_smi_is_reported(monkeypatch):
    monkeypatch.setattr(device_report.shutil, "which", lambda _: None)
    assert device_report.query_nvidia_smi() == "nvidia-smi not found"


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device_report.require_gpu()


def test_trace_summary_counts_kernels_and_busy_time():
    # two calls of one module: kernels overlap inside each call
    events = [
        ("jit_f", "k1", 0, 10), ("jit_f", "k2", 5, 10),      # busy 15
        ("jit_f", "k1", 100, 10), ("jit_f", "k2", 100, 4),   # busy 10
        ("jit_g", "k3", 50, 2),
    ]
    s = trace_breakdown.summarize(events, iters=2)
    assert s["jit_f"]["kernels_per_call"] == 2
    assert s["jit_f"]["kernel_us_per_call"] == pytest.approx(17e-3)
    assert s["jit_f"]["busy_us_per_call"] == pytest.approx(12.5e-3)
    assert s["jit_f"]["top_kernels_us_per_call"] == pytest.approx(
        {"k1": 10e-3, "k2": 7e-3})
    assert s["jit_g"]["kernels_per_call"] == 0.5


def test_trace_derived_shares():
    stats = {name: {"kernel_us_per_call": us} for name, us in {
        "mul_relin": 100.0, "mul_no_relin": 70.0, "relin": 30.0,
        "ntts_of_mul_no_relin": 40.0, "ntts_of_relin": 20.0,
        "ntt_fwd_b1": 10.0, "ntt_fwd_b64": 20.0}.items()}
    d = trace_breakdown.derive({"stats": stats, "n": 8192, "k": 3},
                               "NVIDIA H100 80GB HBM3")
    assert d["ntt_share_of_mul_relin"] == pytest.approx(0.6)
    assert d["behz_and_pointwise_share_of_mul_relin"] == pytest.approx(0.3)
    assert d["keyswitch_non_ntt_share_of_mul_relin"] == pytest.approx(0.1)
    assert d["ntt_fwd_b1_min_bytes"] == 2 * 3 * 8192 * 4 * 2
    assert d["ntt_fwd_b1_hbm_share"] == pytest.approx(
        d["ntt_fwd_b1_min_bytes"] / 10e-6 / 3.35e12)
