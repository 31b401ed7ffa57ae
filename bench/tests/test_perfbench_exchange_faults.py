"""The output check of the four-card training cell, driven on four gloo
ranks on the CPU at a small size: the "part" all-gather between the
ranks left out must come out not correct, and the unbroken exchange
correct."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_small as small  # noqa: E402


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_exchange_between_ranks(fault, tmp_path):
    out = small.drive_ranks("rayleigh_taylor-train-4", 4, fault,
                            tmp_path / "result.json")
    assert out["correct"] == (fault == "none"), out["checks"]
