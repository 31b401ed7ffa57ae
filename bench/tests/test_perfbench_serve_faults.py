"""The output check of a serving cell, driven on the CPU at a small size
with the served answers broken where they are produced: each fault must
come out not correct, and the unbroken path correct."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_small as small  # noqa: E402


@pytest.mark.parametrize("workload", ["kingsnake-serve-novel",
                                      "kingsnake-serve-orbit"])
def test_sound_answers_are_correct(workload):
    out = small.drive(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _patch_dispatch(monkeypatch, change):
    from repro_torch.core.serving import GSRenderServer
    real = GSRenderServer._dispatch

    def broken(self, reqs):
        return change(real(self, reqs))
    monkeypatch.setattr(GSRenderServer, "_dispatch", broken)


def test_altered_answer_is_caught(monkeypatch):
    def shift(results):
        for r in results:
            r.rgb = r.rgb + 0.01
        return results
    _patch_dispatch(monkeypatch, shift)
    out = small.drive("kingsnake-serve-novel")
    assert not out["correct"]
    assert out["checks"]["image_gap"]["value"] > \
        out["checks"]["image_gap"]["limit"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(results):
        # the second half of a batch answered with the first half's images
        n = len(results)
        for i in range(n // 2, n):
            results[i].rgb = results[i - n // 2].rgb
        return results
    _patch_dispatch(monkeypatch, half)
    out = small.drive("kingsnake-serve-orbit")
    assert not out["correct"]
