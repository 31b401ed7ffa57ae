"""The output check of a training cell, driven on the CPU at a small size
with the program's timed path broken underneath: each fault must come out
not correct, and the unbroken path correct."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_small as small  # noqa: E402


def test_sound_step_is_correct():
    out = small.drive("kingsnake-train")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_step_returning_its_state_is_caught(monkeypatch):
    from repro_torch.core import distributed as D
    real = D.make_gs_train_step

    def frozen(*a, **kw):
        step = real(*a, **kw)

        def same(g, opt, batch):
            out = step(g, opt, batch)
            return (g, opt) + tuple(out[2:])
        return same
    monkeypatch.setattr(D, "make_gs_train_step", frozen)
    out = small.drive("kingsnake-train")
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] > \
        out["checks"]["grad_gap"]["limit"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.core import distributed as D
    real = D._loss_partials

    def half(pred, gt, mask, **kw):
        # the loss's mean over the first half of the tiles alone
        keep = mask.clone()
        keep[keep.shape[0] // 2:] = False
        return real(pred, gt, keep, **kw)
    monkeypatch.setattr(D, "_loss_partials", half)
    out = small.drive("kingsnake-train")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > \
        out["checks"]["loss_gap"]["limit"]
