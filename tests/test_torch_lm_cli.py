"""The training CLI's LM mode (``launch/train.py`` without ``--gs``:
``run_lm``) and bf16 checkpoint leaves.

- The CLI on the CPU with ``--smoke``: 2 steps, then a second call to 4,
  bit-equal to an uninterrupted 4 (under
  ``torch.use_deterministic_algorithms(True)``), its token stream the
  reference's, its printed lines the reference CLI's.
- bf16 leaves: the port writes the bytes the reference's ``np.save``
  writes for an ``ml_dtypes`` bfloat16 array, restores those the
  reference's ``CheckpointManager.save`` writes bit for bit (and its own,
  deltas included); an fp8 leaf still raises on both sides.  The reference
  cannot restore a bf16 leaf itself (ROADMAP queue 3), so the port's
  resume is held against its own uninterrupted run.
"""

import io
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.tokens import SyntheticTokens as RefTokens  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.runtime import checkpoint as ref_ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.checkpoint import (UNSHAPED,  # noqa: E402
                                            CheckpointManager, tree_flatten)

SMOKE = ["--arch", "minicpm-2b", "--smoke", "--batch", "2", "--seq", "16",
         "--log-every", "1"]


def run_lm(ckpt_dir, steps, monkeypatch):
    """``run_lm`` as ``main`` runs it -> (its record, the batches it drew)."""
    drawn = []

    class Recorded(train.SyntheticTokens):
        def batch(self, step, **kw):
            out = super().batch(step, **kw)
            drawn.append((self, step, {k: v.clone() for k, v in out.items()}))
            return out

    monkeypatch.setattr(train, "SyntheticTokens", Recorded)
    args = train.build_parser().parse_args(
        SMOKE + ["--device", "cpu", "--steps", str(steps), "--ckpt-dir", str(ckpt_dir)])
    return train.run_lm(args), drawn


def skeleton(text):
    """Printed lines with numbers masked (the two packages draw different
    random weights, and time differently)."""
    return [re.sub(r"[-+]?\d[\d,.]*(e[-+]?\d+)?", "#", line)
            for line in text.strip().splitlines()]


def test_cli_resumes_bit_equal_and_streams_the_reference_tokens(
        tmp_path, monkeypatch, capsys):
    torch.use_deterministic_algorithms(True)
    try:
        whole, drawn = run_lm(tmp_path / "whole", 4, monkeypatch)
        first, _ = run_lm(tmp_path / "split", 2, monkeypatch)
        second, drawn2 = run_lm(tmp_path / "split", 4, monkeypatch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (whole["start"], first["start"], second["start"]) == (0, 0, 2)
    assert [s for _, s, _ in drawn2] == [2, 3]
    np.testing.assert_array_equal(first["loss"], whole["loss"][:2])
    np.testing.assert_array_equal(second["loss"], whole["loss"][2:])
    np.testing.assert_array_equal(second["grad_norm"], whole["grad_norm"][2:])
    assert whole["lr_scale"][0] == 0.0 and whole["lr_scale"][1] > 0
    for a, b in zip(tree_flatten((whole["params"], whole["opt"]))[0],
                    tree_flatten((second["params"], second["opt"]))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tree_flatten(whole["params"])[0][0].dtype == torch.bfloat16
    # the stream is the reference's, batch for batch
    for ds, step, got in drawn:
        want = RefTokens(vocab=ds.vocab, seq=ds.seq, global_batch=ds.global_batch,
                         seed=ds.seed).batch(step)
        assert (ds.seq, ds.global_batch, ds.seed) == (16, 2, 0)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the step-4 checkpoints of both runs hold the same bytes
    mgr_a = CheckpointManager(str(tmp_path / "whole"))
    mgr_b = CheckpointManager(str(tmp_path / "split"))
    assert mgr_a.all_steps() == [4] and mgr_b.all_steps() == [2, 4]
    like = (whole["params"], whole["opt"])
    a, extra = mgr_a.restore(4, like, device="cpu")
    b, _ = mgr_b.restore(4, like, device="cpu")
    assert extra == {"arch": "minicpm-2b-smoke"}
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)


def test_cli_prints_the_reference_lines_and_restores_its_checkpoint(
        tmp_path, monkeypatch, capsys):
    """Both CLIs, 2 steps each; the reference's final ``save`` tree is kept
    to hold the port's restore of the reference's bf16 checkpoint against."""
    saved = {}
    real_save = ref_ckpt.CheckpointManager.save

    def save(self, step, tree, **kw):
        saved[step] = jax.tree.map(np.asarray, tree)
        return real_save(self, step, tree, **kw)

    monkeypatch.setattr(ref_ckpt.CheckpointManager, "save", save)
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE + [
        "--steps", "2", "--ckpt-dir", str(tmp_path / "ref")])
    ref_train.main()
    want = capsys.readouterr().out
    assert train.main(SMOKE + ["--steps", "2", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out
    assert skeleton(got) == skeleton(want), (got, want)
    assert "resumed" not in got and got.strip().endswith("[train] done")

    # the reference's checkpoint: bf16 parameters, f32 moments, int32 step
    rec, _ = run_lm(tmp_path / "like", 1, monkeypatch)
    like = (rec["params"], rec["opt"])
    tree, extra = CheckpointManager(str(tmp_path / "ref")).restore(
        2, like, device="cpu")
    assert extra == {"arch": "minicpm-2b-smoke"}
    want_leaves = jax.tree.leaves(saved[2])
    got_leaves = tree_flatten(tree)[0]
    assert len(got_leaves) == len(want_leaves)
    n_bf16 = 0
    for g, w in zip(got_leaves, want_leaves):
        if w.dtype == jnp.bfloat16:
            n_bf16 += 1
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert n_bf16 == len(tree_flatten(rec["params"])[0])


def test_bf16_leaf_bytes_are_the_references(tmp_path):
    r = np.random.default_rng(0)
    for shape in ((), (5,), (3, 4, 2)):
        bits = r.integers(-2**15, 2**15, size=shape).astype(np.int16)
        want = io.BytesIO()
        np.save(want, bits.view(jnp.bfloat16))
        mgr = CheckpointManager(str(tmp_path / f"s{len(shape)}"))
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        d = mgr.save(1, {"w": t, "x": torch.arange(3, dtype=torch.int32)})
        with open(f"{d}/arr_000000.npy", "rb") as f:
            assert f.read() == want.getvalue()
        got, _ = mgr.restore(1, {"w": t, "x": UNSHAPED}, device="cpu")
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), t.view(torch.int16))
        # the manifest names the dtype as the reference's does
        ref = ref_ckpt.CheckpointManager(str(tmp_path / f"r{len(shape)}"))
        ref.save(1, {"w": jnp.asarray(bits.view(jnp.bfloat16)),
                     "x": jnp.arange(3)})
        assert mgr.manifest_extra(1) == ref.manifest_extra(1) == {}
        with open(f"{d}/manifest.json") as f:
            mine = json.load(f)["leaves"]
        with open(f"{ref._step_dir(1)}/manifest.json") as f:
            theirs = json.load(f)["leaves"]
        assert mine == theirs and mine[0]["dtype"] == "bfloat16"


def test_bf16_delta_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    w = torch.randn(6, 4).to(torch.bfloat16)
    mgr.save(1, {"w": w})
    w2 = w.clone()
    w2[2] += 1
    mgr.save_delta(2, {"w": w2}, base_step=1)
    got, _ = mgr.restore_delta(2, {"w": w}, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w2)


def test_fp8_leaf_still_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "port"))
    with pytest.raises(TypeError, match="leaf 0"):
        mgr.save(1, {"w": torch.zeros(3, dtype=torch.float8_e4m3fn)})
    ref = ref_ckpt.CheckpointManager(str(tmp_path / "ref"))
    ref.save(1, {"w": jnp.zeros(3, jnp.float8_e4m3fn)})
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        CheckpointManager(str(tmp_path / "ref")).restore(
            1, {"w": UNSHAPED}, device="cpu")


def test_main_without_gs_trains(tmp_path, capsys):
    assert train.main(SMOKE + ["--steps", "1", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)]) == 0
    assert "[train] done" in capsys.readouterr().out
