"""The port's dry run and profiler (``repro_torch.launch.dryrun``,
``launch/profile_cell.py``) against the reference's records and output.

- the CLI writes an ``ok`` record with positive FLOPs and compute time, as
  ``tests/test_system.py:112-138`` asserts of the reference's;
- every decode_32k cell reads ``ok``: the ten SPECs through the CLI, the
  ten SMOKE configs through ``lm_cell`` (decode's position is a Python
  int, so the step runs on ``meta`` tensors);
- a ``skip`` record has the reference's status and reason, and an ``ok``
  record every key of the reference's record of the same cell (compiled
  on a 1x1 mesh) except what is not ported (``NOT_PORTED``); the
  reference's ``benchmarks/roofline.py``, loaded from its file and never
  edited, formats it;
- the GS cell's sizes and analytic FLOPs equal the reference's
  ``lower_gs_cell`` on a 1x1 mesh (lowered, not compiled); the GS branch
  of the CLI runs at a reduced dataset size;
- ``profile_cell --gs-train`` prints what ``tests/test_tools.py:240-257``
  asserts of the reference's, ``--by flops`` rows sum to the analyzer's
  total, and ``--by time`` profiles a SMOKE step on the CPU.
"""

import importlib.util
import json
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch.configs import all_arch_ids, get_smoke  # noqa: E402
from repro_torch.configs.gs_datasets import GSDataset  # noqa: E402
from repro_torch.launch import dryrun, profile_cell  # noqa: E402

from _torch_tooling import reference_dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: reference record keys with no port: XLA's memory and cost analyses, and
#: the lowering / compile / parse times (the port's one trace is ``trace_s``)
NOT_PORTED = {"memory_analysis", "xla_cost_analysis", "lower_s",
              "compile_s", "analyze_s"}
#: what the port records in their place, and its bound
PORT_ONLY = {"trace_s", "argument_size_in_bytes", "output_size_in_bytes",
             "fits_one_card", "bound_s"}


def record(out, arch, shape):
    return json.loads((Path(out) / "card" / f"{arch}__{shape}.json")
                      .read_text())


def roofline_module():
    spec = importlib.util.spec_from_file_location(
        "roofline_file", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_cli_writes_ok_record(tmp_path):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k",
                      "--out", str(tmp_path)])
    assert rc == 0
    rec = record(tmp_path, "whisper-tiny", "train_4k")
    assert rec["status"] == "ok", rec.get("traceback", "")[-500:]
    assert rec["hlo"]["flops"] > 0
    assert rec["roofline"]["compute_s"] > 0
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert rec["bound_s"] == max(
        rec["hlo"]["flops"] / dryrun.PEAK_FLOPS,
        rec["hlo"]["compulsory_bytes"] / dryrun.HBM_BW)
    assert rec["mesh"] == "card" and rec["n_devices"] == 1
    # cached: a second run reads the record back
    assert dryrun.run_cell("whisper-tiny", "train_4k", str(tmp_path)) \
        == "ok (cached)"


def test_spec_decode_cells_ok(tmp_path):
    assert dryrun.main(["--arch", "all", "--shape", "decode_32k", "--out",
                        str(tmp_path)]) == 0
    for arch in all_arch_ids():
        rec = record(tmp_path, arch, "decode_32k")
        assert rec["status"] == "ok", (arch, rec.get("traceback"))
        assert rec["hlo"]["flops"] > 0 and rec["bound_s"] > 0


@pytest.mark.parametrize("arch", all_arch_ids())
def test_smoke_decode_cell_ok(arch):
    got = dryrun.lm_cell(get_smoke(arch), "decode_32k")
    assert got["flops"] > 0 and got["matmul_flops"] > 0
    assert got["n_collective_sites"] == 0
    assert got["compulsory_bytes"] == got["argument_bytes"] + \
        got["output_bytes"]


def test_skip_and_ok_records_match_reference(tmp_path):
    ref = reference_dryrun()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    for arch, shape in (("codeqwen1.5-7b", "long_500k"),
                        ("whisper-tiny", "decode_32k")):
        ref.run_cell(arch, shape, mesh, "single", str(ref_dir))
        assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                            str(port_dir)]) == 0
    want = json.loads((ref_dir / "single" / "codeqwen1.5-7b__long_500k.json")
                      .read_text())
    got = record(port_dir, "codeqwen1.5-7b", "long_500k")
    assert (got["status"], got["reason"]) == (want["status"],
                                              want["reason"]) \
        == ("skip", dryrun.SKIP_REASON)
    want = json.loads((ref_dir / "single" / "whisper-tiny__decode_32k.json")
                      .read_text())
    got = record(port_dir, "whisper-tiny", "decode_32k")
    assert want["status"] == got["status"] == "ok"
    assert set(want) - NOT_PORTED <= set(got)
    assert set(got) - set(want) == PORT_ONLY
    assert set(want["hlo"]) <= set(got["hlo"])
    assert set(want["roofline"]) == set(got["roofline"])
    roofline = roofline_module()
    table = roofline.fmt_table([got, record(port_dir, "codeqwen1.5-7b",
                                            "long_500k")])
    assert re.search(r"whisper-tiny__decode_32k\s+ok\s", table)
    assert re.search(r"codeqwen1.5-7b__long_500k\s+skip", table)


def test_gs_cell_matches_reference(tmp_path, monkeypatch, capsys):
    ref = reference_dryrun()
    _, meta, flops = ref.lower_gs_cell(
        "gs-kingsnake", jax.make_mesh((1, 1), ("data", "model")))
    assert dryrun.gs_meta("gs-kingsnake") == meta
    assert dryrun.gs_model_flops(meta) == flops
    # the GS branch of the CLI, at a dataset size the CPU traces in seconds
    monkeypatch.setattr(dryrun, "GS_CELLS", {"gs-tiny": ("kingsnake", 256)})
    monkeypatch.setattr(dryrun, "GS_FULL", {"kingsnake": GSDataset(
        "kingsnake", "kingsnake", n_points=5000)})
    assert dryrun.main(["--gs", "--out", str(tmp_path)]) == 0
    rec = record(tmp_path, "gs-tiny", "train")
    assert rec["status"] == "ok", rec.get("traceback", "")[-500:]
    assert rec["gs_meta"] == {
        "dataset": "kingsnake", "resolution": 256, "n_parts": 1,
        "gaussians_per_part": 8192, "K": 64, "tiles": 64,
        "step": "core.train.make_train_step"}
    assert rec["model_flops_global"] == dryrun.gs_model_flops(rec["gs_meta"])
    assert rec["hlo"]["flops"] > rec["model_flops_global"] > 0
    # and profile_cell's --gs cell, by bytes and by time on the CPU
    for by in ("hbm", "time"):
        assert profile_cell.main(["--gs", "gs-tiny", "--by", by, "--top", "3",
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gs-tiny [card]  total" in out and "GB per device" in out
    assert re.search(r"gs-tiny \[card\]  [\d.]+ ms per step", out)


def test_profile_cell_gs_train(capsys):
    assert profile_cell.main(["--gs-train", "sphere_shell", "--gs-res", "32",
                              "--top", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gs-train-sphere_shell" in out
    assert "part,view" in out
    assert "GB per device" in out


def test_profile_cell_flop_rows_sum_to_total(capsys):
    argv = ["--arch", "minicpm-2b", "--smoke", "--shape", "train_4k"]
    assert profile_cell.main(argv + ["--by", "flops", "--top", "1000"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    total = float(re.search(r"total ([\d.]+) GFLOP per device",
                            lines[0]).group(1))
    rows = [float(line.split()[0]) for line in lines[1:]]
    want = dryrun.lm_cell(get_smoke("minicpm-2b"), "train_4k")["flops"]
    assert total == pytest.approx(want / 1e9, abs=0.05)
    assert sum(rows) == pytest.approx(want / 1e9, abs=0.005 * len(rows))
    assert profile_cell.main(argv + ["--batch", "2", "--seq", "64", "--by",
                                     "time", "--device", "cpu", "--top",
                                     "3"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"minicpm-2b__train_4k \[card\]  [\d.]+ ms per step, "
                     r"device busy [\d.]+% of the window", out)
