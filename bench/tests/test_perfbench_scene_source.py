"""A configuration's point source, found by name: the dense source makes
the points the harness always made, ``fields.crossings_by_slab`` is the
whole-field extraction bit for bit, and a configuration that brings its
own slab-made scene is added to a copy of the benchmark as new files only
and driven to ``correct`` (and, with its program side shifted by a row,
to not correct).

The slab extraction at the four-card cell's size, against the whole
field and its device peak, needs a card (``-m cuda``, ``-s`` prints the
peaks):

    python -m pytest -q -s -m cuda bench/tests/test_perfbench_scene_source.py
"""

import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_small as small  # noqa: E402
from gsbench import fields, scene  # noqa: E402

BENCH = small.BENCH
FIXTURE = BENCH / "tests" / "fixtures" / "added_config"
SEEDS = (1, 2**31 + 5, 4052739537)


def _points_as_the_parent_made_them(cfg, seed, device):
    """The dense points as the harness made them before configurations
    could bring their own source (a frozen copy)."""
    from repro_torch.data.isosurface import extract_isosurface
    field = fields.make_field(cfg["field"], cfg["resolution"], device)
    pts, count = extract_isosurface(field, float(cfg["iso"]),
                                    max_points=int(cfg["max_crossings"]))
    count = int(count)
    rows = scene.select_rows(count, int(cfg["points"]), seed)
    pts = pts[torch.from_numpy(rows)]
    ref = fields.crossings(field, float(cfg["iso"]))
    return pts, fields.height_colors(pts), rows, count, ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("config", sorted(small.CONFIGS))
def test_dense_source_makes_the_same_points(config, seed):
    cell = types.SimpleNamespace(bench=BENCH, spec={"config": config})
    src = scene.source(cell)
    assert src is scene.DENSE
    cfg = small.CONFIGS[config]
    pts, cols, rows, count = src.points(cfg, seed, "cpu")
    w_pts, w_cols, w_rows, w_count, w_ref = _points_as_the_parent_made_them(
        cfg, seed, "cpu")
    assert count == w_count and np.array_equal(rows, w_rows)
    assert torch.equal(pts, w_pts) and torch.equal(cols, w_cols)
    assert torch.equal(src.reference_points(cfg, "cpu"), w_ref)


def test_small_twins_are_found_by_name():
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert set(small.CONFIGS) == {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        assert small.small_cell(w["name"]).config == \
            small.CONFIGS[w["config"]]


@pytest.mark.parametrize("planes", ["1", "5", "R-1", "R"])
@pytest.mark.parametrize("res", [24, 37])
@pytest.mark.parametrize("name", ["gyroid", "rayleigh_taylor"])
def test_slab_crossings_equal_the_whole_field(name, res, planes):
    n = {"1": 1, "5": 5, "R-1": res - 1, "R": res}[planes]
    whole = fields.crossings(fields.make_field(name, res, "cpu"))
    made = []

    def make(lo, hi):
        made.append((lo, hi))
        return fields.make_field(name, res, "cpu", lo, hi)

    got = fields.crossings_by_slab(make, res, 0.0, n)
    assert got.dtype == torch.float32 and torch.equal(got, whole)
    assert all(hi - lo <= n + 1 for lo, hi in made)
    # each slab is the whole field's planes, bit for bit
    dense = fields.make_field(name, res, "cpu")
    for lo, hi in made:
        assert torch.equal(fields.make_field(name, res, "cpu", lo, hi),
                           dense[lo:hi])


@pytest.mark.parametrize("planes", [1, 2, 5, 15, 16])
def test_slab_crossings_on_slab_boundaries(planes):
    res = 16
    gen = torch.Generator().manual_seed(7)
    field = torch.randn(res, res, res, generator=gen)
    field[5] = 0.0          # a plane on the iso value: no crossing touches it
    field[10, 3] = 0.0
    whole = fields.crossings(field)
    got = fields.crossings_by_slab(lambda lo, hi: field[lo:hi], res, 0.0,
                                   planes)
    assert torch.equal(got, whole)
    # there are crossings between every pair of neighbouring planes, so on
    # each slab boundary along axis 0 (bar the zero plane's)
    lower = torch.floor(whole[:, 0] * res - 0.5).long()
    on_axis0 = whole[:, 0] * res - 0.5 != lower
    seen = set(lower[on_axis0].tolist())
    assert seen == set(range(res - 1)) - {4, 5}


def test_slab_extraction_refuses_a_wrong_slab():
    with pytest.raises(ValueError):
        fields.crossings_by_slab(lambda lo, hi: torch.zeros(1, 4, 4), 4)
    with pytest.raises(ValueError):
        fields.crossings_by_slab(lambda lo, hi: torch.zeros(hi - lo, 4, 4),
                                 4, 0.0, 0)


def _new_file(path: Path, text: str):
    assert not path.exists(), f"{path} is not a new file"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _with_added_config(root: Path, scene_edit=None) -> Path:
    """A copy of the benchmark under ``root`` with the fixture's
    configuration added as new files and entries of ``BENCHMARK.json``
    -> the copy's ``bench``.  ``scene_edit`` rewrites its scene file."""
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "fixtures"))
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    add = json.loads((FIXTURE / "manifest_entries.json").read_text())
    for key, entries in add.items():
        man[key] += entries
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    for path in sorted(FIXTURE.rglob("*")):
        rel = path.relative_to(FIXTURE)
        if path.is_file() and rel.name != "manifest_entries.json":
            text = path.read_text()
            if scene_edit and rel.parts[0] == "scenes":
                text = scene_edit(text)
            _new_file(bench / rel, text)
    return bench


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    return _with_added_config(tmp_path_factory.mktemp("added"))


@pytest.mark.parametrize("workload", ["wavy_shell-train",
                                      "wavy_shell-serve"])
def test_added_configuration_is_correct(added, workload):
    cell = small.small_cell(workload, added)
    src = scene.source(cell)
    assert src is not scene.DENSE and src.SHIFT == 0
    out = small.drive(workload, bench=added)
    assert out["correct"], out["checks"]
    assert out["checks"]["points_gap"]["value"] == 0.0
    assert out["attempted"] > 0 and out["failed"] == 0


def test_added_configuration_shifted_by_a_row_is_caught(tmp_path):
    bench = _with_added_config(tmp_path, lambda text: text.replace(
        "\nSHIFT = 0\n", "\nSHIFT = 1\n"))
    out = small.drive("wavy_shell-train", bench=bench)
    assert not out["correct"]
    gap = out["checks"]["points_gap"]
    assert gap["value"] > gap["limit"]


DENSE_REFERENCE = '''

def reference_points(cfg, device):
    res = int(cfg["resolution"])
    return fields.crossings(field_slab(res, 0, res, device),
                            float(cfg["iso"]))
'''


def test_added_configuration_agrees_with_a_dense_reference(added, tmp_path):
    bench = _with_added_config(tmp_path, lambda text: text + DENSE_REFERENCE)
    cfg = small.twin("wavy_shell", bench)
    slab = scene.source(small.small_cell("wavy_shell-train", added))
    dense = scene.source(small.small_cell("wavy_shell-train", bench))
    assert torch.equal(slab.reference_points(cfg, "cpu"),
                       dense.reference_points(cfg, "cpu"))
    out = small.drive("wavy_shell-train", bench=bench)
    assert out["correct"], out["checks"]
    assert out["checks"]["points_gap"]["value"] == 0.0


IMPORTS = {
    "statement": "    from repro_torch.data import isosurface\n",
    "module": "    import repro_torch.data.isosurface as iso\n",
    "helper": "    _helper()\n",
}


@pytest.mark.parametrize("how", sorted(IMPORTS))
def test_reference_side_importing_the_program_is_refused(how, tmp_path):
    text = (FIXTURE / "scenes" / "wavy_shell.py").read_text()
    text = text.replace(
        "def reference_points(cfg: dict, device) -> torch.Tensor:\n",
        "def reference_points(cfg: dict, device) -> torch.Tensor:\n"
        + IMPORTS[how])
    if how == "helper":
        text += "\n\ndef _helper():\n    from repro_torch import kernels\n"
    (tmp_path / "scenes").mkdir()
    (tmp_path / "scenes" / "bad.py").write_text(text)
    assert scene.reference_imports(tmp_path / "scenes" / "bad.py") == \
        ["repro_torch"]
    cell = types.SimpleNamespace(bench=tmp_path, spec={"config": "bad"})
    with pytest.raises(ImportError, match="repro_torch"):
        scene.source(cell)


def test_program_side_may_import_the_program():
    assert "repro_torch" in (FIXTURE / "scenes" / "wavy_shell.py").read_text()
    assert scene.reference_imports(FIXTURE / "scenes" / "wavy_shell.py") == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the slab extraction at R = 1024")
    return torch.device("cuda")


@pytest.mark.cuda
def test_slab_crossings_on_the_card(card):
    """rayleigh_taylor at R = 1024 in 64-plane slabs: the whole field's
    crossings bit for bit (1,759,336 on the card, whose sine differs from
    the host's in the last bits), under a quarter of its device peak."""
    res, name = 1024, "rayleigh_taylor"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    whole = fields.crossings(fields.make_field(name, res, card))
    torch.cuda.synchronize()
    dense_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fields.crossings_by_slab(
        lambda lo, hi: fields.make_field(name, res, card, lo, hi), res, 0.0,
        64)
    torch.cuda.synchronize()
    slab_peak = torch.cuda.max_memory_allocated() - base
    print(f"{torch.cuda.get_device_name(0)}: {whole.shape[0]} crossings; "
          f"device peak whole {dense_peak} B, 64-plane slabs {slab_peak} B "
          f"({slab_peak / dense_peak:.4f} of it)", flush=True)
    assert whole.shape[0] == 1_759_336
    assert torch.equal(got, whole)
    assert slab_peak < dense_peak / 4
