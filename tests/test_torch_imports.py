"""Import hygiene of the PyTorch port: no module of ``src/repro_torch``,
and not ``chip_smoke.py``, ``tools/torch_kernel_ab.py`` or the rank-side
test helpers ``tests/_torch_dist*.py`` (the gloo ranks must never load
JAX), imports JAX or anything of the JAX package ``repro`` (parsed with
``ast``, so nothing is imported to check)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_kernel_ab.py"] \
    + sorted((ROOT / "tests").glob("_torch_dist*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_the_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/core/serving.py" in names
    assert "src/repro_torch/kernels/rasterize.py" in names
    for mod in ("core/distributed.py", "launch/mesh.py", "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names
    assert "tests/_torch_dist_ranks.py" in names
    assert "chip_smoke.py" in names


def test_checker_flags_what_it_must():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("repro") and forbidden("repro.core.render")
    assert not forbidden("repro_torch.core.render")
    assert not forbidden("torch") and not forbidden("numpy")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(m for m in imported_modules(path) if forbidden(m))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
