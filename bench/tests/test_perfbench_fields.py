"""The benchmark's frozen fields equal the program's analytic volumes,
and its extraction the program's crossings."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from gsbench import fields  # noqa: E402


@pytest.mark.parametrize("ours,theirs", [("gyroid", "kingsnake"),
                                         ("rayleigh_taylor",
                                          "rayleigh_taylor")])
def test_field_equals_the_program_volume(ours, theirs):
    from repro_torch.data.volumes import make_volume
    want, iso = make_volume(theirs, 32)
    got = fields.make_field(ours, 32, "cpu").numpy()
    assert iso == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_crossings_and_colours_equal_the_program():
    from repro_torch.data.isosurface import crossing_points
    from repro_torch.data.volumes import height_colors
    f = fields.make_field("gyroid", 24, "cpu")
    want = crossing_points(f.numpy(), 0.0)
    got = fields.crossings(f).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fields.height_colors(torch.from_numpy(want))
                               .numpy(), height_colors(want), atol=1e-6)


def test_unknown_field():
    with pytest.raises(ValueError):
        fields.make_field("nothing", 4, "cpu")
