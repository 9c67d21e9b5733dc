"""The control fails where the program passes: the plain reference with
its products in TF32 (the precision below the configurations' float32),
put in the program's place on the states a small run on the CPU produced,
reads an energy gap above each cell's limit, on three seeds."""

import pytest

from benchmark.calibrate import calibrate
from benchmark.tests.test_bench_faults import small_cell


@pytest.mark.parametrize("cell", ["srtio3_1x1_filtered", "lamno3_1x1_rigid", "srtio3_2x2_delta"])
def test_control_fails_the_limit(cell):
    wl, seed = small_cell(cell)
    out = calibrate(wl, [seed, seed + 1, seed + 2], 0.0, "cpu")
    limit = wl["limits"]["energy_gap_ev"]
    for run in out["runs"]:
        assert run["energy_gap_ev"] <= limit < run["control_energy_gap_ev"], run
