"""The readers of the clocked hour's split (benchmark/unit_clock.py) on
each cell at a small box on the CPU, traced: the cell's metrics add up to
that hour's wall."""

import pytest

from benchmark import unit_clock
from benchmark.tests.conftest import cpu_run, small_copy

SPLIT = {"assemble_unit_s_per_sim_hour", "solve_unit_s_per_sim_hour",
         "step_unit_s_per_sim_hour", "machine_control_s_per_sim_hour",
         "between_launches_s_per_sim_hour"}
HEAT = {"heat_sweep_unit_s_per_sim_hour", "heat_assemble_unit_s_per_sim_hour"}


@pytest.mark.parametrize("cell,names", [("water_storm", SPLIT),
                                        ("coupled_storm", SPLIT | HEAT)])
def test_the_split_adds_up_to_the_clocked_hour(tmp_path, monkeypatch, cell, names):
    root = small_copy(tmp_path, box=16)
    seen = []
    measured = unit_clock.split

    def keep(run):
        seen.append(measured(run))
        return seen[-1]
    monkeypatch.setattr(unit_clock, "split", keep)
    rc, result = cpu_run(root, cell, seed=2**31 + 9, trace=True)
    assert rc == 0 and result["correct"], result
    got = {k: v["value"] for k, v in result["metrics"].items() if k in SPLIT | HEAT}
    assert set(got) == names
    split = seen[-1]
    assert all(s is split for s in seen)
    assert all(v >= 0.0 for k, v in got.items() if k != "between_launches_s_per_sim_hour")
    assert got["assemble_unit_s_per_sim_hour"] > 0 and got["solve_unit_s_per_sim_hour"] > 0
    if HEAT <= names:
        assert got["heat_sweep_unit_s_per_sim_hour"] > 0
    assert sum(got.values()) * split["sim_hours"] == pytest.approx(split["wall_s"], rel=1e-6)
