"""A configuration that lays its catchment over cards (``mesh``),
rehearsed on the CPU: the mesh's four blocks each run by its own machine,
so the port's rounds driver runs them as threads, as it runs the cards.
The cell is added as a later change adds one, by a configuration file and
entries alone; it is correct end to end through ``harness.run``, and not
correct with its timed path broken. A configuration without a mesh builds
none and calls the port as before; the fullest card's peak is the one
reported."""

import json
import os

import pytest
import torch

from benchmark import harness, spec
from benchmark.catchment import catchment_dem
from benchmark.system import System
from benchmark.tests.conftest import cpu_run, small_copy
from benchmark.tests.test_benchmark_reference import _broken
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.parallel import sharding

MESH_CELL = "coupled_storm_mesh"
# the rehearsal's box: 2 x 2 blocks of 24 cells a side (at 16 the rings'
# exchange left out moves no owned cell within the hour)
BOX = 48
COUNTERS = ("inner_iters_per_sim_hour", "heat_sweeps_per_sim_hour", "host_reads_per_sim_hour")


def mesh_copy(tmp_path) -> str:
    """A small copy of the benchmark with a four-card cell added as files
    and entries: the coupled configuration laid over a 2 x 2 mesh, one
    block a card, its storm hour, the end-to-end metrics and the
    counters."""
    root = small_copy(tmp_path, box=BOX)
    folder = os.path.join(root, "benchmark", "configs")
    with open(os.path.join(folder, "ravone768_coupled.json")) as f:
        config = json.load(f)
    config.update(name="mesh_coupled", mesh={"cards": 4})
    with open(os.path.join(folder, "mesh_coupled.json"), "w") as f:
        json.dump(config, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][1], name="mesh_coupled",
                             file="benchmark/configs/mesh_coupled.json"))
    b["workloads"].append({"name": MESH_CELL, "config": "mesh_coupled",
                           "traffic": "storm_hour", "chips": 4, "why": "a test's cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if m["name"] in ("s_per_sim_hour",) + COUNTERS:
            m["workloads"].append(MESH_CELL)
    with open(path, "w") as f:
        json.dump(b, f)
    return root


def test_the_mesh_cell_runs_in_rounds_and_is_correct(tmp_path):
    root = mesh_copy(tmp_path)
    cell = spec.cell(MESH_CELL, root)
    assert cell.chips == 4 and set(cell.per_layer) == set(COUNTERS)
    rc, result = cpu_run(root, MESH_CELL, seed=2**31 + 17, trace=True)
    assert rc == 0 and result["correct"], result
    assert result["device"]["count"] == 4 and result["failed"] == 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(m) == set(COUNTERS)
    assert m["heat_sweeps_per_sim_hour"] > 0
    assert all(v["value"] <= v["limit"] for v in result["checks"].values())


@pytest.mark.parametrize("fault", ["altered", "no_exchange"])
def test_a_broken_mesh_cell_is_not_correct(tmp_path, monkeypatch, fault):
    """The run's own verdict with the timed path broken: the exchange
    between the cards' blocks left out, and one answer altered where it is
    produced (in the blocks joined for the comparison). The other faults'
    comparison is the one-card cells' (test_benchmark_reference.py)."""
    root = mesh_copy(tmp_path)
    _broken(monkeypatch, fault)
    rc, result = cpu_run(root, MESH_CELL, seed=23)
    assert rc == 0 and result["correct"] is False, result["checks"]


def test_the_system_lays_the_mesh_cell_over_four_machines(tmp_path):
    c = spec.cell(MESH_CELL, mesh_copy(tmp_path))
    system = System(c.config, c.traffic, catchment_dem(c.config, 1), torch.device("cpu"))
    assert system.params.mesh is system.mesh
    assert system.mesh.shape == {"row": 2, "col": 2}
    assert len(sharding.machine_groups(system.mesh)) == 4
    assert system.devices == [torch.device("cpu")]
    grid = system.inputs[0]
    assert isinstance(grid, sharding.Blocked) and isinstance(grid.blocks[1, 1], Grid)
    assert system.shape == (7, BOX, BOX)


@pytest.mark.parametrize("cell", ["water_storm", "coupled_storm"])
def test_a_config_without_mesh_builds_none_and_calls_as_before(tmp_path, monkeypatch, cell):
    """No mesh is made and nothing is cut; the period gets the whole grid
    and parameters without a mesh, as before configurations had meshes."""
    import benchmark.system as S

    def refuse(*a, **k):
        raise AssertionError("a configuration without mesh made a mesh")
    monkeypatch.setattr(S.sharding, "make_mesh", refuse)
    monkeypatch.setattr(S.sharding, "shard_pytree", refuse)
    seen = []

    def recording(fn):
        def call(grid, params, *rest):
            seen.append((grid, params))
            return fn(grid, params, *rest)
        return call
    monkeypatch.setattr(S, "compute_period_stats", recording(S.compute_period_stats))
    monkeypatch.setattr(S.C, "compute_period_coupled", recording(S.C.compute_period_coupled))
    c = spec.cell(cell, small_copy(tmp_path, box=12))
    system = System(c.config, c.traffic, catchment_dem(c.config, 1), torch.device("cpu"))
    assert system.mesh is None and system.params.mesh is None
    assert system.devices == [torch.device("cpu")]
    system.capture()
    system.hour()
    assert len(seen) == 2 and all(isinstance(g, Grid) and g is system.inputs[0]
                                  and p is system.params for g, p in seen)


def test_the_fullest_cards_peak_is_reported():
    r = harness.Run(cell=None, system=None, on_card=True, power_limit="700.00 W")
    r.peaks = [3 * 2**30, 7 * 2**30, 5 * 2**30, 2**30]
    assert r.peak_bytes == 7 * 2**30
    assert spec.reader("device_peak_gib").read(r) == 7.0
    r.peaks = []
    assert r.peak_bytes == 0

