"""The plain reference and the comparison that decides ``correct``: the
reference against a small hour checked by hand, the port against the
reference, and the run's verdict with the timed path broken underneath."""

import dataclasses

import pytest
import torch

from benchmark import spec
from benchmark.catchment import catchment_dem
from benchmark.reference import storm
from benchmark.tests.conftest import cpu_run, small_copy


def test_reference_hour_by_hand(tmp_path):
    """A 12-box storm hour of the reference: the period's sink is the rain
    counted by hand (20 mm/h on each valid surface cell of 16 m2) plus the
    boundary's outflow, and the water stored (theta x volume in the soil,
    the ponded depth x area on the surface, from the heads and saturation)
    grows by that sink to within 2e-3 of the rain."""
    from benchmark.reference.solver.step import compute_period_stats
    c = spec.cell("water_storm", small_copy(tmp_path, box=12))
    params = storm.reference_params(c.config)
    g, w0 = storm.storm_inputs(c.config, c.traffic, catchment_dem(c.config, 0),
                               torch.device("cpu"), params)
    w1, stats = compute_period_stats(g, params, w0, 3600.0)
    rain = 0.020 * 16.0 * int(g.mask[0].sum())
    sink = float(w1.balance_whole.sink_source)
    # the rain's rate enters the float32 assembly: 1e-6
    assert sink == pytest.approx(rain + float(w1.boundary_flow_sum.sum()), rel=1e-6)

    def stored(w):
        m = g.mask.double()
        theta = g.soil.theta_r + w.se * (g.soil.theta_s - g.soil.theta_r)
        surface = torch.clamp_min(w.h[0] - g.z[0], 0.0) * g.area * m[0]
        return float((theta * g.volume * m)[1:].sum() + surface.sum())

    assert abs(stored(w1) - stored(w0) - sink) <= 2e-3 * rain
    assert abs(float(w1.balance_whole.mbr)) < 2e-3 and stats[0] > 0
    # the water the heads hold, counted again from the heads alone: the
    # storage the period reports, and the hand count to float32 rounding
    held = storm.storage_of(c.config, g, w1.h)
    assert held == float(w1.balance_current.storage)
    assert held == pytest.approx(stored(w1), rel=1e-6)
    # one unsaturated node's head 0.5 m higher holds more water
    node = tuple(torch.nonzero(g.mask[1:] & (w1.h[1:] < g.z[1:] - 0.6))[0] + torch.tensor([1, 0, 0]))
    h = w1.h.clone()
    h[node] += 0.5
    assert storm.storage_of(c.config, g, h) - held > 1e-3


@pytest.mark.parametrize("cell", ["water_storm", "coupled_storm"])
def test_port_equals_reference_on_the_cpu(tmp_path, cell):
    """The program's hour and the reference's on a 16 box: every gap 0."""
    from benchmark import check
    from benchmark.system import System
    c = spec.cell(cell, small_copy(tmp_path, box=16))
    dem = catchment_dem(c.config, 6)
    system = System(c.config, c.traffic, dem, torch.device("cpu"))
    system.capture()
    rec, out = system.hour()
    program = system.outputs(out)
    ref = storm.run_period(c.config, c.traffic, dem, "cpu")
    assert rec["stats"] == ref["stats"] and program["storage"] == ref["storage"]
    storage = storm.storage_of(c.config, ref.pop("grid"), program["h"])
    assert all(v == 0.0 for v in check.gaps(program, ref, storage).values())


@pytest.mark.parametrize("cell", ["water_storm", "coupled_storm"])
def test_control_departs_from_the_reference(tmp_path, cell):
    """The control (the float64 accumulations in float32) on a 16 box: the
    storage it reports departs from the water its heads hold, and its
    heads from the reference's, where the program's gaps are 0 (the test
    above). On the card at the cell's size its readings set the limits'
    upper ends (PERF.md)."""
    from benchmark import check
    c = spec.cell(cell, small_copy(tmp_path, box=16))
    dem = catchment_dem(c.config, 6)
    ref = storm.run_period(c.config, c.traffic, dem, "cpu")
    control = storm.run_period(c.config, c.traffic, dem, "cpu", lowered=True)
    g = check.gaps(control, ref, storm.storage_of(c.config, control["grid"], control["h"]))
    assert g["storage_gap_m3"] > 0.0 and g["h_p99_m"] > 0.0


@pytest.mark.parametrize("cell", ["water_storm", "coupled_storm"])
def test_soil_as_a_view_changes_no_bit(tmp_path, monkeypatch, cell):
    """The reference keeps its uniform soil as one value a cell, viewed
    over the layers (and the unused prescribed heads as one zero): on a 20
    box its hour, its control and its count of the heads' water equal, bit
    for bit, those of the grid with every field held a node."""
    from benchmark.reference.device import map_tensors
    c = spec.cell(cell, small_copy(tmp_path, box=20))
    dem = catchment_dem(c.config, 4)
    built = storm.catchment_grid

    def per_node(config, d, device):
        g = built(config, d, device)
        assert g.soil.k_sat.stride(0) == 0 and g.prescribed_h.stride(0) == 0
        return dataclasses.replace(g, soil=map_tensors(g.soil, lambda t: t.contiguous()),
                                   prescribed_h=g.prescribed_h.contiguous())

    runs = []
    for grid_of in (built, per_node):
        monkeypatch.setattr(storm, "catchment_grid", grid_of)
        ref = storm.run_period(c.config, c.traffic, dem, "cpu")
        ref.pop("grid")
        control = storm.run_period(c.config, c.traffic, dem, "cpu", lowered=True)
        runs.append((ref, control, storm.storage_of(c.config, control.pop("grid"),
                                                    control["h"])))
    (ref, control, held), (ref0, control0, held0) = runs
    assert held == held0
    for a, b in ((ref, ref0), (control, control0)):
        assert a.keys() == b.keys()
        for k in a:
            same = torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
            assert same, k


@pytest.mark.parametrize("box", [12, 20])
@pytest.mark.parametrize("cell", ["water_storm", "coupled_storm"])
def test_the_count_on_the_references_own_grid_is_the_rebuilt_grids(tmp_path, cell, box):
    """The heads' water counted on the grid the reference period ran on
    (with soil heat, its surface made HeatSurface nodes) equals, bit for
    bit, the count on the grid built again from the DEM: for the
    reference's heads, the control's and a program's heads moved off
    them."""
    c = spec.cell(cell, small_copy(tmp_path, box=box))
    dem = catchment_dem(c.config, 2)
    rebuilt = storm.catchment_grid(c.config, dem, torch.device("cpu"))
    for lowered in (False, True):
        run = storm.run_period(c.config, c.traffic, dem, "cpu", lowered=lowered)
        grid = run.pop("grid")
        assert grid.shape == rebuilt.shape
        moved = run["h"] + torch.linspace(-0.3, 0.3, run["h"].numel(),
                                          dtype=torch.float64).reshape(run["h"].shape)
        for h in (run["h"], moved):
            own = storm.storage_of(c.config, grid, h)
            assert own == storm.storage_of(c.config, rebuilt, h)
        if not lowered:
            assert own != storm.storage_of(c.config, grid, run["h"])
            assert storm.storage_of(c.config, grid, run["h"]) == run["storage"]


def _broken(monkeypatch, fault: str):
    """The timed path broken underneath the harness (the port's period as
    the system calls it). On a mesh the faults other than ``unchanged``
    work on the period's output joined by the port's ``gather_pytree``;
    ``no_exchange`` leaves out the rings' exchange between the machines of
    a mesh (each block keeps the rings it had)."""
    import numpy as np

    import benchmark.system as S
    from criteria3d_tpu_torch.parallel import sharding
    step, coupled = S.compute_period_stats, S.C.compute_period_coupled
    if fault == "no_exchange":
        def stale(join, x):
            out = np.empty(x.blocks.shape, dtype=object)
            for idx in join.groups[join.g]:
                out[idx] = x.blocks[idx].clone()
            return sharding.Blocked(x.mesh, out)
        monkeypatch.setattr(sharding.Join, "_grown", stale)
        return

    def whole(x):
        blocked = isinstance(getattr(x, "h", x), sharding.Blocked)
        return sharding.gather_pytree(x) if blocked else x

    def unchanged_water(grid, params, state, seconds):
        out, stats = step(grid, params, state, seconds)
        return (state if seconds > 0 else out), stats

    def unchanged_coupled(grid, params, water, heat, boundary, seconds):
        out = coupled(grid, params, water, heat, boundary, seconds)
        return (water, heat) if seconds > 0 else out

    def half(state, start):
        """Half of the grid's rows left at their initial heads."""
        state, start = whole(state), whole(start)
        h = state.h.clone()
        rows = h.shape[-2] // 2
        h[..., rows:, :] = start.h[..., rows:, :]
        return dataclasses.replace(state, h=h)

    def half_water(grid, params, state, seconds):
        out, stats = step(grid, params, state, seconds)
        return half(out, state), stats

    def half_coupled(grid, params, water, heat, boundary, seconds):
        w, h = coupled(grid, params, water, heat, boundary, seconds)
        return half(w, water), h

    def altered(state, grid):
        """One valid node's head 0.5 m off where the period produces it."""
        state, grid = whole(state), whole(grid)
        h = state.h.clone()
        nodes = torch.nonzero(grid.mask)
        h[tuple(nodes[len(nodes) // 2])] += 0.5
        return dataclasses.replace(state, h=h)

    def altered_water(grid, params, state, seconds):
        out, stats = step(grid, params, state, seconds)
        return altered(out, grid), stats

    def altered_coupled(grid, params, water, heat, boundary, seconds):
        w, h = coupled(grid, params, water, heat, boundary, seconds)
        return altered(w, grid), h

    water, coupled_fn = {"unchanged": (unchanged_water, unchanged_coupled),
                         "half": (half_water, half_coupled),
                         "altered": (altered_water, altered_coupled)}[fault]
    monkeypatch.setattr(S, "compute_period_stats", water)
    monkeypatch.setattr(S.C, "compute_period_coupled", coupled_fn)


FAULTS = [(cell, fault) for cell in ("water_storm", "coupled_storm")
          for fault in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    """The run's own verdict, the card's look skipped, with the timed path
    broken: a period that returns its state unchanged, half of the grid
    left out, and one answer altered where it is produced."""
    root = small_copy(tmp_path, box=16)
    _broken(monkeypatch, fault)
    rc, result = cpu_run(root, cell, seed=11)
    assert rc == 0 and result["correct"] is False, result["checks"]
