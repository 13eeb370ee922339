"""The state machines' unit clock (solver/device_loop.py ``unit_clock``):
the eager driver's table on the CPU (water and coupled storm hours on a 16
box) against the period's own counts, its layers, the clock's silence on
the results, and the units' track in a trace (utils/telemetry.py); on the
card, the graph driver's table against the period's stats. The card's
test carries the ``cuda`` marker and skips where there is no card; the
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_unit_clock.py
"""

import dataclasses
import json

import pytest
import torch

from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel.sharding import make_mesh, shard_pytree
from criteria3d_tpu_torch.solver import coupled as C
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver.step import _Machine, compute_period_stats
from criteria3d_tpu_torch.utils import telemetry

N = 16
FROZEN = dict(heat_vapor=True, heat_frozen_props=True)


def water_hour(device="cpu"):
    params = SolverParameters.fast_f32()
    grid, water = problems.build_problem(problems.synthetic_catchment(0, n=N, radius=N * 0.45),
                                         4.0, params, device)
    return lambda: compute_period_stats(grid, params, water, 3600.0)


def coupled_hour(device="cpu", period=3600.0):
    params = SolverParameters.fast_f32(**FROZEN)
    grid, water, heat, boundary = problems.coupled_box(params, device, N)

    def run():
        C.reset_counts()
        out = C.compute_period_coupled(grid, params, water, heat, boundary, period)
        return out, C.counts()
    return run


def clocked(run):
    """``run()`` with the clock off and on: both results, host reads and
    the clock."""
    reads = []
    host_read.count = 0
    off = run()
    reads.append(host_read.count)
    host_read.count = 0
    device_loop.reset_counts()
    with device_loop.unit_clock() as clock:
        on = run()
    reads.append(host_read.count)
    return off, on, reads, clock


def assert_table(clock, eager_units=None):
    """One period: every event counted in its unit, inside its launch;
    the launches hold their units."""
    (p,) = clock.periods
    assert p.dropped == 0 and len(p.events) == sum(n for n, _ in p.units.values())
    if eager_units is not None:
        assert len(p.events) == eager_units
    for code, name in p.names.items():
        mine = p.events[p.events[:, 0] == code]
        n, sec = p.units[name]
        assert len(mine) == n
        assert sec == pytest.approx(float((mine[:, 2] - mine[:, 1]).sum()) * 1e-9, rel=1e-12)
    for k, (t0, t1) in enumerate(p.launches):
        mine = p.events[p.events[:, 3] == k]
        assert (mine[:, 1] >= t0).all() and (mine[:, 2] <= t1).all()
        assert (mine[:, 2] >= mine[:, 1]).all()
    assert p.launch_s >= p.units_s and p.control_s >= 0.0
    assert sum(clock.layers().values()) == pytest.approx(p.units_s, rel=1e-12)
    return p


def test_water_hour_table_matches_its_stats():
    (s_off, st_off), (s_on, st_on), reads, clock = clocked(water_hour())
    assert tuple(st_on) == tuple(st_off) and reads[0] == reads[1]
    for f in dataclasses.fields(s_on):
        a, b = getattr(s_off, f.name), getattr(s_on, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    p = assert_table(clock, device_loop.counts()["eager_units"])
    assert p.driver == "eager" and p.n_launches == 1 and p.anchor_ns is None
    assert p.units["solve"][0] == st_on[3]
    assert p.units["assemble"][0] == st_on[2]
    assert p.units["start"][0] == st_on[1]


def test_coupled_hour_table_matches_its_counts():
    ((w_off, h_off), c_off), ((w_on, h_on), c_on), reads, clock = clocked(coupled_hour())
    assert c_on == c_off and reads[0] == reads[1]
    for a, b in ((w_off, w_on), (h_off, h_on)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
    p = assert_table(clock, device_loop.counts()["eager_units"])
    assert p.units["solve"][0] == c_on["inner_iterations"]
    assert p.units["assemble"][0] == c_on["approximations"]
    assert p.units["sweep"][0] == c_on["heat_sweeps"] > 0
    assert p.units["chunk"][0] == c_on["chunks"]
    assert p.units["substep"][0] == c_on["substeps_accepted"] + c_on["substeps_rejected"]
    layers = clock.layers()
    assert set(layers) == set(device_loop.LAYERS)
    assert layers["heat solve"] == pytest.approx(p.units["sweep"][1], rel=1e-12)


def _units(machine) -> set:
    return {name for name, _ in machine.units().values()}


def test_layer_map_sends_every_unit_to_one_layer():
    """Every unit of the water and coupled machines, whole and on a mesh
    whose exchanges are units of their own (per-sweep Jacobi and the heat
    sweeps' rings), exact and frozen heat, lies in exactly one layer, and
    every unit the map names is some machine's."""
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    names = set()
    for params in (SolverParameters.fast_f32(**FROZEN), SolverParameters(heat_vapor=True)):
        grid, water, heat, boundary = problems.coupled_box(params, "cpu", N)
        for m in (None, mesh):
            p = dataclasses.replace(params, mesh=m)
            g, w, h, b = ((grid, water, heat, boundary) if m is None else
                          tuple(shard_pytree(x, m) for x in (grid, water, heat, boundary)))
            names |= _units(_Machine(g, p, w, False))
            names |= _units(C._CoupledMachine(g, p, w, h, b, False, 256))
    assert {"x_exchange", "h_exchange", "rebuild", "sweep"} <= names
    assert set(device_loop.UNIT_LAYERS) <= names
    groups = {layer: {n for n in names if device_loop.layer_of(n) == layer}
              for layer in device_loop.LAYERS}
    assert sum(len(g) for g in groups.values()) == len(names)
    assert groups["water assembly"] == {"assemble"}
    assert groups["inner solve"] == {"solve_init", "solve", "solve_end", "x_exchange"}
    assert groups["heat solve"] == {"sweep", "h_exchange"}
    assert groups["heat assembly"] == {"chunk", "rebuild", "substep"}
    assert "start" in groups["period solver"] and "period_end" in groups["period solver"]


def test_trace_writes_the_unit_track_and_host_spans(tmp_path):
    """telemetry.trace() of an eager coupled period (the hour's first five
    minutes): the c3d.* host ranges carry the period's serial, the units'
    track holds one launch and every unit, placed inside that launch's
    host range."""
    run = coupled_hour(period=300.0)
    with telemetry.trace(str(tmp_path)):
        run()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    host = {e["name"] for e in spans if e["name"].startswith("c3d.")
            and e.get("cat") != "c3d_launch"}
    assert {"c3d.period", "c3d.driver.load", "c3d.driver.launch"} <= host
    period = [e for e in spans if e["name"] == "c3d.period"]
    assert len(period) == 1 and "period" in period[0]["args"]
    serial = period[0]["args"]["period"]
    assert all(e["args"].get("period") == serial for e in spans
               if e["name"].startswith("c3d.driver."))
    track = [e for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e["args"]["name"] == telemetry.UNIT_TRACK]
    assert len(track) == 1
    units = [e for e in spans if e.get("cat") == "c3d_unit"]
    launches = [e for e in spans if e.get("cat") == "c3d_launch"]
    assert len(launches) == 1 and units
    assert all(e["tid"] == track[0]["tid"] and e["args"]["period"] == serial
               for e in units + launches)
    assert {e["name"] for e in units} >= {"assemble", "solve", "sweep", "chunk"}
    assert {e["args"]["layer"] for e in units} == set(device_loop.LAYERS)
    checks = telemetry.unit_track_checks(str(tmp_path / "trace.json"))
    (launch,) = checks["launches"]
    assert launch["period"] == serial and launch["after_launch_us"] >= 0.0
    assert checks["gaps"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["water", "coupled"])
def test_graph_driver_table_matches_the_stats(form):
    """The graph driver's clock on the card: the units' counts are the
    period's, every launch's span holds its units, the clock changes no
    result and no host read, and on or off it captures once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    device_loop.clear()
    run = water_hour("cuda") if form == "water" else coupled_hour("cuda")
    run()
    off, on, reads, clock = clocked(run)
    # clocked() counts from 0 before its clocked run
    assert reads[0] == reads[1] and device_loop.counts()["captures"] == 0
    (p,) = clock.periods
    assert p.driver == "graph" and p.clock == "device" and p.dropped == 0
    if form == "water":
        (s_off, st_off), (s_on, stats) = off, on
        assert tuple(stats) == tuple(st_off) and torch.equal(s_off.h, s_on.h)
        inner, approx = stats[3], stats[2]
    else:
        ((w_off, _), c_off), ((w_on, _), c) = off, on
        assert c == c_off and torch.equal(w_off.h, w_on.h)
        inner, approx = c["inner_iterations"], c["approximations"]
        assert p.units["sweep"][0] == c["heat_sweeps"]
    assert p.units["solve"][0] == inner and p.units["assemble"][0] == approx
    assert p.n_launches == len(p.launches) == device_loop.counts()["launches"]
    assert_table(clock)
    device_loop.clear()
