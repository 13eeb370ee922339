"""The port's measurement entry points against the repository's bench.py
and the JAX package: ``criteria3d_tpu_torch.bench`` (coarsening, the result
line's keys, the storm, day, coupled and mesh legs), ``ab_legs`` (the eager
legs of two checkouts in turns), the pure roll-up of
``utils/profiling.py``, and the rule that no entry point falls back to the
CPU.

The JAX side follows bench.py's recipe (bench.py:66-89 for the grid,
:120-127 for the storm's initial state, :226-282 for the coupled leg).
bench.py itself is imported only in a subprocess: importing it sets JAX's
compilation-cache directory for the whole process.
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import BoundaryType as JBT
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver.coupled import compute_period_coupled as j_period_coupled
from criteria3d_tpu.solver.step import compute_period_stats as j_period_stats
from criteria3d_tpu.solver.step import initialize_balance as j_initialize_balance
from criteria3d_tpu_torch import bench, problems, trace_coupled
from criteria3d_tpu_torch.io.esri import RasterHeader, write_flt
from criteria3d_tpu_torch.utils.profiling import roll_up

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic(n: int) -> np.ndarray:
    """The seed-0 synthetic catchment cut to an n box, in float32 values
    (an ESRI .flt holds float32)."""
    dem = problems.synthetic_catchment(0, n=n, radius=n * 366.0 / 768)
    return dem.astype(np.float32).astype(np.float64)


def dem_of(n: int) -> bench.Dem:
    return bench.Dem(synthetic(n), -9999.0, 4.0, "synthetic_catchment(seed=0)")


def jax_grid(dem: np.ndarray, cell: float):
    """bench.py:83-88's grid on an already coarsened DEM."""
    soil = J.SoilFields.uniform(dem.shape, vg_alpha=1.0, vg_n=1.35, vg_he=0.02,
                                theta_s=0.44, theta_r=0.06, k_sat=2e-6)
    return J.Grid.build(dem, cell, soil, total_depth=0.8, min_thickness=0.04,
                        max_thickness=0.25, max_thickness_depth=0.6)


def jax_storm_state(g, p):
    """bench.py:120-127's init_state."""
    state = j_initialize_balance(g, p, J.WaterState.initialize(g, p, matric_potential=-2.0))
    rain = 0.020 * g.area / 3600.0
    sink = jnp.zeros_like(state.sink_source).at[0].set(jnp.where(g.mask[0], rain, 0.0))
    return dataclasses.replace(state, sink_source=sink)


def bench_result_keys() -> set:
    """Every key of bench.py's ``result``: the dict literal's and those
    assigned to ``result[...]`` after it, read from bench.py's AST."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "result" and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "result" and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


# ----------------------------------------------------------------------
# (a) coarsening and the grid
# ----------------------------------------------------------------------

JAX_BUILD = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
import criteria3d_tpu.io.esri as esri
dem = np.load({dem!r})
hdr = esri.RasterHeader(nrows=dem.shape[0], ncols=dem.shape[1], xllcorner=0.0,
                        yllcorner=0.0, cellsize=4.0, nodata=-9999.0)
esri.read_flt = lambda path: (dem.copy(), hdr)
import bench
for c in (2, 4):
    g = bench.build_grid(c)
    np.savez({out!r} + f"_{{c}}.npz", z=np.asarray(g.z), mask=np.asarray(g.mask),
             n_nodes=g.n_nodes, cell=float(g.cell_size))
"""


def test_coarsen_and_grid_match_bench_py(tmp_path, monkeypatch):
    """bench.py's build_grid (run in a subprocess, its read_flt returning a
    64-box synthetic catchment) against the port's: the DEM written as an
    ESRI raster at RAVONE is read back by ``load_dem`` as Ravone, and
    ``build_grid`` at coarsen 2 and 4 gives z, mask and node count bit-equal
    (and the cell size); ``coarsen_dem`` of the synthetic catchment keeps
    its nodata where at most half a block is valid."""
    dem = synthetic(64)
    np.save(tmp_path / "dem.npy", dem)
    out = str(tmp_path / "jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", JAX_BUILD.format(
        repo=REPO, dem=str(tmp_path / "dem.npy"), out=out)], capture_output=True,
        text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    write_flt(str(tmp_path / "ravone.flt"), dem, RasterHeader(
        nrows=64, ncols=64, xllcorner=0.0, yllcorner=0.0, cellsize=4.0, nodata=-9999.0))
    monkeypatch.setattr(bench, "RAVONE", str(tmp_path / "ravone.flt"))
    ravone = bench.load_dem()
    assert ravone.name == "ravone" and ravone.cell == 4.0 and ravone.nodata == -9999.0
    assert np.array_equal(ravone.values, dem)
    for c in (2, 4):
        ref = np.load(f"{out}_{c}.npz")
        g = bench.build_grid(c, "cpu", ravone)
        assert g.n_nodes == int(ref["n_nodes"]) and g.cell_size == float(ref["cell"])
        assert np.array_equal(g.mask.numpy(), ref["mask"])
        assert np.array_equal(g.z.numpy(), ref["z"])
        coarse = bench.coarsen_dem(dem, -9999.0, c)
        assert coarse.shape == (64 // c, 64 // c)
        assert np.array_equal(coarse == -9999.0, ~ref["mask"][0])
    assert bench.coarsen_dem(dem, -9999.0, 1) is dem


# ----------------------------------------------------------------------
# (b) the result line and the environment
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def line16():
    """The whole line on a 16 box on the CPU, every leg, the day at
    coarsen 2 cut to 2 hours (test_day_leg_matches_jax holds the day)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "day_leg", functools.partial(bench.day_leg, hours=2,
                                                       storm_hours=1))
        return bench.bench({"BENCH_DAY_COARSEN": "2"}, "cpu", dem_of(16))


def test_line_holds_every_bench_py_key(line16):
    """The port's line holds every key of bench.py's result (read from its
    AST), with platform "cpu" here and the synthetic DEM named; the legs'
    counts are there and the ratios follow from the walls."""
    keys = bench_result_keys()
    assert len(keys) >= 30 and "pallas_sweeps_per_hour" in keys
    assert keys <= set(line16), keys - set(line16)
    assert line16["platform"] == "cpu" and line16["dem"] == "synthetic_catchment(seed=0)"
    assert line16["vs_baseline"] is None and line16["reference_cpu_wall_s"] is None
    assert line16["value"] == pytest.approx(np.median(line16["runs_s"]))
    assert line16["coupled_vs_water_ratio"] == pytest.approx(
        line16["coupled_heat_wall_s"] / line16["value"])
    assert line16["sim_day_coarsen"] == 2 and len(line16["sim_day_hour_walls_s"]) == 2
    assert line16["pallas_sweeps_per_hour"] == line16["pallas_stats"][3] > 0
    assert line16["pallas_mesh"] == [1, 1]
    assert set(line16["peak_memory_gib"]) == {"storm", "day", "coupled", "pallas"}
    json.dumps(line16)


@pytest.mark.parametrize("env,want", [
    ({}, dict(use_pallas=False, inner_solver="cg", cg_precond="line", fast=True)),
    ({"BENCH_PALLAS": "1"}, dict(use_pallas=True, inner_solver="jacobi", fast=True)),
    ({"BENCH_CG": "0"}, dict(use_pallas=False, inner_solver="jacobi", fast=True)),
    ({"BENCH_CG_PRECOND": "diag"}, dict(inner_solver="cg", cg_precond="diag", fast=True)),
    ({"BENCH_MODE": "ref"}, dict(use_pallas=False, inner_solver="cg", fast=False)),
])
def test_storm_params_read_bench_py_variables(env, want):
    """The storm leg's parameters from bench.py's variables, as bench.py
    builds them with the JAX package's presets."""
    p = bench.storm_params(env)
    use_pallas = env.get("BENCH_PALLAS", "0") == "1"
    inner = "jacobi" if (use_pallas or env.get("BENCH_CG", "1") != "1") else "cg"
    jp = (J.SolverParameters.fast_f32(use_pallas=use_pallas, inner_solver=inner,
                                      cg_precond=env.get("BENCH_CG_PRECOND", "line"))
          if want.pop("fast") else J.SolverParameters(inner_solver=inner))
    for k, v in want.items():
        assert getattr(p, k) == getattr(jp, k) == v, k
    assert str(p.dtype).removeprefix("torch.") == np.dtype(jp.dtype).name
    assert (p.sweep_dtype is None) == (jp.sweep_dtype is None)


def test_sample_follows_bench_py_rule(monkeypatch):
    """Up to max_runs, stop once the two fastest are within 5 %, or after a
    run past long_s (never after the first); the median of the walls and
    the last run's result."""
    now = [0.0]
    monkeypatch.setattr(bench.time, "perf_counter", lambda: now[0])

    def runs_of(walls, max_runs, long_s=None):
        it = iter(walls)

        def run():
            w = next(it)
            now[0] += w
            return w
        return bench.sample(run, torch.device("cpu"), max_runs, long_s)

    # walls exact in binary, so the clock's differences are too
    assert runs_of([4.0, 2.0, 2.0625], 5) == ([4.0, 2.0, 2.0625], 2.0625, 2.0625)
    assert runs_of([70.0, 80.0, 1.0], 5, 60.0) == ([70.0, 80.0], 75.0, 80.0)
    assert runs_of([64.0, 1.0, 1.03125], 5, 60.0)[0] == [64.0, 1.0, 1.03125]
    assert runs_of([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], 5)[0] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert runs_of([1.0, 2.0, 3.0, 4.0], 3)[1] == 2.0


# ----------------------------------------------------------------------
# (c)-(f) the legs against JAX and against the port's one device
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["f64", "cg_line"])
def test_storm_leg_matches_jax(mode):
    """The storm leg on a 32 box against JAX's compute_period_stats on
    bench.py's problem: float64 (BENCH_MODE=ref: CG on the f64 path) equal
    stats, h 1e-9 m, MBR 1e-9; the CG line (fast_f32()) equal stats, h
    1e-4 m, MBR 1e-6 (PERF.md section 2's float32 bars)."""
    env = {"BENCH_MODE": "ref"} if mode == "f64" else {}
    d = dem_of(32)
    tg = bench.build_grid(1, "cpu", d)
    tp = bench.storm_params(env)
    leg = bench.storm_leg(tg, tp)
    jg = jax_grid(d.values, 4.0)
    jp = (J.SolverParameters(inner_solver="cg") if mode == "f64"
          else J.SolverParameters.fast_f32())
    jout, jstats = j_period_stats(jg, jp, jax_storm_state(jg, jp), 3600.0)
    jstats = tuple(int(s) for s in jstats)
    dh = float(np.abs(leg["out"].h.numpy() - np.asarray(jout.h)).max())
    mbr_j = float(jout.balance_whole.mbr)
    print(f"{mode}: port {leg['stats']} jax {jstats} max|dh| {dh} MBR {leg['mbr']} {mbr_j}")
    h_tol, mbr_tol = (1e-9, 1e-9) if mode == "f64" else (1e-4, 1e-6)
    assert leg["stats"] == jstats and leg["launches"] == 0
    assert dh <= h_tol
    assert leg["mbr"] == pytest.approx(mbr_j, abs=mbr_tol)
    assert abs(leg["mbr"]) < 2e-3 and leg["host_reads"] > 0
    assert 1 <= len(leg["runs_s"]) <= 5


def test_day_leg_matches_jax():
    """The day leg on a 16 box, float64, 4 hours with 1 storm hour, against
    the same JAX chain (bench.py:193-212: 6 periods of 600 s an hour, the
    rain zeroed from the storm's end): every period's stats equal, h 1e-9
    m, the closing MBR 1e-9."""
    d = dem_of(16)
    tg = bench.build_grid(1, "cpu", d)
    params = bench.storm_params({"BENCH_MODE": "ref"})
    day = bench.day_leg(tg, params, hours=4, storm_hours=1)
    jg = jax_grid(d.values, 4.0)
    jp = J.SolverParameters(inner_solver="cg")
    js = jax_storm_state(jg, jp)
    jstats = []
    for h in range(4):
        if h == 1:
            js = dataclasses.replace(js, sink_source=jnp.zeros_like(js.sink_source))
        for _ in range(6):
            js, st = j_period_stats(jg, jp, js, 600.0)
            jstats.append(tuple(int(s) for s in st))
    dh = float(np.abs(day["out"].h.numpy() - np.asarray(js.h)).max())
    print(f"day: max|dh| {dh} MBR {day['mbr']} {float(js.balance_whole.mbr)}")
    assert day["stats"] == jstats and len(day["hour_walls_s"]) == 4
    assert len(day["host_reads"]) == 4 and min(day["host_reads"]) > 0
    assert dh <= 1e-9
    assert day["mbr"] == pytest.approx(float(js.balance_whole.mbr), abs=1e-9)


def test_coupled_leg_heat_mbr_matches_jax():
    """The coupled leg's heat MBR on a 16 box, float64 (BENCH_MODE=ref,
    frozen properties as bench.py's default), against bench.py's formula
    (:279-282) applied to JAX's float64 hour of bench.py's coupled problem:
    rel 1e-9; the water MBR 1e-9."""
    env = {"BENCH_MODE": "ref"}
    d = dem_of(16)
    leg = bench.coupled_leg(bench.build_grid(1, "cpu", d), bench.storm_params(env), env)
    jp = J.SolverParameters(inner_solver="cg", heat_vapor=True, heat_frozen_props=True)
    jg = jax_grid(d.values, 4.0)
    jg = dataclasses.replace(
        jg, btype=jg.btype.at[1].set(jnp.where(jg.mask[1], int(JBT.HEAT_SURFACE),
                                               jg.btype[1])),
        bsize=jg.bsize.at[1].set(jnp.where(jg.mask[1], float(jg.area), jg.bsize[1])))
    jw = jax_storm_state(jg, jp)
    jh = JH.initialize_heat(jg, 288.15)
    jh = dataclasses.replace(jh, storage_prev=JH.heat_storage(jg, jp, jh, jw),
                             storage_whole=JH.heat_storage(jg, jp, jh, jw))
    jb = JH.HeatBoundary.uniform(jg.shape[1:], air_temperature=291.15, rel_humidity=85.0,
                                 wind_speed=3.0, net_irradiance=80.0, mask=jg.mask[1])
    jwo, jho = j_period_coupled(jg, jp, jw, jh, jb, 3600.0)
    st_end = JH.heat_storage(jg, jp, jho, jwo)
    mbr_j = float((st_end - jho.storage_whole - jho.sink_whole)
                  / jnp.maximum(jnp.abs(jho.sink_whole), 1.0))
    print(f"coupled: {leg['counts']} heat MBR {leg['heat_mbr']} jax {mbr_j}")
    assert leg["heat_mbr"] == pytest.approx(mbr_j, rel=1e-9)
    assert leg["mbr"] == pytest.approx(float(jwo.balance_whole.mbr), abs=1e-9)
    assert leg["counts"]["heat_sweeps"] > 0 and leg["launches"] == 0


def test_mesh_leg_matches_one_device_bundle_hour():
    """The mesh leg (the bundle hour on a (1, 1) mesh of CPU blocks, one
    tile with an 8-cell ring of zeros on every side) against the port's
    one-device bundle hour on a 16 box: stats and host reads equal, heads
    bit-equal, the same whole-period MBR."""
    g = bench.build_grid(1, "cpu", dem_of(16))
    one = bench.storm_leg(g, bench.storm_params({"BENCH_PALLAS": "1"}))
    ml = bench.mesh_leg(g)
    assert ml["mesh"] == {"row": 1, "col": 1}
    assert ml["stats"] == one["stats"] and ml["host_reads"] == one["host_reads"]
    assert torch.equal(ml["out"].h, one["out"].h)
    assert ml["mbr"] == one["mbr"]


# ----------------------------------------------------------------------
# (g) the profiling arithmetic
# ----------------------------------------------------------------------

def test_ab_legs_alternates_two_checkouts(tmp_path, capsys):
    """``ab_legs`` on the CPU at a 16 box, one pair, against a copy of the
    port's package: the processes alternate (other, this), each line holds
    both legs with the mesh leg's stats and equal host reads in the two
    checkouts, and the summary holds each checkout's walls."""
    import shutil
    from criteria3d_tpu_torch import ab_legs
    other = tmp_path / "other"
    shutil.copytree(os.path.join(REPO, "criteria3d_tpu_torch"),
                    other / "criteria3d_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    assert ab_legs.main([str(other), "--pairs", "1", "--n", "16", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [x["root"] for x in lines[:2]] == [str(other), ab_legs.THIS_ROOT]
    assert lines[0]["mesh"]["stats"] == lines[1]["mesh"]["stats"]
    assert lines[0]["mesh"]["stats"][0] > 0
    assert lines[0]["coupled"]["reads"] == lines[1]["coupled"]["reads"] > 0
    summary = lines[2]
    for leg in ("coupled", "mesh"):
        assert len(summary[leg]["other_walls"]) == len(summary[leg]["this_walls"]) == 1
        assert summary[leg]["this_over_other"] > 0


def test_roll_up_by_hand():
    """roll_up on a hand-made run: busy is the union of the spans (an
    overlap counted once, a gap left out), the idle share 1 - busy / wall,
    each activity charged to the innermost range open at its launch (after
    an inner range closes the outer one takes it again), else to "other",
    an overlap to the activity that started first, so the layers sum to
    busy; per-name seconds and counts."""
    ranges = [(0, 100, "outer"), (10, 20, "inner"), (30, 40, "inner"), (200, 300, "solo")]
    launches = {1: 5, 2: 15, 3: 25, 4: 35, 5: 150, 6: 250, 7: 20}
    device = [(1000, 1010, "k_a", 1), (1010, 1030, "k_b", 2), (1030, 1040, "k_a", 3),
              (1040, 1045, "k_c", 4), (1100, 1120, "k_a", 5), (1115, 1125, "k_b", 6),
              (1200, 1201, "k_c", 7), (1300, 1310, "k_d", 99)]
    r = roll_up(device, launches, ranges, wall_s=1e-6)
    assert r.busy_s == pytest.approx((45 + 25 + 1 + 10) * 1e-9, rel=1e-12)
    assert r.idle_share == pytest.approx(1.0 - r.busy_s / 1e-6, rel=1e-12)
    assert r.layers == pytest.approx({"outer": 20e-9, "inner": 26e-9, "other": 30e-9,
                                      "solo": 5e-9}, rel=1e-12)
    assert r.per_name["k_a"] == pytest.approx((40e-9, 3)) and r.per_name["k_d"][1] == 1
    assert r.matched and r.n == 8
    assert sum(r.layers.values()) == pytest.approx(r.busy_s, rel=1e-12)
    assert r.overlap_s == pytest.approx(5e-9, rel=1e-12)
    empty = roll_up([], {}, ranges)
    assert empty.busy_s == 0.0 and empty.idle_share is None and not empty.matched


def test_profile_and_trace_run_on_the_cpu():
    """trace_coupled on a 16 box on the CPU: the trace's counts are the
    coupled step's and, with no device activity on the CPU, its layers and
    busy time are 0."""
    d = dem_of(16)
    tr = trace_coupled.trace(1, "cpu", d)
    assert tr["counts"]["heat_sweeps"] > 0 and tr["host_reads"] > 0
    assert tr["busy_s"] == 0.0 and sum(tr["layers"].values()) == 0.0
    assert set(tr["layers"]) == set(trace_coupled.LAYERS) | {"other"}


# ----------------------------------------------------------------------
# (h) no fallback
# ----------------------------------------------------------------------

def test_entry_points_refuse_without_a_card(monkeypatch, capsys):
    """Without a card bench and trace_coupled exit non-zero with
    resolve_device's message and run no leg on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kw):
        raise AssertionError("a leg ran without a card")
    for mod, name in ((bench, "bench"), (bench, "build_grid"), (trace_coupled, "trace")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(sys, "argv", ["x"])
    for mod in (bench, trace_coupled):
        assert mod.main() == 2
        assert "no CUDA device" in capsys.readouterr().err
