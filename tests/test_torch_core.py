"""The PyTorch port's data model against the JAX package: grid build, the
initial state, carrying state across, and the port's import and device
rules.

Both implementations get the same numpy inputs; the port runs on the CPU
(``device="cpu"``). The helpers here turn JAX objects into the plain arrays
``criteria3d_tpu_torch.convert`` takes and are shared by the other
``test_torch_*`` files.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver.step import initialize_balance as j_initialize_balance
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert, problems
from criteria3d_tpu_torch.project import Criteria3DProject
from criteria3d_tpu_torch.solver.step import (
    initialize_balance as t_initialize_balance)
from tests.test_catchment3d import valley_dem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOIL = dict(vg_alpha=1.2, vg_n=1.5, vg_he=0.02, theta_s=0.41, theta_r=0.04,
            k_sat=5e-6)


# ----------------------------------------------------------------------
# shared helpers
# ----------------------------------------------------------------------

def to_arrays(obj) -> dict:
    """Every field of a JAX dataclass as numpy arrays (nested dataclasses
    as nested dicts); static fields are left out."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.metadata.get("static"):
            continue
        v = getattr(obj, f.name)
        out[f.name] = to_arrays(v) if dataclasses.is_dataclass(v) else np.asarray(v)
    return out


def grid_meta(grid) -> dict:
    return {k: getattr(grid, k) for k in convert.GRID_META}


def port_grid(jgrid) -> T.Grid:
    return convert.grid_from_arrays(to_arrays(jgrid), grid_meta(jgrid),
                                   device="cpu")


def port_state(jstate) -> T.WaterState:
    return convert.state_from_arrays(to_arrays(jstate), device="cpu")


def build_grids(dem, *, total_depth=0.6, **kw):
    """The same grid built by both packages (port on the CPU)."""
    jg = J.Grid.build(dem, 10.0, J.SoilFields.uniform(dem.shape, **SOIL),
                      total_depth=total_depth, **kw)
    tg = T.Grid.build(dem, 10.0,
                      T.SoilFields.uniform(dem.shape, device="cpu", **SOIL),
                      total_depth=total_depth, device="cpu", **kw)
    return jg, tg


def rain_states(jg, jp, tg, tp, *, psi0, rain_mm_h):
    """Initial state + balance + uniform rain on the surface, both packages."""
    js = j_initialize_balance(jg, jp, J.WaterState.initialize(
        jg, jp, matric_potential=psi0))
    ts = t_initialize_balance(tg, tp, T.WaterState.initialize(
        tg, tp, matric_potential=psi0, device="cpu"))
    rain = rain_mm_h * 1e-3 * float(jg.area) / 3600.0
    js = dataclasses.replace(js, sink_source=jnp.zeros_like(
        js.sink_source).at[0].set(jnp.where(jg.mask[0], rain, 0.0)))
    sink = torch.zeros_like(ts.sink_source)
    # a float64 fill: torch.where of two Python numbers is float32
    sink[0] = torch.where(tg.mask[0], torch.full_like(sink[0], rain), 0.0)
    return js, dataclasses.replace(ts, sink_source=sink)


def dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.asarray(a).dtype.name


def assert_fields(jobj, tobj, *, exact=(), rtol=0.0, skip=()):
    """Compare every tensor field of a port dataclass with its JAX twin:
    dtypes equal; names in ``exact`` bit-equal, others within ``rtol``."""
    for f in dataclasses.fields(tobj):
        if f.name in skip:
            continue
        j, t = getattr(jobj, f.name), getattr(tobj, f.name)
        if dataclasses.is_dataclass(t):
            assert_fields(j, t, exact=exact, rtol=rtol)
            continue
        if not isinstance(t, torch.Tensor):
            assert t == j, f.name
            continue
        assert dtype_name(t) == dtype_name(j), f.name
        a, b = np.asarray(j), t.numpy()
        assert a.shape == b.shape, f.name
        if f.name in exact or a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=f.name)


def nodata_rim_dem(n=14):
    dem = valley_dem(n)
    dem[0, :] = dem[:, 0] = -9999.0
    dem[-1, 3:6] = -9999.0
    return dem


def land_use_map(shape):
    lu = np.zeros(shape, dtype=np.int8)
    lu[2:4, 3:7] = int(J.BoundaryType.ROAD)
    lu[6:8, 1:4] = int(J.BoundaryType.URBAN)
    return lu


# ----------------------------------------------------------------------
# grid build
# ----------------------------------------------------------------------

GRID_CASES = {
    "valley": lambda: (valley_dem(10), {}),
    "nodata_rim": lambda: (nodata_rim_dem(), {}),
    "land_use": lambda: (valley_dem(10), dict(land_use=land_use_map((10, 10)))),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_build_matches_jax(case):
    """Numpy-built fields are bit-equal (the same numpy code), soil fields
    agree to rel 1e-14 (float64 pow in two libraries), metadata equal."""
    dem, kw = GRID_CASES[case]()
    jg, tg = build_grids(dem, **kw)
    assert_fields(jg, tg, exact=[f.name for f in dataclasses.fields(tg)],
                  skip=("soil",))
    assert_fields(jg.soil, tg.soil, rtol=1e-14)
    assert grid_meta(tg) == grid_meta(jg)
    assert tg.device == torch.device("cpu")


def test_set_culvert_and_prescribed_match_jax():
    dem = valley_dem(10)
    jg, tg = build_grids(dem)
    kw = dict(roughness=0.02, slope=0.05, width=1.2, height=0.8)
    jg = jg.set_culvert(9, 5, **kw).set_prescribed(3, 4, 4, 97.5)
    tg = tg.set_culvert(9, 5, **kw).set_prescribed(3, 4, 4, 97.5)
    assert_fields(jg, tg, exact=[f.name for f in dataclasses.fields(tg)],
                  skip=("soil",))
    assert grid_meta(tg) == grid_meta(jg)
    assert tg.has_culvert and tg.has_prescribed


# ----------------------------------------------------------------------
# initial state
# ----------------------------------------------------------------------

def test_initial_state_matches_jax():
    """WaterState.initialize + initialize_balance under
    fast_f32(use_pallas=True): float64 fields to rel 1e-13 (float64 pow in
    two libraries); the float32-quantised se and storage to rel 3e-7 (an
    f32 pow ulp); every field dtype equal."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(10))
    js = j_initialize_balance(jg, jp, J.WaterState.initialize(
        jg, jp, matric_potential=-1.5))
    ts = t_initialize_balance(tg, tp, T.WaterState.initialize(
        tg, tp, matric_potential=-1.5, device="cpu"))
    assert_fields(js, ts, rtol=1e-13,
                  skip=("se", "balance_prev", "balance_current",
                        "balance_period", "balance_whole"))
    np.testing.assert_allclose(ts.se.numpy(), np.asarray(js.se), rtol=3e-7)
    for name in ("balance_prev", "balance_current", "balance_period",
                 "balance_whole"):
        assert_fields(getattr(js, name), getattr(ts, name), rtol=3e-7)
    assert dtype_name(ts.se) == "float64"


def test_initial_state_from_saturation_matches_jax():
    p = dict(delta_t_max=300.0)
    jp, tp = J.SolverParameters(**p), T.SolverParameters(**p)
    jg, tg = build_grids(valley_dem(10))
    js = J.WaterState.initialize(jg, jp, degree_of_saturation=0.6,
                                 surface_water=0.01)
    ts = T.WaterState.initialize(tg, tp, degree_of_saturation=0.6,
                                 surface_water=0.01, device="cpu")
    assert_fields(js, ts, rtol=1e-13)


# ----------------------------------------------------------------------
# carry across
# ----------------------------------------------------------------------

def test_convert_carries_grid_and_state_exactly():
    """convert.py from the JAX objects' arrays gives the port's own build
    field for field, and one step from either gives identical results."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(10))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    cg, cs = port_grid(jg), port_state(js)
    assert_fields(jg, cg, exact=[f.name for f in dataclasses.fields(cg)])
    assert_fields(js, cs, exact=[f.name for f in dataclasses.fields(cs)])

    out_own, dt_own = T.compute_step(tg, tp, ts, 3600.0)
    out_cv, dt_cv = T.compute_step(cg, tp, cs, 3600.0)
    assert dt_own == dt_cv
    for name in ("h", "se", "k", "boundary_flow_sum", "best_h"):
        assert torch.equal(getattr(out_own, name), getattr(out_cv, name)), name


def test_grid_to_device_keeps_fields():
    _, tg = build_grids(valley_dem(8))
    moved = tg.to("cpu")
    assert_fields(tg, moved, exact=[f.name for f in dataclasses.fields(tg)],
                  skip=("soil",))
    g32 = tg.astype(torch.float32)
    assert g32 is tg.astype(torch.float32)          # cast once, then kept
    assert g32.z.dtype == torch.float32 and g32.mask.dtype == torch.bool
    assert g32.soil.k_sat.dtype == torch.float32


# ----------------------------------------------------------------------
# import and device rules
# ----------------------------------------------------------------------

def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port and runs its
    CPU entry points (grid, state, one hour of the bundled-Jacobi path, one
    coupled water + heat step on a tiny column, one model-cycle hour with
    every ported process and its state checkpoint, one project hour from
    files: write_project, load, initialize, run_period with its outputs,
    one model hour with HYDRALL and RothC and one vine hour, the project
    from a GeoTIFF DEM with a meteo grid as its weather and the native
    writer pool, its report, and the command shell; the interpolation and
    side library: a local-detrending map on a 12 x 12 box, ordinary
    kriging, a watershed extraction, a NetCDF round trip and a balance
    report; a 2 x 2 CPU mesh's bundle loop; the bench's storm, day, coupled
    and mesh legs on a 16 box) without loading JAX or the JAX package."""
    code = textwrap.dedent("""
        import dataclasses, sys, tempfile
        import numpy as np, torch
        import criteria3d_tpu_torch as T
        from criteria3d_tpu_torch import (bench_jacobi, cli, constants,
                                          convert, device, model, native, ops,
                                          outputs, problems, project, viz)
        from criteria3d_tpu_torch.core import geo, grid, soil, state
        from criteria3d_tpu_torch.core import meteo as core_meteo
        from criteria3d_tpu_torch.io import (config, database, esri, geotiff,
                                             meteogrid, meteopoints, quicklook,
                                             state_io)
        from criteria3d_tpu_torch.physics import (cracking, crop,
                                                  interception,
                                                  interpolation, meteo,
                                                  radiation, snow)
        from criteria3d_tpu_torch.solver import (coupled, heat, jacobi_bundle,
                                                 link_flows, shifts, step,
                                                 water)
        m = problems.small_model(T.SolverParameters.fast_f32(), "cpu", n=12)
        out = m.run_hour(problems.model_day_forcing(m.grid, None, 8),
                         2023, 3, 21, 8)
        assert bool(torch.isfinite(m.water.h).all()) and out["solver_stats"][0] > 0
        with tempfile.TemporaryDirectory() as d:
            state_io.save_state(d, m.grid, m.water, snow=m.snow,
                                degree_days=m.degree_days, lai=m.lai)
            w, sn, ex = state_io.load_state(d, m.grid, m.params)
            assert sorted(ex) == ["degreeDays", "lai"] and sn is not None
        pc = T.SolverParameters(heat_vapor=True)
        g, w, h, b = problems.heat_column(pc, "cpu", n=2)
        w, h, dt = T.compute_step_coupled(g, pc, w, h, b, 600.0)
        assert dt > 0 and bool(torch.isfinite(h.t).all())
        n = 6
        r, c = np.mgrid[0:n, 0:n]
        dem = 100.0 + (n - 1 - r) * 0.5 + np.abs(c - n // 2) * 0.8
        soil = T.SoilFields.uniform(dem.shape, vg_alpha=1.2, vg_n=1.5,
                                    vg_he=0.02, theta_s=0.41, theta_r=0.04,
                                    k_sat=5e-6, device="cpu")
        g = T.Grid.build(dem, 10.0, soil, total_depth=0.4, device="cpu")
        p = T.SolverParameters.fast_f32(use_pallas=True)
        s = T.initialize_balance(g, p, T.WaterState.initialize(
            g, p, matric_potential=-1.0, device="cpu"))
        s, stats = T.compute_period_stats(g, p, s, 600.0)
        assert stats[0] > 0 and bool(torch.isfinite(s.h).all())
        import datetime, os
        with tempfile.TemporaryDirectory() as d:
            ini = problems.write_project(d, n=8, seed=1, n_stations=6)
            prj = project.Criteria3DProject.load(ini, output_dir=os.path.join(d, "out"))
            prj.initialize(device="cpu")
            log = prj.run_period(datetime.datetime(2023, 3, 21, 8), 1)
            assert abs(log[0]["mbr"]) < 2e-3 and prj.qc_rejected >= 1
            assert os.listdir(os.path.join(d, "out", "rasters", "20230321"))
            problems.dem_as_geotiff(ini)
            xml, gdb = problems.write_meteo_grid(d, ini, cell=8.0, margin=0.0, seed=1)
            prj = project.Criteria3DProject.load(ini, output_dir=os.path.join(d, "o2"))
            prj.load_meteo_grid(xml, gdb)
            prj.initialize(device="cpu")
            log = prj.run_period(datetime.datetime(2023, 3, 21, 11), 1)
            assert len(prj.stations) == 16 and abs(log[0]["mbr"]) < 2e-3
            assert prj._raster_writer.written > 0 and prj._raster_writer.errors == 0
            prj.write_report(os.path.join(d, "r.html"), log)
            import contextlib, io
            sh, said = cli.Shell(device="cpu"), io.StringIO()
            with contextlib.redirect_stdout(said):
                for line in ("DEM " + os.path.join(d, "MAPS", "dem.tif"), "INIT",
                             "RUN 1 2", "EXPORTPNG pond " + os.path.join(d, "p.png"),
                             "INFO"):
                    sh.execute(line)
            assert "ERROR" not in said.getvalue() and "dt_curr" in said.getvalue()
            assert open(os.path.join(d, "p.png"), "rb").read(4)[1:] == b"PNG"
        from criteria3d_tpu_torch import vine3d, vine3d_project
        from criteria3d_tpu_torch.physics import (downy_mildew, grapevine,
                                                  hydrall, powdery_mildew,
                                                  rothc, vine_photosynthesis,
                                                  watertable)
        hm = problems.small_hydrall_model(T.SolverParameters.fast_f32(), "cpu", n=8)
        ho = hm.run_hour(problems.model_day_forcing(hm.grid, None, 12),
                         2023, 3, 21, 12)
        assert bool(torch.isfinite(ho["hydrall_assimilation"]).all())
        assert hm.rothc is not None and ho["solver_stats"][0] > 0
        vm = vine3d.Vine3DModel.create(g, T.SolverParameters(),
                                       model.ModelConfig(compute_snow=False),
                                       matric_potential=-1.0)
        problems.seed_vine_canopy(vm)
        vo = vm.run_hour(model.HourlyForcing(22.0, 0.0, 60.0, 1.5, 0.7),
                         2023, 6, 21, 12)
        assert float(vo["vine_transpiration_demand"].max()) > 0.0
        from criteria3d_tpu_torch.core import watershed
        from criteria3d_tpu_torch.io import (criteria_output, forecast_dataset,
                                             import_xml, netcdf, reproject,
                                             shape_utils, shapefile, utility_db)
        from criteria3d_tpu_torch.physics import detrending, fitting, kriging
        from criteria3d_tpu_torch.utils import (debug_dump, logger, statistics,
                                                telemetry)
        rng = np.random.default_rng(0)
        sx, sy = rng.uniform(0, 1200, 30), rng.uniform(0, 1200, 30)
        sz = rng.uniform(0, 800, 30)
        sv = 15.0 - 0.006 * sz
        gx, gy = np.meshgrid(np.arange(12) * 100.0 + 50, np.arange(12) * 100.0 + 50)
        lm = detrending.local_detrending_map(
            sx, sy, sz, sv, gx, gy, np.full_like(gx, 400.0),
            options=detrending.DetrendingOptions(min_points_local=10,
                                                 n_lm_iterations=10), device="cpu")
        assert lm.shape == (12, 12) and bool(torch.isfinite(lm).all())
        km = kriging.ordinary_kriging(sx, sy, sv, gx, gy, kriging.VariogramModel(
            kriging.SPHERICAL, 0.0, 4.0, 600.0), device="cpu")
        assert bool(torch.isfinite(km).all())
        hdr = esri.RasterHeader(nrows=8, ncols=8, xllcorner=0.0, yllcorner=0.0,
                                cellsize=10.0, nodata=-9999.0)
        r8, c8 = np.mgrid[0:8, 0:8]
        basin, bh = watershed.extract_basin(100.0 + (7 - r8) * 0.5 + np.abs(c8 - 4),
                                            hdr, 45.0, 5.0)
        assert (basin != -9999.0).sum() > 0
        with tempfile.TemporaryDirectory() as d:
            netcdf.export_raster(os.path.join(d, "a.nc"), basin, bh, var_name="B")
            hnc = netcdf.NetCDFHandler().read(os.path.join(d, "a.nc"))
            assert (hnc.extract_raster("B")[0] == basin).all()
            hnc.close()
        rep = telemetry.balance_report(g, p, s, 0.0)
        assert rep["water_content_m3"] > 0.0
        from criteria3d_tpu_torch import scaling_bench
        from criteria3d_tpu_torch.parallel import sharding
        from criteria3d_tpu_torch.bench_jacobi import bundle_inputs
        mesh = sharding.make_mesh(4, devices=[torch.device("cpu")] * 4)
        inp = bundle_inputs((3, 20, 20), 0, "cpu")
        xm, dm, nm = jacobi_bundle.jacobi_solve_loop(
            *(sharding.shard_pytree(a, mesh) for a in inp), 40, 1e-7, 1200, mesh=mesh)
        xm = sharding.gather_pytree(xm)
        xs, ds, ns = jacobi_bundle.jacobi_solve_loop(*inp, 40, 1e-7, 1200)
        assert mesh.shape == {"row": 2, "col": 2} and torch.equal(xm, xs) and nm == ns
        assert scaling_bench.sloped_dem(8, 8).shape == (8, 8)
        from criteria3d_tpu_torch import ab_legs, bench, profile_breakdown, trace_coupled
        from criteria3d_tpu_torch.utils import profiling
        d16 = bench.Dem(problems.synthetic_catchment(0, n=16, radius=7.625), -9999.0,
                        4.0, "synthetic_catchment(seed=0)")
        g16, p16 = bench.build_grid(1, "cpu", d16), bench.storm_params({})
        assert bench.storm_leg(g16, p16)["stats"][0] > 0
        day = bench.day_leg(bench.build_grid(2, "cpu", d16), p16, hours=2, storm_hours=1)
        assert len(day["hour_walls_s"]) == 2 and abs(day["mbr"]) < 2e-3
        assert bench.coupled_leg(g16, p16, {})["counts"]["heat_sweeps"] > 0
        assert bench.mesh_leg(g16)["stats"][3] > 0
        assert profiling.roll_up([], {}, []).busy_s == 0.0
        assert callable(profile_breakdown.profile) and callable(trace_coupled.trace)
        assert callable(ab_legs.run_one)
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "criteria3d_tpu"
               or m.startswith("criteria3d_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda(tmp_path):
    """Without ``device`` the entry points build on the card, and raise
    where there is none; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    dem = valley_dem(6)
    soil_cpu = T.SoilFields.uniform(dem.shape, device="cpu", **SOIL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Grid.build(dem, 10.0, soil_cpu, total_depth=0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SoilFields.uniform(dem.shape, **SOIL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.HeatBoundary.uniform(dem.shape)
    grid = T.Grid.build(dem, 10.0, soil_cpu, total_depth=0.4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.WaterState.initialize(grid, T.SolverParameters(), matric_potential=-1.0)
    jg, _ = build_grids(dem, total_depth=0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.grid_from_arrays(to_arrays(jg), grid_meta(jg))
    prj = Criteria3DProject.load(problems.write_project(
        str(tmp_path), n=8, seed=1, n_stations=6))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prj.initialize()
    assert prj.grid is None and prj.model is None
    # the interpolation library: arrays in, tensors out, on the card
    from criteria3d_tpu_torch.physics import detrending as TD
    from criteria3d_tpu_torch.physics import fitting as TF
    from criteria3d_tpu_torch.physics import kriging as TK
    rng = np.random.default_rng(0)
    sx, sy, sz = (rng.uniform(0, 1000, 12) for _ in range(3))
    sv = 10.0 - 0.005 * sz
    gx, gy = np.meshgrid(np.arange(4) * 250.0, np.arange(4) * 250.0)
    model = TK.VariogramModel(TK.SPHERICAL, 0.0, 1.0, 500.0)
    lo, hi = np.zeros(4), np.ones(4)
    for call in (lambda: TD.multiple_detrending(sv, sz),
                 lambda: TD.local_detrending_map(sx, sy, sz, sv, gx, gy, gx),
                 lambda: TD.glocal_weight_maps(np.ones((4, 4), np.int32), 1.0, 1.0),
                 lambda: TD.topographic_distance_matrix(gx, 0.0, 0.0, 250.0, 4,
                                                        sx, sy, sz),
                 lambda: TD.loo_residuals(sx, sy, sz, sv),
                 lambda: TD.optimize_topo_kh(sx, sy, sz, sv, topo_dist=np.zeros((12, 12))),
                 lambda: TK.empirical_variogram(sx, sy, sv),
                 lambda: TK.fit_variogram(np.arange(4.0), np.ones(4)),
                 lambda: TK.ordinary_kriging(sx, sy, sv, gx, gy, model),
                 lambda: TF.first_guess_grid(lo, hi),
                 lambda: TF.best_fitting_marquardt(TF.lapse_piecewise_two, lo, hi, sz, sv),
                 lambda: TF.weighted_multilinear(np.ones((3, 1)), np.ones(3), np.ones(3)),
                 lambda: convert.trend_model_from_arrays(dict(
                     elevation_params=lo, elevation_significant=np.True_,
                     elevation_r2=np.float64(0.5), linear_slopes=np.zeros(0),
                     linear_intercept=np.float64(0.0),
                     linear_significant=np.zeros(0, bool),
                     elevation_function="double_piecewise"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
