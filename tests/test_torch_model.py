"""The port's hourly model cycle (``criteria3d_tpu_torch.model``) against
the JAX package's ``Criteria3DModel`` on tests/test_model.py's valley
(10 x 10, 10 m cells, 0.6 m of soil) with slope and aspect from the DEM,
every process the port runs (snow, crop, evaporation, interception,
cracking), a dry start (psi0 = -4 m, so the soil cracks) and frozen snow
ground (-2 degC, so the snow settles).

Both packages get the same numpy forcing; the port runs on the CPU.
Tolerances: float64 hours give JAX's ``dt_curr``, heads within 1e-9 m,
every output map within rel 1e-9 (with an absolute floor of 1e-9 x the
map's max |value|) and the MBR within 1e-9; ``fast_f32()`` hours heads
within 1e-4 m (float32 psi) and both MBRs under the 2e-3 mass gate. The
coupled (compute_heat) hour is in tests/test_torch_model_heat.py.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import BoundaryType as JBT
from criteria3d_tpu.core.grid import slope_aspect
from criteria3d_tpu.model import Criteria3DModel as JModel
from criteria3d_tpu.model import HourlyForcing as JForcing
from criteria3d_tpu.model import ModelConfig as JConfig
from criteria3d_tpu.model import masked_mean as j_masked_mean
from criteria3d_tpu.physics.snow import SnowState as JSnow
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert, problems
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.model import Criteria3DModel as TModel
from criteria3d_tpu_torch.model import HourlyForcing as TForcing
from criteria3d_tpu_torch.model import ModelConfig as TConfig
from criteria3d_tpu_torch.model import masked_mean as t_masked_mean
from criteria3d_tpu_torch.physics.crop import CropParameters as TCrop
from criteria3d_tpu_torch.physics.snow import SnowState as TSnow
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, dtype_name, grid_meta, to_arrays

torch.set_num_threads(1)

CONFIG = dict(compute_snow=True, compute_crop=True, compute_evaporation=True,
              compute_interception=True, compute_cracking=True)
PSI0 = -4.0
DATE = datetime.date(2023, 3, 21)
OUT_MAPS = ("global_radiation", "swe", "snow_melt", "et0", "evaporation",
            "transpiration")


def models(jp, tp, *, heat=False, n=10):
    """The same model in both packages: valley_dem(n), CONFIG (+ heat with
    every layer-1 node a HeatSurface), slope/aspect from slope_aspect,
    snow ground at -2 degC."""
    dem = valley_dem(n)
    jg, tg = build_grids(dem)
    cfg = dict(CONFIG, compute_heat=heat)
    if heat:
        jg = dataclasses.replace(
            jg, btype=jg.btype.at[1].set(jnp.where(jg.mask[1], int(JBT.HEAT_SURFACE),
                                                   jg.btype[1])),
            bsize=jg.bsize.at[1].set(jnp.where(jg.mask[1], float(jg.area),
                                               jg.bsize[1])))
        tg = problems.with_heat_surface(tg)
    jm = JModel.create(jg, jp, JConfig(**cfg), matric_potential=PSI0)
    tm = TModel.create(tg, tp, TConfig(**cfg), matric_potential=PSI0)
    slope, aspect = slope_aspect(dem, 10.0)
    jm.slope_deg, jm.aspect_deg = jnp.asarray(slope), jnp.asarray(aspect)
    tm.slope_deg, tm.aspect_deg = torch.tensor(slope), torch.tensor(aspect)
    jm.snow = JSnow.zero(dem.shape, surface_temp=-2.0)
    tm.snow = TSnow.zero(dem.shape, surface_temp=-2.0, device="cpu")
    return jm, tm


def forcing(tgrid, hour):
    """problems.model_day_forcing for both packages: (jax, port) forcing
    with the same float64 maps."""
    f = problems.model_day_forcing(tgrid, DATE, hour)
    arr = {k.name: getattr(f, k.name).numpy() for k in dataclasses.fields(f)}
    return JForcing(**{k: jnp.asarray(v) for k, v in arr.items()}), TForcing(**arr)


def assert_hour(jo, to, jm, tm, dh_tol, maps=True, label=""):
    assert float(tm.water.dt_curr) == float(jm.water.dt_curr), label
    dh = float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max())
    print(f"{label}: max |dh| {dh} m, MBR port {float(to['mbr'])} "
          f"JAX {float(jo['mbr'])}")     # shown with pytest -s
    assert dh < dh_tol, (label, dh)
    for k in OUT_MAPS:
        if not maps:
            break
        a, b = np.asarray(jo[k]), to[k].numpy()
        assert dtype_name(to[k]) == a.dtype.name, k
        np.testing.assert_allclose(b, a, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(a).max()),
                                   err_msg=f"{label} {k}")
    if maps:
        assert abs(float(to["mbr"]) - float(jo["mbr"])) < 1e-9, label
    else:   # float32 storage: both hold the mass gate
        assert abs(float(to["mbr"])) < 2e-3 and abs(float(jo["mbr"])) < 2e-3, label
    assert len(to["solver_stats"]) == 4
    for t in to.values():
        assert not isinstance(t, torch.Tensor) or t.device.type == "cpu"


def test_masked_mean_matches_jax():
    """masked_mean over the valid cells of a nodata-padded valley: the
    host float and the 0-d tensor equal JAX's to rel 1e-14, one host read
    for the float, none for the tensor."""
    dem = np.full((12, 12), -9999.0)
    dem[2:10, 2:10] = valley_dem(8)
    jg, tg = build_grids(dem)
    x = np.random.default_rng(0).uniform(0.0, 5.0, (12, 12))
    j = j_masked_mean(jnp.asarray(x), jg.mask[0])
    host_read.count = 0
    t_dev = t_masked_mean(torch.from_numpy(x), tg.mask[0], device=True)
    assert host_read.count == 0 and t_dev.dtype == torch.float64 and t_dev.ndim == 0
    t = t_masked_mean(torch.from_numpy(x), tg.mask[0])
    assert host_read.count == 1
    assert t == pytest.approx(j, rel=1e-14)
    assert float(t_dev) == pytest.approx(j, rel=1e-14)


@pytest.mark.parametrize("heat", [False, True])
def test_create_matches_jax(heat):
    """Criteria3DModel.create: water (and heat) state, snow, LAI, degree
    days and canopy storage equal JAX's to rel 1e-12, on the grid's
    device, slope/aspect left None."""
    dem = valley_dem(10)
    jg, tg = build_grids(dem)
    cfg = dict(CONFIG, compute_heat=heat)
    jp, tp = J.SolverParameters(heat_vapor=heat), T.SolverParameters(heat_vapor=heat)
    jm = JModel.create(jg, jp, JConfig(**cfg), matric_potential=PSI0)
    tm = TModel.create(tg, tp, TConfig(**cfg), matric_potential=PSI0)
    assert tm.slope_deg is None and tm.aspect_deg is None
    pairs = [(jm.water.h, tm.water.h), (jm.water.se, tm.water.se),
             (jm.water.balance_whole.storage, tm.water.balance_whole.storage),
             (jm.lai, tm.lai), (jm.degree_days, tm.degree_days),
             (jm.canopy_storage, tm.canopy_storage)]
    pairs += [(getattr(jm.snow, f.name), getattr(tm.snow, f.name))
              for f in dataclasses.fields(TSnow)]
    if heat:
        pairs += [(jm.heat.t, tm.heat.t), (jm.heat.storage_whole, tm.heat.storage_whole)]
    else:
        assert tm.heat is None
    for j, t in pairs:
        assert dtype_name(t) == np.asarray(j).dtype.name
        assert t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    assert tm.crop == TCrop()


def test_hours_f64_match_jax():
    """Three hours (snow at 7, rain on the pack at 8-9) under
    SolverParameters(): the same dt_curr, h within 1e-9 m, every output
    map rel 1e-9, MBR within 1e-9; snow settles, the soil cracks."""
    jm, tm = models(J.SolverParameters(), T.SolverParameters())
    cracked = 0.0
    for hour in (7, 8, 9):
        jf, tf = forcing(tm.grid, hour)
        jo = jm.run_hour(jf, DATE.year, DATE.month, DATE.day, hour)
        to = tm.run_hour(tf, DATE.year, DATE.month, DATE.day, hour)
        assert_hour(jo, to, jm, tm, 1e-9, label=f"hour {hour}")
        cracked += float(tm.water.sink_source[1:].clamp_min(0.0).sum())
        if hour == 7:
            assert float(to["swe"].max()) > 0.0
    assert cracked > 0.0
    for name in ("total_evaporation_mm", "total_transpiration_mm",
                 "total_precipitation_m3"):
        t, j = getattr(tm, name), getattr(jm, name)
        assert t.ndim == 0 and t.dtype == torch.float64
        assert float(t) == pytest.approx(float(j), rel=1e-12), name
    np.testing.assert_allclose(tm.canopy_storage.numpy(),
                               np.asarray(jm.canopy_storage), rtol=1e-9, atol=1e-12)


def test_hours_fast_match_jax():
    """The same three hours under fast_f32() (CG line): the same dt_curr,
    heads within 1e-4 m, both |MBR| below the 2e-3 mass gate (the MBR of a
    float32 storage on this small valley differs by up to 1e-4 between the
    packages)."""
    jm, tm = models(J.SolverParameters.fast_f32(), T.SolverParameters.fast_f32())
    for hour in (7, 8, 9):
        jf, tf = forcing(tm.grid, hour)
        jo = jm.run_hour(jf, DATE.year, DATE.month, DATE.day, hour)
        to = tm.run_hour(tf, DATE.year, DATE.month, DATE.day, hour)
        assert_hour(jo, to, jm, tm, 1e-4, maps=False, label=f"fast hour {hour}")


def test_daily_update_matches_jax():
    """daily_update with per-cell Tmin/Tmax maps and with scalars: degree
    days equal, LAI rel 1e-12."""
    jm, tm = models(J.SolverParameters(), T.SolverParameters())
    rows = np.arange(10, dtype=np.float64)[:, None] * np.ones((1, 10))
    t_min, t_max = 2.0 + 0.6 * rows, 14.0 + 0.6 * rows
    for _ in range(3):
        jm.daily_update(jnp.asarray(t_min), jnp.asarray(t_max))
        tm.daily_update(torch.from_numpy(t_min.copy()), torch.from_numpy(t_max.copy()))
    jm.daily_update(12.0, 24.0)
    tm.daily_update(12.0, 24.0)
    np.testing.assert_array_equal(tm.degree_days.numpy(), np.asarray(jm.degree_days))
    np.testing.assert_allclose(tm.lai.numpy(), np.asarray(jm.lai), rtol=1e-12)


def test_run_period_one_day_matches_jax(tmp_path):
    """run_period over one day of problems.model_day_forcing (dry outside
    hours 6-9) on the valley under SolverParameters(), saving the daily
    state: the daily MBR within 1e-9, h within 1e-9 m, degree days equal,
    LAI rel 1e-12, SWE within 1e-9 mm; the same checkpoint files,
    headers byte-identical and rasters within a float32 ulp or 1e-9 (the
    float64 states differ by ~1e-11, and melt leaves ~1e-10 mm residues of
    liquid water); the MBR is read from the device once, at the end."""
    jm, tm = models(J.SolverParameters(), T.SolverParameters())

    def provider_j(date, hour):
        return forcing(tm.grid, hour)[0]

    def provider_t(date, hour):
        return problems.model_day_forcing(tm.grid, date, hour)

    jlog = jm.run_period(DATE, 1, provider_j, state_save_dir=str(tmp_path / "j"),
                         save_daily_state=True)
    host_read.count = 0
    tlog = tm.run_period(DATE, 1, provider_t, state_save_dir=str(tmp_path / "t"),
                         save_daily_state=True)
    assert [e["date"] for e in tlog] == [e["date"] for e in jlog]
    assert abs(tlog[0]["mbr"] - jlog[0]["mbr"]) < 1e-9
    assert float(tm.water.dt_curr) == float(jm.water.dt_curr)
    assert float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max()) < 1e-9
    np.testing.assert_array_equal(tm.degree_days.numpy(), np.asarray(jm.degree_days))
    np.testing.assert_allclose(tm.lai.numpy(), np.asarray(jm.lai), rtol=1e-12)
    assert float(np.abs(np.asarray(jm.snow.swe) - tm.snow.swe.numpy()).max()) < 1e-9
    name = "20230321_H23"
    files = sorted(p.name for p in (tmp_path / "t" / name).iterdir())
    assert files == sorted(p.name for p in (tmp_path / "j" / name).iterdir())
    assert "SNOW_swe.flt" in files and "lai.flt" in files
    for f in files:
        t_bytes = (tmp_path / "t" / name / f).read_bytes()
        j_bytes = (tmp_path / "j" / name / f).read_bytes()
        if f.endswith(".hdr"):
            assert t_bytes == j_bytes, f
        else:
            np.testing.assert_allclose(np.frombuffer(t_bytes, "<f4"),
                                       np.frombuffer(j_bytes, "<f4"),
                                       rtol=1.2e-7, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("preset", ["f64", "fast", "fast_cracking_off"])
def test_sink_source_dtype_matches_jax(preset):
    """run_hour hands the solver a float64 sink (params.dtype stays float64
    under fast_f32, which sets only sweep_dtype), as JAX does; the sink
    agrees to rel 1e-9."""
    if preset == "f64":
        jp, tp = J.SolverParameters(), T.SolverParameters()
    else:
        jp, tp = J.SolverParameters.fast_f32(), T.SolverParameters.fast_f32()
    jm, tm = models(jp, tp)
    if preset == "fast_cracking_off":
        jm.config.compute_cracking = tm.config.compute_cracking = False
    jf, tf = forcing(tm.grid, 8)
    jm.run_hour(jf, 2023, 3, 21, 8)
    tm.run_hour(tf, 2023, 3, 21, 8)
    assert tm.water.sink_source.dtype == torch.float64
    assert dtype_name(tm.water.sink_source) == np.asarray(jm.water.sink_source).dtype.name
    a = np.asarray(jm.water.sink_source)
    np.testing.assert_allclose(tm.water.sink_source.numpy(), a, rtol=1e-9,
                               atol=1e-9 * float(np.abs(a).max()))


def test_unported_models_raise():
    """HYDRALL and RothC are ported (tests/test_torch_hydrall_rothc.py
    holds them against JAX): nothing raises. create builds their state for
    each flag; a model created without them behaves as JAX's when a flag
    is switched on afterwards: monthly_rothc_update returns None, and
    run_hour and daily_update run without the missing model."""
    jg, tg = build_grids(valley_dem(6))
    jp, tp = J.SolverParameters(), T.SolverParameters()
    for flag, part in (("compute_hydrall", "hydrall"), ("compute_rothc", "rothc")):
        jm = JModel.create(jg, jp, JConfig(**{flag: True}))
        tm = TModel.create(tg, tp, TConfig(**{flag: True}))
        assert getattr(tm, part) is not None and getattr(jm, part) is not None
    jm = JModel.create(jg, jp, JConfig())
    tm = TModel.create(tg, tp, TConfig())
    assert tm.monthly_rothc_update(10.0, 50.0, 30.0) is None
    assert jm.monthly_rothc_update(10.0, 50.0, 30.0) is None
    jm.config.compute_hydrall = tm.config.compute_hydrall = True
    jf, tf = forcing(tg, 12)
    jo = jm.run_hour(jf, 2023, 3, 21, 12)
    to = tm.run_hour(tf, 2023, 3, 21, 12)
    assert "hydrall_assimilation" not in to and "hydrall_assimilation" not in jo
    jm.daily_update(5.0, 15.0)
    tm.daily_update(5.0, 15.0)
    assert tm.hydrall is None and jm.hydrall is None
    np.testing.assert_allclose(tm.lai.numpy(), np.asarray(jm.lai), rtol=1e-12)


def test_resolve_precond_matches_jax():
    """cg_precond="auto" resolves to "line", explicit settings pass through
    (model.py's _resolve_precond)."""
    _, tg = build_grids(valley_dem(6))
    tm = TModel.create(tg, T.SolverParameters(), TConfig())
    sink = torch.zeros(tg.shape, dtype=torch.float64)
    auto = T.SolverParameters.fast_f32(cg_precond="auto")
    assert tm._resolve_precond(auto, sink).cg_precond == "line"
    diag = T.SolverParameters.fast_f32(cg_precond="diag")
    assert tm._resolve_precond(diag, sink) is diag
    assert T.SolverParameters.fast_f32().cg_precond == "line"


def _jax_model_arrays(jm):
    heat = None if jm.heat is None else to_arrays(jm.heat)
    snow = None if jm.snow is None else to_arrays(jm.snow)
    arrays = dict(grid=to_arrays(jm.grid), water=to_arrays(jm.water), heat=heat,
                  snow=snow, config=dataclasses.asdict(jm.config),
                  crop=None if jm.crop is None else dataclasses.asdict(jm.crop))
    for name in convert.MODEL_MAPS:
        v = getattr(jm, name)
        arrays[name] = None if v is None else np.asarray(v)
    for name in convert.MODEL_ACCUMULATORS:
        arrays[name] = np.asarray(getattr(jm, name))
    return arrays


def test_model_from_arrays_continues_like_jax():
    """A JAX model two hours into the day, carried across by
    convert.model_from_arrays, then one more hour in both packages under
    SolverParameters(): the carried fields equal, then the same dt_curr,
    h within 1e-9 m, the outputs rel 1e-9 and the accumulators rel 1e-12."""
    dem = valley_dem(10)
    jg, _ = build_grids(dem)
    jp = J.SolverParameters()
    jm = JModel.create(jg, jp, JConfig(**CONFIG), matric_potential=PSI0)
    slope, aspect = slope_aspect(dem, 10.0)
    jm.slope_deg, jm.aspect_deg = jnp.asarray(slope), jnp.asarray(aspect)
    jm.snow = JSnow.zero(dem.shape, surface_temp=-2.0)
    _, tg0 = build_grids(dem)
    for hour in (7, 8):
        jm.run_hour(forcing(tg0, hour)[0], 2023, 3, 21, hour)

    tm = convert.model_from_arrays(_jax_model_arrays(jm), grid_meta(jm.grid),
                                   T.SolverParameters(), device="cpu")
    assert tm.config == TConfig(**CONFIG) and tm.crop == TCrop()
    np.testing.assert_array_equal(tm.water.h.numpy(), np.asarray(jm.water.h))
    np.testing.assert_array_equal(tm.snow.swe.numpy(), np.asarray(jm.snow.swe))
    assert float(tm.total_precipitation_m3) == float(jm.total_precipitation_m3)

    jf, tf = forcing(tm.grid, 9)
    tf = convert.forcing_from_arrays(
        {f.name: getattr(tf, f.name) for f in dataclasses.fields(tf)}, device="cpu")
    jo = jm.run_hour(jf, 2023, 3, 21, 9)
    to = tm.run_hour(tf, 2023, 3, 21, 9)
    assert_hour(jo, to, jm, tm, 1e-9, label="carried hour 9")
    for name in convert.MODEL_ACCUMULATORS:
        assert float(getattr(tm, name)) == pytest.approx(float(getattr(jm, name)),
                                                         rel=1e-12), name
