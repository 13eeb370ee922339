"""The port's VINE3D model (``vine3d.Vine3DModel``) and project
(``vine3d_project.Vine3DProject``) against the JAX package.

The model runs on tests/test_vine3d.py's 6 x 6 vineyard (10 m cells,
0.8 m of soil) with its mid-season canopy, carried into the port by
``convert.vine_model_from_arrays``; the project is
``problems.write_vine_project(n=16)``: two vineyard fields (VINEYARD and
VINEYARD_NEW, with different cultivars and training systems), a
non-vineyard field, a field book with irrigation, trimming, leaf removal,
cluster thinning and a harvest, and six stations reporting a summer day
with an afternoon shower. Both packages load the same files; the port runs
on the CPU.

Tolerances: float64 hours the same ``dt_curr``, heads within 1e-9 m, the
vine, grass and ET maps rel 1e-9 (the stress coefficient, a 0-1 fraction
formed as 1 - Gs / Gs0, within 1e-9 of 1), irrigation and leaf wetness
equal, downy-mildew infection flags equal; the hourly MBR, a ratio whose
numerator is the balance's rounding residue, within rel 1e-6; the daily
update's float64 maps rel 1e-9 and its powdery-mildew risk (a float32
fraction of the ascospore pool) within 4 float32 ulp of the pool (1); the
project's tables, field map and vineyard mask equal.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from criteria3d_tpu.core.grid import Grid as JGrid
from criteria3d_tpu.core.soil import SoilFields as JSoil
from criteria3d_tpu.core.state import SolverParameters as JParams
from criteria3d_tpu.io.database import read_fields_db as j_read_fields_db
from criteria3d_tpu.model import HourlyForcing as JForcing
from criteria3d_tpu.model import ModelConfig as JConfig
from criteria3d_tpu.vine3d import FieldBookEntry as JEntry
from criteria3d_tpu.vine3d import Vine3DModel as JVine
from criteria3d_tpu.vine3d_project import Vine3DProject as JProject
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert, problems
from criteria3d_tpu_torch.io.database import read_fields_db as t_read_fields_db
from criteria3d_tpu_torch.model import HourlyForcing as TForcing
from criteria3d_tpu_torch.vine3d_project import Vine3DProject as TProject
from tests.test_torch_core import dtype_name, grid_meta, to_arrays
from tests.test_torch_hydrall_rothc import assert_maps
from tests.test_torch_physics import close
from tests.test_torch_vine import assert_state32, close32

torch.set_num_threads(1)

VINE_MAPS = ("et0", "vine_transpiration_demand", "vine_transpiration",
             "grass_transpiration")
DAY_MAPS = ("tavg", "stage", "lai", "fruit_biomass")
POOL = dict(aic=1.0, current_colonies=1.0, total_sporulating=1.0)


def jax_vine_arrays(jm) -> dict:
    """A JAX Vine3DModel's fields as the arrays
    convert.vine_model_from_arrays takes."""
    asdict = lambda v: None if v is None else dataclasses.asdict(v)  # noqa: E731
    arrays = dict(
        grid=to_arrays(jm.grid), water=to_arrays(jm.water), vine=to_arrays(jm.vine),
        downy=to_arrays(jm.downy), powdery=to_arrays(jm.powdery),
        config=dataclasses.asdict(jm.config), vine_params=asdict(jm.vine_params),
        vine_crop=asdict(jm.vine_crop), grass_crop=asdict(jm.grass_crop),
        training=asdict(jm.training), wang_leuning=asdict(jm.wang_leuning),
        field_map=np.asarray(jm.field_map),
        field_book=[(e.date, e.field_index, e.operation, e.quantity)
                    for e in jm.field_book])
    for name in convert.VINE_MAPS:
        v = getattr(jm, name)
        arrays[name] = None if v is None else np.asarray(v)
    for name in convert.VINE_ACCUMULATORS:
        v = getattr(jm, name)
        arrays[name] = v if isinstance(v, float) else np.asarray(v)
    for name in ("max_irrigation_rate", "grass_lai", "compute_diseases",
                 "water_stress_threshold", "_nhours", "_irrigation_hours"):
        arrays[name] = getattr(jm, name)
    return arrays


def vine_models(book=()):
    """tests/test_vine3d.py's month-run vineyard in JAX with the seeded
    mid-season canopy (problems.VINE_CANOPY) and ``book`` (field-book
    tuples), carried into the port."""
    dem = np.full((6, 6), 150.0) + np.arange(6)[:, None] * 0.4
    soil = JSoil.uniform(dem.shape, vg_alpha=1.2, vg_n=1.5, vg_he=0.02,
                         theta_s=0.45, theta_r=0.06, k_sat=2e-5)
    grid = JGrid.build(dem, 10.0, soil, total_depth=0.8)
    config = JConfig(latitude=45.06, longitude=9.27, timezone=1, compute_snow=False)
    jm = JVine.create(grid, JParams(), config, matric_potential=-3.0)
    jm.vine = dataclasses.replace(jm.vine, **{
        k: jnp.full(dem.shape, v) for k, v in problems.VINE_CANOPY.items()})
    jm.field_book.extend(JEntry(*e) for e in book)
    tm = convert.vine_model_from_arrays(jax_vine_arrays(jm), grid_meta(jm.grid),
                                        T.SolverParameters(), device="cpu")
    return jm, tm


def vine_forcing(shape, date, hour):
    """tests/test_vine3d.py's month-run forcing for both packages (a
    rainy day every fifth day, 2 mm/h at 6-18 h)."""
    rainy = date.day % 5 == 0
    t = 18.0 + 8.0 * np.sin((hour - 8) / 24.0 * 2 * np.pi)
    arr = dict(air_temperature=np.full(shape, t),
               precipitation=np.full(shape, 2.0 if (rainy and 6 <= hour <= 18) else 0.0),
               rel_humidity=np.full(shape, 92.0 if rainy else 65.0),
               wind_speed=np.full(shape, 1.5),
               transmissivity=np.full(shape, 0.25 if rainy else 0.7))
    return JForcing(**{k: jnp.asarray(v) for k, v in arr.items()}), TForcing(**arr)


def test_convert_carries_the_seeded_model():
    jm, tm = vine_models()
    assert_maps(tm.vine, jm.vine, 0.0, "vine")
    assert_state32(tm.downy, jm.downy, "downy", ulp=0)
    assert_state32(tm.powdery, jm.powdery, "powdery", ulp=0)
    for name in convert.VINE_MAPS:
        a, b = getattr(tm, name), getattr(jm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert dtype_name(a) == np.asarray(b).dtype.name, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.water.h.numpy(), np.asarray(jm.water.h))
    assert tm.vine_params == dataclasses.replace(tm.vine_params, **dataclasses.asdict(jm.vine_params))


def test_field_book_operations_match_jax():
    """Trimming, leaf removal, cluster thinning, a harvest and irrigation
    booked on one date: the vine state, the harvested mask and the
    irrigation of every hour equal JAX's."""
    date = datetime.date(2023, 7, 12)
    book = [(date, 0, "trimming", 2.5), (date, 0, "leafRemoval", 3.0),
            (date, 0, "clusterThinning", 30.0), (date, 0, "harvesting", 0.0),
            (date, 0, "irrigation", 3.0), (date, 1, "irrigation", 5.0)]
    jm, tm = vine_models(book)
    jm.vine = dataclasses.replace(jm.vine, fruit_biomass=jnp.full((6, 6), 80.0),
                                  shoot_leaf_number=jnp.full((6, 6), 15.0))
    tm.vine = dataclasses.replace(tm.vine, fruit_biomass=torch.full((6, 6), 80.0,
                                                                    dtype=torch.float64),
                                  shoot_leaf_number=torch.full((6, 6), 15.0,
                                                               dtype=torch.float64))
    jm.apply_field_book(date)
    tm.apply_field_book(date)
    assert_maps(tm.vine, jm.vine, 1e-12, "field book")
    np.testing.assert_array_equal(tm.harvested.numpy(), np.asarray(jm.harvested))
    assert tm._irrigation_hours == jm._irrigation_hours
    for hour in range(24):
        np.testing.assert_array_equal(tm.hourly_irrigation(hour).numpy(),
                                      np.asarray(jm.hourly_irrigation(hour)))


def assert_vine_hour(jo, to, jm, tm, label):
    assert float(tm.water.dt_curr) == float(jm.water.dt_curr), label
    dh = float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max())
    assert dh < 1e-9, (label, dh)
    for k in VINE_MAPS:
        close(to[k], jo[k], 1e-9, f"{label} {k}")
    np.testing.assert_allclose(to["vine_stress"].numpy(), np.asarray(jo["vine_stress"]),
                               rtol=1e-9, atol=1e-9, err_msg=label)
    for k in ("irrigation", "leaf_wetness", "downy_mildew_infection"):
        assert dtype_name(to[k]) == np.asarray(jo[k]).dtype.name, (label, k)
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]), err_msg=f"{label} {k}")
    assert to["mbr"] == pytest.approx(jo["mbr"], rel=1e-6), label
    return dh


def test_vine_day_matches_jax():
    """A rainy June day (test_vine3d.py's month run, day 20) with 3 h of
    irrigation booked: 24 hours then the daily update. Hourly: heads, maps,
    irrigation, leaf wetness and infection flags; daily: phenology, LAI,
    fruit biomass, tartaric acid, the powdery-mildew risk, and every state
    field's dtype (float64 vine, float32 / int32 / bool downy mildew,
    powdery mildew promoted by its float64 forcing)."""
    date = datetime.date(2023, 6, 20)
    jm, tm = vine_models([(date, 0, "irrigation", 3.0)])
    irrigated = 0.0
    worst = 0.0
    for hour in range(24):
        jf, tf = vine_forcing((6, 6), date, hour)
        jo = jm.run_hour(jf, date.year, date.month, date.day, hour)
        to = tm.run_hour(tf, date.year, date.month, date.day, hour)
        worst = max(worst, assert_vine_hour(jo, to, jm, tm, f"hour {hour}"))
        irrigated += float(to["irrigation"].max())
        assert len(to["solver_stats"]) == 4
    print(f"max |dh| over the day {worst} m")
    assert irrigated == 3 * tm.max_irrigation_rate
    jd, td = jm.daily_update(date), tm.daily_update(date)
    for k in DAY_MAPS:
        close(td[k], jd[k], 1e-9, k)
    np.testing.assert_array_equal(np.isnan(td["tartaric_acid"].numpy()),
                                  np.isnan(np.asarray(jd["tartaric_acid"])))
    assert td["tavg_mean"] == pytest.approx(jd["tavg_mean"], rel=1e-12)
    close32(td["powdery_infection_risk"], jd["powdery_infection_risk"], scale=1.0)
    assert dtype_name(td["powdery_infection_risk"]) == \
        np.asarray(jd["powdery_infection_risk"]).dtype.name
    assert_maps(tm.vine, jm.vine, 1e-9, "vine")
    assert_state32(tm.downy, jm.downy, "downy")
    assert_state32(tm.powdery, jm.powdery, "powdery", scales=POOL)
    close(tm._t30_avg, jm._t30_avg, 1e-12, "t30")
    assert tm._nhours == jm._nhours == 0


# ----------------------------------------------------------------------
# the project on disk
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def vine_ini(tmp_path_factory):
    d = tmp_path_factory.mktemp("vine_project")
    return problems.write_vine_project(str(d), n=16, seed=0)


def _tables(prj):
    return dict(
        cultivars={k: tuple(dataclasses.asdict(p) for p in v)
                   for k, v in prj.cultivars.items()},
        trainings={k: dataclasses.asdict(v) for k, v in prj.trainings.items()},
        fields={k: dataclasses.asdict(v) for k, v in prj.fields.items()},
        field_book=[(e.date, e.field_index, e.operation, e.quantity)
                    for e in prj.field_book],
        compute_diseases=prj.compute_diseases, warnings=prj.base.warnings)


def test_vine_project_loads_like_jax(vine_ini, tmp_path):
    """The cultivar, training-system, field and field-book tables, the
    ini's diseases switch and read_fields_db equal; the project has two
    vineyard fields of different cultivars and training systems, a
    non-vineyard field and every booked operation."""
    jp = JProject.load(vine_ini, output_dir=str(tmp_path / "j"))
    tp = TProject.load(vine_ini, output_dir=str(tmp_path / "t"))
    assert _tables(tp) == _tables(jp)
    vineyards = [f for f in tp.fields.values() if f.is_vineyard]
    assert {f.landuse for f in vineyards} == {"VINEYARD", "VINEYARD_NEW"}
    assert len({f.id_cultivar for f in vineyards}) == 2
    assert len({f.id_training_system for f in vineyards}) == 2
    assert any(not f.is_vineyard for f in tp.fields.values())
    assert {e.operation for e in tp.field_book} >= {
        "irrigation", "trimming", "leafRemoval", "clusterThinning", "harvesting"}
    assert tp.compute_diseases is True
    db = tp.base.config.vine3d_db_path
    jr, tr = j_read_fields_db(db), t_read_fields_db(db)
    for key in ("cultivars", "fields", "field_book"):
        assert tr[key] == jr[key], key
    assert {k: dataclasses.asdict(v) for k, v in tr["training_systems"].items()} == \
        {k: dataclasses.asdict(v) for k, v in jr["training_systems"].items()}


def test_vine_project_day_matches_jax(vine_ini, tmp_path):
    """initialize (the field map from the land-use raster, the vineyard
    mask, the lead cultivar and training system, the irrigation rate),
    the seeded mid-season canopy, then run_day on the summer day: heads
    within 1e-9 m, the daily outputs rel 1e-9, the irrigation of the last
    hour equal (field 1's cells), the powdery risk within 4 float32 ulp of
    the pool."""
    jp = JProject.load(vine_ini, output_dir=str(tmp_path / "j"))
    tp = TProject.load(vine_ini, output_dir=str(tmp_path / "t"))
    jp.initialize()
    tp.initialize(device="cpu")
    np.testing.assert_array_equal(tp.field_map, jp.field_map)
    np.testing.assert_array_equal(tp.model.vineyard_mask.numpy(),
                                  np.asarray(jp.model.vineyard_mask))
    for name in ("max_irrigation_rate", "grass_lai", "water_stress_threshold",
                 "compute_diseases"):
        assert getattr(tp.model, name) == getattr(jp.model, name), name
    assert dataclasses.asdict(tp.model.training) == dataclasses.asdict(jp.model.training)
    assert dataclasses.asdict(tp.model.wang_leuning) == \
        dataclasses.asdict(jp.model.wang_leuning)
    assert dataclasses.asdict(tp.model.vine_params) == \
        dataclasses.asdict(jp.model.vine_params)
    np.testing.assert_array_equal(tp.model.vine_root_density.numpy(),
                                  np.asarray(jp.model.vine_root_density))
    jp.model.vine = dataclasses.replace(jp.model.vine, **{
        k: jnp.full(jp.base.dem.shape, v) for k, v in problems.VINE_CANOPY.items()})
    problems.seed_vine_canopy(tp.model)
    date = datetime.date(*problems.VINE_DATE)
    jd, td = jp.run_day(date), tp.run_day(date)
    dh = float(np.abs(np.asarray(jp.model.water.h) - tp.model.water.h.numpy()).max())
    print(f"project day: max |dh| {dh} m, MBR port {td['mbr']} JAX {jd['mbr']}")
    assert dh < 1e-9
    assert td["mbr"] == pytest.approx(jd["mbr"], rel=1e-6)
    for k in DAY_MAPS:
        close(td[k], jd[k], 1e-9, k)
    np.testing.assert_array_equal(td["irrigation_mm"].numpy(),
                                  np.asarray(jd["irrigation_mm"]))
    irrigated = td["irrigation_mm"].numpy() > 0
    assert irrigated.sum() == (tp.field_map == 1).sum() > 0
    close32(td["powdery_infection_risk"], jd["powdery_infection_risk"], scale=1.0)
    assert_maps(tp.model.vine, jp.model.vine, 1e-9, "vine")
