"""The port's utils/ (statistics, logger, telemetry, debug_dump) against
the JAX package, on tests/test_statistics.py's and tests/test_outputs.py's
inputs.

- statistics is host numpy in both packages (the port's a copy): every
  function equal on the same inputs;
- the two loggers are separate loggers (``criteria3d_tpu.<name>`` and
  ``criteria3d_tpu_torch.<name>``), so both packages log in one process,
  each into its own file, the same lines but the time stamps;
- ``balance_report`` on a state carried across from JAX: every value rel
  1e-12 (float64 sums in another order), its host reads counted;
- the dumps: the same ``.npz`` keys; the state's arrays bit-equal, the
  float64 linear system rel 1e-12 (the port's f64 assembly against JAX's,
  as tests/test_torch_f64.py holds it); the port's dump of a fast state
  loads back equal to the arrays it dumped;
- ``trace`` writes a Chrome trace of the block; StepLogger prints JAX's
  lines.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import water as JWater
from criteria3d_tpu.solver.step import compute_period_stats as j_period
from criteria3d_tpu.utils import debug_dump as JDD
from criteria3d_tpu.utils import statistics as JST
from criteria3d_tpu.utils import telemetry as JTM
from criteria3d_tpu.utils.logger import ProjectLogger as JLogger
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.solver import water as TWater
from criteria3d_tpu_torch.solver.step import compute_period_stats as t_period
from criteria3d_tpu_torch.utils import debug_dump as TDD
from criteria3d_tpu_torch.utils import statistics as TST
from criteria3d_tpu_torch.utils import telemetry as TTM
from criteria3d_tpu_torch.utils.logger import ProjectLogger as TLogger
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, port_state, rain_states

torch.set_num_threads(1)
NODATA = -9999.0


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def stat_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=50)
    y = 0.8 * x + rng.normal(scale=0.3, size=50)
    y[[3, 17]] = NODATA
    x[29] = np.nan
    return x, y


@pytest.mark.parametrize("name", ["mean", "variance", "standard_deviation", "percentile"])
def test_one_series_statistics_match_jax(name):
    x, _ = stat_inputs()
    for v in (x, [1.0, 2.0, NODATA, 3.0, 4.0], [NODATA], np.arange(1, 101, dtype=float)):
        args = (v, 90) if name == "percentile" else (v,)
        assert getattr(TST, name)(*args) == getattr(JST, name)(*args)


@pytest.mark.parametrize("name", ["covariance", "pearson", "linear_regression",
                                  "weighed_mean", "root_mean_square_error", "mean_error",
                                  "mean_absolute_error", "nash_sutcliffe_efficiency"])
def test_two_series_statistics_match_jax(name):
    x, y = stat_inputs()
    xs = np.array([0.0, 1, 2, 3, 4])
    for a, b in ((x, y), (xs, 2.0 + 0.5 * xs), (xs, xs), (xs[:1], xs[:1])):
        assert getattr(TST, name)(a, b) == getattr(JST, name)(a, b)
    if name == "linear_regression":
        assert TST.linear_regression(xs, 0.7 * xs, zero_intercept=True) == \
            JST.linear_regression(xs, 0.7 * xs, zero_intercept=True)


def test_gamma_functions_match_jax():
    for alpha in (0.5, 1.0, 2.3, 7.0, 120.0):
        assert TST.gamma_ln(alpha) == JST.gamma_ln(alpha)
        for x in (0.0, 0.1, 0.9, 2.5, 10.0, 200.0):
            assert TST.incomplete_gamma(alpha, x) == JST.incomplete_gamma(alpha, x)
            assert TST.gamma_cdf(x, 2.0, alpha, 0.1) == JST.gamma_cdf(x, 2.0, alpha, 0.1)
    for args in ((0.0, 1.0, 2.0, 3.0, 1.5), (1.0, 5.0, 1.0, 7.0, 1.0)):
        assert TST.linear_interpolation(*args) == JST.linear_interpolation(*args)


# ---------------------------------------------------------------------------
# logger
# ---------------------------------------------------------------------------

def test_both_loggers_in_one_process(tmp_path, capsys):
    """test_logger's lines through both packages' loggers at once: two
    loggers, two files, the same lines but the time stamps."""
    lj, lt = JLogger("testproj"), TLogger("testproj")
    assert lj._logger is not lt._logger
    assert lt._logger.name == "criteria3d_tpu_torch.testproj"
    pj = lj.set_log_file(str(tmp_path / "J"), "unit")
    pt = lt.set_log_file(str(tmp_path / "T"), "unit")
    assert os.path.basename(pj) == os.path.basename(pt)
    for log in (lj, lt):
        log.info("hello")
        log.warning("careful")
        log.error("boom")
        log.close()
    lines = [[ln.split("  ", 1)[1] for ln in open(p).read().splitlines()] for p in (pj, pt)]
    assert lines[0] == lines[1] == ["hello", "WARNING: careful", "ERROR! boom"]
    out = capsys.readouterr().out.splitlines()
    assert out == ["hello", "WARNING: careful", "ERROR! boom"] * 2
    for name in ("criteria3d_tpu.testproj", "criteria3d_tpu_torch.testproj"):
        for h in list(logging.getLogger(name).handlers):
            logging.getLogger(name).removeHandler(h)


# ---------------------------------------------------------------------------
# telemetry and dumps on one rainy hour of a valley (both packages)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rained():
    """test_outputs.py's use: a 6 x 6 valley, 600 s of 20 mm/h rain under
    the float64 parameters, run by JAX; the port gets JAX's state."""
    dem = valley_dem(6)
    jg, tg = build_grids(dem, total_depth=0.4)
    jp, tp = J.SolverParameters(), T.SolverParameters()
    js, _ = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    s0 = float(JWater.total_water_content(jg, jp, js.h, js.se))
    js, _ = j_period(jg, jp, js, 600.0)
    return jg, tg, jp, tp, js, port_state(js), s0


def test_balance_report_matches_jax(rained):
    jg, tg, jp, tp, js, ts, s0 = rained
    kw = dict(total_precipitation=0.01, total_evaporation=0.002)
    rj = JTM.balance_report(jg, jp, js, s0, **kw)
    host_read.count = 0
    rt = TTM.balance_report(tg, tp, ts, s0, **kw)
    assert host_read.count == 6
    assert list(rt) == list(rj)
    for k in rj:
        assert rt[k] == pytest.approx(rj[k], rel=1e-12, abs=1e-300), k
    assert rt["runoff_m3"] != 0.0 or rt["free_drainage_m3"] != 0.0


def test_dumps_match_jax(rained, tmp_path):
    """dump_solver_state and dump_linear_system (approximations 0 and 1):
    the same keys; the state bit-equal, the system rel 1e-12."""
    jg, tg, jp, tp, js, ts, _ = rained
    a = JDD.load_dump(JDD.dump_solver_state(str(tmp_path / "js"), jg, jp, js))
    b = TDD.load_dump(TDD.dump_solver_state(str(tmp_path / "ts"), tg, tp, ts))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for approx in (0, 1):
        a = JDD.load_dump(JDD.dump_linear_system(str(tmp_path / f"jl{approx}"), jg, jp, js,
                                                 dt=60.0, approx=approx))
        b = TDD.load_dump(TDD.dump_linear_system(str(tmp_path / f"tl{approx}.npz"), tg, tp,
                                                 ts, dt=60.0, approx=approx))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape, k
            scale = np.maximum(np.abs(a[k]), 1e-300)
            assert np.all(np.abs(b[k] - a[k]) <= 1e-12 * scale), k


def test_fast_state_dump_loads_back(tmp_path):
    """A fast_f32 state after a port hour: the system dump (the float32
    working-dtype capacity branch) and the state dump load back equal to
    the arrays they were made of."""
    dem = valley_dem(6)
    _, tg = build_grids(dem, total_depth=0.4)
    tp = T.SolverParameters.fast_f32()
    ts = T.initialize_balance(tg, tp, T.WaterState.initialize(
        tg, tp, matric_potential=-1.0, device="cpu"))
    ts, _ = t_period(tg, tp, ts, 600.0)
    d = TDD.load_dump(TDD.dump_linear_system(str(tmp_path / "fast"), tg, tp, ts, dt=30.0))
    se = TWater.compute_se(tg, tp, ts.h)
    cap, k = TWater.compute_capacity(tg, tp, ts.h, ts.h_old, se)
    np.testing.assert_array_equal(d["capacity"], cap.numpy())
    np.testing.assert_array_equal(d["x0"], ts.h.numpy())
    assert np.isfinite(d["b"][tg.mask.numpy()]).all() and d["c_lat"].shape == (8,) + tg.shape
    s = TDD.load_dump(TDD.dump_solver_state(str(tmp_path / "fs"), tg, tp, ts))
    np.testing.assert_array_equal(s["h"], ts.h.numpy())
    assert s["dt_curr"] == float(ts.dt_curr)


def test_trace_and_step_logger(tmp_path, monkeypatch):
    """trace writes a Chrome trace holding the block's operations;
    StepLogger prints JAX's lines on JAX's cadence."""
    with TTM.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, dtype=torch.float64).cumsum(0)
    assert prof is not None
    events = json.load(open(tmp_path / "tr" / "trace.json"))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    lines = {"J": [], "T": []}
    monkeypatch.setattr(JTM.time, "time", lambda: 100.0)
    monkeypatch.setattr(TTM.time, "time", lambda: 100.0)
    for mod, key in ((JTM, "J"), (TTM, "T")):
        log = mod.StepLogger(log_fn=lines[key].append, every_sim_seconds=600.0)
        for t in (300.0, 600.0, 900.0, 1260.0, 1800.0):
            log.step(t, mbr=1.5e-4, dt=42.0)
    assert lines["T"] == lines["J"] and len(lines["J"]) == 2
