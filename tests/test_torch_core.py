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
from criteria3d_tpu_torch import convert
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
    sink[0] = torch.where(tg.mask[0], rain, 0.0)
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
    """A fresh interpreter runs the port's CPU entry points (grid, state,
    one hour of the bundled-Jacobi path) without loading JAX or the JAX
    package."""
    code = textwrap.dedent("""
        import dataclasses, sys
        import numpy as np, torch
        import criteria3d_tpu_torch as T
        from criteria3d_tpu_torch import convert
        from criteria3d_tpu_torch.solver import jacobi_bundle, shifts, step, water
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


def test_entry_points_default_to_cuda():
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
    grid = T.Grid.build(dem, 10.0, soil_cpu, total_depth=0.4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.WaterState.initialize(grid, T.SolverParameters(), matric_potential=-1.0)
    jg, _ = build_grids(dem, total_depth=0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.grid_from_arrays(to_arrays(jg), grid_meta(jg))
