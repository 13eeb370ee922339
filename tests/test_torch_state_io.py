"""The port's state checkpoints (``criteria3d_tpu_torch.io.state_io``)
against the JAX package's: the per-layer raster checkpoint of
``run_period`` and the in-hour ``.npz``.

The same state (a JAX water state with seeded heads, carried across with
``convert``; seeded snow, degree days and LAI) is saved by both packages:
the files are byte-identical. Each package then reads the same checkpoint
back: the rebuilt water state agrees to rel 1e-12 (float64 pow of two
libraries in se and k); the float32 rasters themselves are exact.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.io import state_io as JS
from criteria3d_tpu.physics.snow import SnowState as JSnow
from criteria3d_tpu.solver.step import initialize_balance as j_initialize_balance
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert
from criteria3d_tpu_torch.io import esri as TE
from criteria3d_tpu_torch.io import state_io as TS
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import (build_grids, dtype_name, port_grid,
                                   port_state, to_arrays)

torch.set_num_threads(1)

# preset -> (JAX params, port params, tolerances of the rebuilt se and k):
# rel 1e-12 in float64; where the retention curve runs in float32, a
# float32 ulp of se (3e-7, as tests/test_torch_core.py holds the
# float32-quantised se) and 1e-5 of k, which the steep Mualem curve
# computes from that se (0.2% of the cells take the other float32 pow
# rounding of se)
PRESETS = {
    "f64": (J.SolverParameters, T.SolverParameters, {"se": 1e-12, "k": 1e-12}),
    "fast": (J.SolverParameters.fast_f32, T.SolverParameters.fast_f32,
             {"se": 3e-7, "k": 1e-5}),
}


def seeded_state(jp, seed=0):
    """A nodata-rimmed valley with seeded heads (a ponded corner, dry and
    wet soil), seeded snow, degree days and LAI; returns the JAX grid,
    water state, snow state and the two maps, all JAX."""
    dem = valley_dem(12)
    dem[0, :4] = -9999.0
    jg, _ = build_grids(dem)
    rng = np.random.default_rng(seed)
    psi = rng.uniform(-3.0, 0.05, jg.shape)
    psi[0] = rng.uniform(-0.01, 0.02, jg.shape[1:])
    js = J.WaterState.initialize(jg, jp, matric_potential=-1.0)
    h = jnp.where(jg.mask, jg.z + psi, 0.0)
    js = j_initialize_balance(jg, jp, dataclasses.replace(js, h=h, h_old=h, best_h=h))
    shape = jg.shape[1:]
    snow = JSnow.zero(shape, surface_temp=-1.0)
    snow = dataclasses.replace(snow, swe=jnp.asarray(rng.uniform(0.0, 40.0, shape)),
                               age=jnp.asarray(rng.uniform(0.0, 9.0, shape)))
    dd = jnp.asarray(rng.uniform(0.0, 2000.0, shape))
    lai = jnp.asarray(rng.uniform(0.2, 4.0, shape))
    return jg, js, snow, dd, lai


def port_snow(jsnow):
    return convert.snow_state_from_arrays(to_arrays(jsnow), device="cpu")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_save_state_is_byte_identical(tmp_path, preset):
    """save_state of the same state writes the same files, byte for byte:
    WP_0, one WP_<cm> per soil layer, the seven snow rasters, degreeDays
    and lai, with their headers."""
    jp = PRESETS[preset][0]()
    jg, js, jsnow, dd, lai = seeded_state(jp)
    JS.save_state(str(tmp_path / "j"), jg, js, snow=jsnow, degree_days=dd, lai=lai)
    TS.save_state(str(tmp_path / "t"), port_grid(jg), port_state(js),
                  snow=port_snow(jsnow), degree_days=torch.from_numpy(np.array(dd)),
                  lai=torch.from_numpy(np.array(lai)))
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files
    assert len(files) == 2 * (jg.n_layers + 7 + 2)
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_load_state_matches_jax(tmp_path, preset):
    """load_state of one checkpoint in both packages: h bit-equal (z +
    float32 psi), se, k and the storage rel 1e-12 (PRESETS' float32
    tolerances under fast_f32), snow and the crop maps exact; the port's
    state on the grid's device in the JAX dtypes."""
    make_j, make_t, rtol = PRESETS[preset]
    jp, tp = make_j(), make_t()
    jg, js, jsnow, dd, lai = seeded_state(jp, seed=1)
    JS.save_state(str(tmp_path), jg, js, snow=jsnow, degree_days=dd, lai=lai)
    jw, jsn, jx = JS.load_state(str(tmp_path), jg, jp)
    tw, tsn, tx = TS.load_state(str(tmp_path), port_grid(jg), tp)
    np.testing.assert_array_equal(tw.h.numpy(), np.asarray(jw.h))
    for name in ("se", "k"):
        t, j = getattr(tw, name), getattr(jw, name)
        assert dtype_name(t) == dtype_name(j), name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol[name],
                                   err_msg=name)
    for b in ("balance_current", "balance_whole"):
        np.testing.assert_allclose(float(getattr(tw, b).storage),
                                   float(getattr(jw, b).storage), rtol=rtol["se"])
    for f in dataclasses.fields(tsn):
        np.testing.assert_array_equal(getattr(tsn, f.name).numpy(),
                                      np.asarray(getattr(jsn, f.name)), err_msg=f.name)
    assert sorted(tx) == sorted(jx) == ["degreeDays", "lai"]
    for k in tx:
        np.testing.assert_array_equal(tx[k].numpy(), np.asarray(jx[k]))
    # the rasters hold the state to float32 rounding
    psi = (tw.h - port_grid(jg).z).numpy()
    want = np.asarray(js.h - jg.z)
    mask = np.asarray(jg.mask)
    np.testing.assert_allclose(psi[1:][mask[1:]], want[1:][mask[1:]], rtol=6e-8, atol=1e-12)


def test_inhour_npz_round_trip(tmp_path):
    """save_inhour_state / load_inhour_state: the port's file restores
    every field exactly in both packages, and a JAX file restores exactly
    in the port; elapsed seconds kept."""
    jp = J.SolverParameters(track_link_flow=True)
    jg, js, *_ = seeded_state(jp, seed=2)
    ts = port_state(js)
    TS.save_inhour_state(str(tmp_path / "t"), ts, 1234.5)
    JS.save_inhour_state(str(tmp_path / "j"), js, 99.0)
    back, elapsed = TS.load_inhour_state(str(tmp_path / "t.npz"), device="cpu")
    assert elapsed == 1234.5
    jback, jel = JS.load_inhour_state(str(tmp_path / "t"))
    assert jel == 1234.5
    cross, el2 = TS.load_inhour_state(str(tmp_path / "j"), device="cpu")
    assert el2 == 99.0
    for f in dataclasses.fields(ts):
        a = getattr(ts, f.name)
        for other in (back, cross):
            b = getattr(other, f.name)
            if dataclasses.is_dataclass(a):
                for g in dataclasses.fields(a):
                    assert torch.equal(getattr(a, g.name), getattr(b, g.name)), (f.name, g.name)
            else:
                assert torch.equal(a, b), f.name
        if not dataclasses.is_dataclass(a):
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jback, f.name)))


def test_esri_round_trip_and_header(tmp_path):
    """write_flt / read_flt: little-endian float32 with a JAX-identical
    header; a big-endian file reads back too; a short file raises."""
    from criteria3d_tpu.io import esri as JE
    data = np.random.default_rng(3).uniform(-10.0, 10.0, (5, 7))
    hdr_t = TE.RasterHeader(nrows=5, ncols=7, xllcorner=1.5, yllcorner=-2.0,
                            cellsize=4.0)
    TE.write_flt(str(tmp_path / "t.flt"), data, hdr_t)
    JE.write_flt(str(tmp_path / "j"), data, JE.RasterHeader(5, 7, 1.5, -2.0, 4.0))
    for ext in (".flt", ".hdr"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    back, hdr = TE.read_flt(str(tmp_path / "t"))
    np.testing.assert_array_equal(back, data.astype(np.float32).astype(np.float64))
    assert hdr == hdr_t and hdr.xy(0, 0) == JE.RasterHeader(5, 7, 1.5, -2.0, 4.0).xy(0, 0)
    (tmp_path / "b.hdr").write_text((tmp_path / "t.hdr").read_text().replace(
        "LSBFIRST", "MSBFIRST"))
    data.astype(">f4").tofile(tmp_path / "b.flt")
    np.testing.assert_array_equal(TE.read_flt(str(tmp_path / "b.hdr"))[0], back)
    data[:2].astype("<f4").tofile(tmp_path / "t.flt")
    with pytest.raises(ValueError, match="expected 35"):
        TE.read_flt(str(tmp_path / "t"))
