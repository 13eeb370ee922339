"""The CUDA kernels of the port against their plain PyTorch twins, the
tiled bundled-Jacobi design against the per-sweep one, the mesh loop and
the partitioned water and coupled hours on blocks of the card against one
device, the water and coupled periods' CUDA graphs against their eager
driver (whole and on blocks of the card), the water and coupled periods
on one card's blocks split into machines (rounds) against one machine,
the fixed points of HYDRALL and the vine graph-driven against
eager-driven, small hours of
the float64, CG and coupled water + heat paths, the model cycle's physics
maps and hours, and a project's hours from files, on the card against the
CPU path. Every test here carries the ``cuda`` marker and skips where
there is no card; the file imports neither JAX nor the JAX package, so it
runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS


def seeded_system(shape, seed):
    """Seeded float32 bundle inputs with zero edge coefficients (c_up[0],
    c_down[L-1] and every lateral coefficient whose neighbour is missing
    or outside the box), as the assembly produces them."""
    rng = np.random.default_rng(seed)
    L, R, C = shape
    mask = rng.random(shape) < 0.9
    b = rng.uniform(-0.2, 0.2, shape) * mask
    up_ok = np.zeros(shape, bool)
    up_ok[1:] = mask[1:] & mask[:-1]
    dn_ok = np.zeros(shape, bool)
    dn_ok[:-1] = mask[:-1] & mask[1:]
    c_up = rng.uniform(0, 0.09, shape) * up_ok
    c_down = rng.uniform(0, 0.09, shape) * dn_ok
    c_lat = np.empty((8,) + shape)
    for k, (di, dj) in enumerate(LATERAL_OFFSETS):
        nb = np.zeros(shape, bool)
        rs = slice(max(di, 0), R + min(di, 0))
        rd = slice(max(-di, 0), R + min(-di, 0))
        cs = slice(max(dj, 0), C + min(dj, 0))
        cd = slice(max(-dj, 0), C + min(-dj, 0))
        nb[:, rd, cd] = mask[:, rs, cs]
        c_lat[k] = rng.uniform(0, 0.09, shape) * (mask & nb)
    x = rng.uniform(-3, 3, shape) * mask
    return tuple(a.astype(np.float32)
                 for a in (b, c_up, c_down, c_lat, mask.astype(np.float32), x))


def _cuda_arrays(shape, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs only on the card")
    return [torch.from_numpy(a).cuda() for a in seeded_system(shape, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 37, 45), (7, 64, 96)])
def test_cuda_kernel_matches_plain_version(shape):
    """On the card: the CUDA kernel against its plain twin. The library is
    built with --fmad=false, so x is bit-equal; the norm is summed in
    another order (rel 1e-5)."""
    arrays = _cuda_arrays(shape, seed=5)
    before = TB.jacobi_bundle.launches
    xk, nk = TB.jacobi_bundle(*arrays)
    xp, np_ = TB.jacobi_bundle_reference(*arrays)
    torch.cuda.synchronize()
    assert TB.jacobi_bundle.launches == before + 1
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    arrays = _cuda_arrays((3, 9, 7), seed=6)
    before = TB.jacobi_bundle.launches
    with pytest.raises(TypeError):
        TB.jacobi_bundle(arrays[0].double(), *arrays[1:])
    with pytest.raises(ValueError):
        TB.jacobi_bundle(*arrays[:3], arrays[3][:7], *arrays[4:])
    assert TB.jacobi_bundle.launches == before


def _extent(TI, where):
    return {"below": TI - 1, "at": 2 * TI, "past": 2 * TI + 1}[where]


@pytest.mark.cuda
@pytest.mark.parametrize("L,K,rows,cols,halo,masked", [
    (1, 1, "at", "at", 0, False),
    (1, 8, "past", "at", 8, True),
    (3, 3, "below", "below", 0, False),
    (3, 12, "at", "at", 0, True),
    (5, 5, "past", "at", 0, False),
    (7, 8, "at", "at", 0, False),
    (7, 8, "past", "below", 0, True),
    (7, 5, "past", "past", 8, False),
    (7, 12, "below", "at", 8, False),
    (11, 3, "at", "below", 8, False),
    (11, 12, "past", "at", 0, False),
    (24, 5, "past", "past", 0, False),
    (24, 8, "at", "past", 0, True),
])
def test_tiled_kernel_matches_plain_and_per_sweep(L, K, rows, cols, halo, masked):
    """The tiled design (the tile of plan_tiles for L and K; R and C below,
    at and one past a tile edge; K not a multiple of S; the halo mode; a
    box whose first tile is masked out, which the resident kernel skips and
    fills with +0.0) against the plain twin, x bit for
    bit and the norm to rel 1e-5 (summed in another order), and against
    the per-sweep design, x and norm bit for bit (the same per-column
    terms and the same fixed reduction tree). L <= 7 with C a multiple of 4
    runs the resident kernel, the rest the generic one."""
    TI, _ = TB.plan_tiles(L, K)
    shape = (L, _extent(TI, rows), _extent(TI, cols))
    arrays = _cuda_arrays(shape, seed=L * 100 + K)
    assert TB.tiled_variant(*arrays, K=K) == (
        "resident" if L <= 7 and shape[2] % 4 == 0 else "generic")
    if masked:   # only the mask: the plain version gives acc * 0, -0.0 where acc < 0
        arrays[4][..., :TI, :TI] = 0.0
    before = TB.jacobi_bundle.launches
    xk, nk = TB.jacobi_bundle(*arrays, K=K, halo=halo)
    xs, ns = TB.jacobi_bundle_per_sweep(*arrays, K=K, halo=halo)
    xp, np_ = TB.jacobi_bundle_reference(*arrays, K=K, halo=halo)
    torch.cuda.synchronize()
    assert TB.jacobi_bundle.launches == before + 1
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)
    assert torch.equal(xk, xs) and torch.equal(nk, ns)


@pytest.mark.cuda
def test_cuda_kernel_halo_matches_plain_version():
    """halo = 8 at the CPU test's shape and seed (tests/test_torch_jacobi.py
    holds the twin against the Pallas halo mode there)."""
    arrays = _cuda_arrays((5, 37, 45), seed=7)
    xk, nk = TB.jacobi_bundle(*arrays, halo=8)
    xp, np_ = TB.jacobi_bundle_reference(*arrays, halo=8)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [4, 8])
def test_mesh_loop_on_card_matches_one_device(blocks):
    """The mesh form of the solve loop on 2 x 2 and 2 x 4 blocks of the
    card (the kernel's halo mode on every grown block) against the
    one-device loop: x bit-equal, the same n_it and flag, one launch per
    block and bundle."""
    from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh,
                                                        shard_pytree)
    arrays = _cuda_arrays((7, 64, 96), seed=blocks)
    n_nodes = int(arrays[4].sum())
    x1, d1, n1 = TB.jacobi_solve_loop(*arrays, 200, 1e-7, n_nodes)
    mesh = make_mesh(blocks, devices=[torch.device("cuda")] * blocks)
    blocked = [shard_pytree(a, mesh) for a in arrays]
    before = TB.jacobi_bundle.launches
    xm, dm, nm = TB.jacobi_solve_loop(*blocked, 200, 1e-7, n_nodes, mesh=mesh)
    xm = gather_pytree(xm)
    torch.cuda.synchronize()
    assert torch.equal(xm, x1) and (nm, dm) == (n1, d1)
    assert TB.jacobi_bundle.launches - before == blocks * nm // TB.SWEEPS_PER_BUNDLE


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bundle", "cg_line", "f64"])
def test_partitioned_hour_on_card_matches_one_device(form):
    """The water hour of a 64-box catchment on 2 x 2 blocks of the card
    (grid and state cut by shard_pytree, the whole step on the blocks)
    against the same hour on the card whole: the same stats; float32 heads
    bit-equal, float64 within 1e-9 m; four bundle launches for each of the
    whole hour's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    from criteria3d_tpu_torch import SolverParameters, compute_period_stats
    from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh,
                                                        shard_pytree)
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    make = {"bundle": lambda **kw: SolverParameters.fast_f32(use_pallas=True, **kw),
            "cg_line": lambda **kw: SolverParameters.fast_f32(**kw),
            "f64": lambda **kw: SolverParameters(**kw)}[form]
    grid, state = build_problem(synthetic_catchment(0, n=64, radius=30.0), 4.0, make(),
                                "cuda")
    before = TB.jacobi_bundle.launches
    whole, stats = compute_period_stats(grid, make(), state, 3600.0)
    launches = TB.jacobi_bundle.launches - before
    mesh = make_mesh(4, devices=[torch.device("cuda")] * 4)
    before = TB.jacobi_bundle.launches
    out, stats_m = compute_period_stats(shard_pytree(grid, mesh), make(mesh=mesh),
                                        shard_pytree(state, mesh), 3600.0)
    out = gather_pytree(out)
    torch.cuda.synchronize()
    assert tuple(stats_m) == tuple(stats)
    assert TB.jacobi_bundle.launches - before == 4 * launches
    if form == "f64":
        assert float((out.h - whole.h).abs().max()) <= 1e-9
    else:
        assert torch.equal(out.h, whole.h)


@pytest.mark.cuda
def test_partitioned_coupled_hour_on_card_matches_one_device():
    """The coupled storm hour of a 32 valley (tests/test_catchment3d.py's
    valley_dem) under fast_f32(heat_vapor=True, heat_frozen_props=True) on
    2 x 2 blocks of the card (grid, water, heat and boundary cut by
    shard_pytree) against the same hour on the card whole: every count of
    the coupled step equal; float32 h and T bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh,
                                                        shard_pytree)
    from criteria3d_tpu_torch.problems import build_coupled_problem
    from criteria3d_tpu_torch.solver import coupled as CP
    n = 32
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8

    def make(**kw):
        return SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True, **kw)
    inputs = build_coupled_problem(dem, 10.0, make(), "cuda")
    CP.reset_counts()
    w1, h1 = CP.compute_period_coupled(inputs[0], make(), *inputs[1:], 3600.0)
    counts = CP.counts()
    mesh = make_mesh(4, devices=[torch.device("cuda")] * 4)
    blocked = [shard_pytree(t, mesh) for t in inputs]
    CP.reset_counts()
    w2, h2 = CP.compute_period_coupled(blocked[0], make(mesh=mesh), *blocked[1:], 3600.0)
    w2, h2 = gather_pytree(w2), gather_pytree(h2)
    torch.cuda.synchronize()
    assert CP.counts() == counts and counts["heat_sweeps"] > 0
    assert torch.equal(w2.h, w1.h) and torch.equal(h2.t, h1.t)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["f64", "cg_line", "cg_diag_links"])
def test_small_hour_on_card_matches_cpu(config):
    """chip_smoke.py phase 3d as a test: a 16 x 16 valley hour with dt
    locked at 60 s on the card and on the CPU -- the float64 path,
    fast_f32() CG line, fast_f32() CG diag with track_link_flow: the same
    steps, attempts and approximations; heads within 1e-6 m (f64) or
    1e-4 m; link flows within 1e-3 of their max |value|; no bundle
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    from criteria3d_tpu_torch.problems import SMALL_CONFIGS, small_hour
    make, h_tol = SMALL_CONFIGS[config]
    params = make()
    before = TB.jacobi_bundle.launches
    oc, sc = small_hour(params, "cuda")
    op, sp = small_hour(params, "cpu")
    assert TB.jacobi_bundle.launches == before
    assert sc[:3] == sp[:3]
    assert oc.h.device.type == "cuda" and oc.h.dtype == params.dtype
    assert float((oc.h.cpu() - op.h).abs().max()) < h_tol
    if params.track_link_flow:
        scale = float(op.link_flow_sum.abs().max())
        assert scale > 0
        assert float((oc.link_flow_sum.cpu() - op.link_flow_sum).abs().max()) < 1e-3 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["f64_vapor", "frozen_vapor"])
def test_small_coupled_hour_on_card_matches_cpu(config):
    """chip_smoke.py phase 3f as a test: a coupled water + heat hour of the
    6 x 6 heat column on the card and on the CPU -- float64 with vapor, and
    fast_f32 with vapor and heat_frozen_props: the same water steps and
    heat sub-steps; T within 1e-6 K (f64) or 1e-3 K, heads within 1e-6 m
    or 1e-4 m; every output on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    from criteria3d_tpu_torch.problems import (SMALL_COUPLED_CONFIGS,
                                               small_coupled_hour)
    make, t_tol, h_tol = SMALL_COUPLED_CONFIGS[config]
    params = make()
    wc, hc, cc = small_coupled_hour(params, "cuda")
    wp, hp, cp = small_coupled_hour(params, "cpu")
    for key in ("steps", "attempts", "approximations", "chunks",
                "substeps_accepted", "substeps_rejected"):
        assert cc[key] == cp[key], key
    assert hc.t.device.type == "cuda" and wc.h.device.type == "cuda"
    assert float((hc.t.cpu() - hp.t).abs().max()) < t_tol
    assert float((wc.h.cpu() - wp.h).abs().max()) < h_tol


def _close(card, cpu, rtol, name):
    a = cpu.numpy()
    np.testing.assert_allclose(card.cpu().numpy(), a, rtol=rtol,
                               atol=rtol * float(np.abs(a).max()), err_msg=name)


@pytest.mark.cuda
def test_model_physics_maps_on_card_match_cpu():
    """The model cycle's physics on the card against the CPU on the
    synthetic catchment cut to a 64 box, slope/aspect from the DEM:
    radiation at a low and a high sun (shadow maps equal, every map rel
    1e-12), one snow step of a cold pack under rain, the atom root density
    and the transpiration and evaporation sinks (rel 1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    import dataclasses
    from criteria3d_tpu_torch import SolverParameters, problems
    from criteria3d_tpu_torch.core.soil import theta_from_se
    from criteria3d_tpu_torch.physics import crop as C
    from criteria3d_tpu_torch.physics import radiation as R
    from criteria3d_tpu_torch.physics import snow as S
    res = {}
    for dev in ("cuda", "cpu"):
        m = problems.small_model(SolverParameters(), dev, n=64)
        g, out = m.grid, {}
        for hour in (7, 12):
            rad = R.compute_radiation_dem(
                g.z[0], g.mask[0], g.cell_size, torch.full_like(g.z[0], 44.5),
                torch.full_like(g.z[0], 11.3), m.slope_deg, m.aspect_deg, 1,
                2023, 3, 21, hour, transmissivity=torch.full_like(g.z[0], 0.6))
            out.update({f"{k}{hour}": getattr(rad, k) for k in
                        ("global_irr", "beam", "diffuse", "reflected", "shadow")})
        f = problems.model_day_forcing(g, None, 8)
        sf = S.SnowForcing(air_temp=f.air_temperature, precipitation=f.precipitation,
                           rel_humidity=f.rel_humidity, wind_speed=f.wind_speed,
                           global_radiation=out["global_irr12"],
                           beam_radiation=out["beam12"],
                           transmissivity=f.transmissivity,
                           clear_sky_transmissivity=torch.full_like(g.z[0], 0.75),
                           surface_water=torch.zeros_like(g.z[0]))
        snow = dataclasses.replace(m.snow, swe=torch.full_like(g.z[0], 20.0))
        new, so = S.snow_step(snow, sf)
        out.update({f"snow_{k.name}": getattr(new, k.name) for k in dataclasses.fields(new)})
        out["snow_melt"] = so["snow_melt"]
        length = C.root_length(m.crop, m.degree_days, 0.8)
        out["roots"] = C.root_density_atoms(m.crop, g, length)
        theta = torch.where(g.mask, theta_from_se(g.soil, m.water.se), 0.0)
        et0 = torch.full_like(g.z[0], 0.3)
        out["transpiration"] = C.transpiration_sink(g, m.params, m.crop, theta, et0,
                                                    m.lai, m.degree_days)[0]
        out["evaporation"] = C.evaporation_sink(g, m.params, theta,
                                                torch.zeros_like(et0), et0, m.lai)[0]
        res[dev] = out
    assert bool(res["cuda"]["shadow7"].is_cuda)
    for k, v in res["cpu"].items():
        if v.dtype == torch.bool:
            assert torch.equal(res["cuda"][k].cpu(), v), k
        else:
            _close(res["cuda"][k], v, 1e-12, k)


@pytest.mark.cuda
def test_small_model_hours_on_card_match_cpu():
    """Hours 6-9 of problems.model_day_forcing (snow, then rain on the
    pack) through Criteria3DModel.run_hour on a 32 box under
    SolverParameters(), on the card and on the CPU: the same dt_curr and
    solver stats, heads within 1e-6 m, SWE within 1e-6 mm, every output
    on the card, no bundle launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    from criteria3d_tpu_torch import SolverParameters, problems
    before = TB.jacobi_bundle.launches
    runs = {}
    for dev in ("cuda", "cpu"):
        m = problems.small_model(SolverParameters(), dev)
        stats = []
        for hour in range(6, 10):
            out = m.run_hour(problems.model_day_forcing(m.grid, None, hour),
                             2023, 3, 21, hour)
            stats.append(out["solver_stats"])
            for v in out.values():
                assert not isinstance(v, torch.Tensor) or v.device.type == dev
        runs[dev] = (m, stats)
    (mc, sc), (mp, sp) = runs["cuda"], runs["cpu"]
    assert TB.jacobi_bundle.launches == before
    assert sc == sp
    assert float(mc.water.dt_curr) == float(mp.water.dt_curr)
    assert float((mc.water.h.cpu() - mp.water.h).abs().max()) < 1e-6
    assert float((mc.snow.swe.cpu() - mp.snow.swe).abs().max()) < 1e-6
    assert float(mp.snow.swe.max()) > 0.0


@pytest.mark.cuda
def test_small_project_hours_on_card_match_cpu(tmp_path):
    """chip_smoke.py phase 3l in short: problems.write_project on a 16 box,
    loaded and initialised on the card and on the CPU under its float64
    parameters, hours 6-8 through run_period with outputs: the forcing
    maps rel 1e-12, the same solver stats, heads within 1e-6 m, each
    hour's MBR within 1e-8, the output rasters within one float32 ulp,
    the output-point values rel 1e-9, no bundle launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card path runs only on the card")
    import datetime
    import sqlite3
    from criteria3d_tpu_torch import problems
    from criteria3d_tpu_torch.project import Criteria3DProject
    ini = problems.write_project(str(tmp_path / "p"), n=16, seed=0, n_stations=6)
    start = datetime.datetime(*problems.PROJECT_DATE, 6)
    before = TB.jacobi_bundle.launches
    runs = {}
    for dev in ("cuda", "cpu"):
        prj = Criteria3DProject.load(ini, output_dir=str(tmp_path / dev))
        prj.initialize(device=dev)
        f = prj.hourly_forcing(start)
        assert f.air_temperature.device.type == dev
        log = prj.run_period(start, 3)
        runs[dev] = (prj, f, log)
    assert TB.jacobi_bundle.launches == before
    (pc, fc, lc), (pp, fp, lp) = runs["cuda"], runs["cpu"]
    for k in ("air_temperature", "precipitation", "rel_humidity", "wind_speed"):
        _close(getattr(fc, k), getattr(fp, k), 1e-12, k)
    assert fc.transmissivity == pytest.approx(fp.transmissivity, rel=1e-12)
    assert max(abs(a["mbr"] - b["mbr"]) for a, b in zip(lc, lp)) < 1e-8
    assert float((pc.model.water.h.cpu() - pp.model.water.h).abs().max()) < 1e-6
    for day in os.listdir(tmp_path / "cpu" / "rasters"):
        for name in os.listdir(tmp_path / "cpu" / "rasters" / day):
            if name.endswith(".flt"):
                a = np.fromfile(tmp_path / "cuda" / "rasters" / day / name, "<f4")
                b = np.fromfile(tmp_path / "cpu" / "rasters" / day / name, "<f4")
                fin = ~np.isnan(b)
                assert np.array_equal(np.isnan(a), ~fin)
                assert np.abs(a[fin].view(np.int32).astype(np.int64)
                              - b[fin].view(np.int32).astype(np.int64)).max() <= 1
    rows = []
    for prj in (pc, pp):
        con = sqlite3.connect(prj.config.output_db_path)
        rows.append(con.execute('SELECT * FROM "point_P1" ORDER BY time').fetchall())
        con.close()
    assert len(rows[0]) == len(rows[1]) == 3
    for a, b in zip(*rows):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-9)


# ----------------------------------------------------------------------
# the water period's state machine as CUDA graphs (solver/device_loop.py)
# ----------------------------------------------------------------------

GRAPH_FORMS = {
    "bundle": lambda: SolverParameters.fast_f32(use_pallas=True),
    "cg_line": SolverParameters.fast_f32,
    "f64": SolverParameters,
}


def _graph_hour(params, grid, state, eager: bool):
    from criteria3d_tpu_torch import compute_period_stats
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.solver import device_loop
    host_read.count = 0
    before = TB.jacobi_bundle.launches
    if eager:
        with device_loop.forced_eager():
            out, stats = compute_period_stats(grid, params, state, 3600.0)
    else:
        out, stats = compute_period_stats(grid, params, state, 3600.0)
    torch.cuda.synchronize()
    return out, tuple(stats), host_read.count, TB.jacobi_bundle.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(GRAPH_FORMS))
def test_graph_driver_matches_eager_driver(form):
    """A 48-box storm hour of each form on the card, graph-driven and
    eager-driven: the same stats, MBR and bundle launches, heads bit-equal
    (the same kernels in the same order); the graph hour reads the host
    once a launch, at most a twentieth of the eager hour's reads; a second
    graph hour reuses the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    params = GRAPH_FORMS[form]()
    grid, state = build_problem(synthetic_catchment(0, n=48, radius=22.0), 4.0, params,
                                "cuda")
    device_loop.reset_counts()
    g_out, g_stats, g_reads, g_launches = _graph_hour(params, grid, state, False)
    e_out, e_stats, e_reads, e_launches = _graph_hour(params, grid, state, True)
    again = _graph_hour(params, grid, state, False)
    counts = device_loop.counts()
    assert g_stats == e_stats == again[1]
    assert float(g_out.balance_whole.mbr) == float(e_out.balance_whole.mbr)
    assert torch.equal(g_out.h, e_out.h) and torch.equal(again[0].h, g_out.h)
    assert g_launches == e_launches == again[3]
    assert (g_launches > 0) == (form == "bundle")
    assert counts["graph_periods"] == 2 and counts["eager_periods"] == 1
    assert counts["captures"] == 1
    assert counts["launches"] == 2 * g_reads and g_reads * 20 <= e_reads


# tests/test_torch_device_loop.py's forced branches (its BRANCHES' settings;
# that file imports JAX): the parameters of each float64 step
GRAPH_BRANCHES = {
    "courant_cut": dict(),
    "diverged": dict(delta_t_min=60.0),
    "restore": dict(delta_t_min=60.0, delta_t_max=60.0, mbr_threshold=1e-8,
                    max_approximations=3),
    "fatal_nan": dict(delta_t_min=60.0, delta_t_max=60.0),
}


def _branch_step(branch, device, eager: bool):
    """One float64 step (per-sweep Jacobi, at most 600 s) on that test's
    grid (tests/test_catchment3d.py's 12 valley of 10 m cells,
    tests/test_torch_core.py's soil, 0.6 m deep) forced down ``branch``:
    0.3 m ponded over psi -0.5 m (a
    surface Courant number far past 1), else 20 mm/h of rain over psi
    -1 m, with a NaN on one surface cell for the fatal NaN (the caller
    scales the sweep norms for a divergence). Returns the new state, dt,
    (attempts, approximations, sweeps), dt_curr, the restores and the
    drivers' counts."""
    import contextlib
    from criteria3d_tpu_torch import Grid, SoilFields, WaterState, initialize_balance
    from criteria3d_tpu_torch.problems import storm_state
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import step as TSt
    params = SolverParameters(**GRAPH_BRANCHES[branch])
    n = 12
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8
    soil = SoilFields.uniform(dem.shape, device=device, vg_alpha=1.2, vg_n=1.5,
                              vg_he=0.02, theta_s=0.41, theta_r=0.04, k_sat=5e-6)
    grid = Grid.build(dem, 10.0, soil, total_depth=0.6, device=device)
    if branch == "courant_cut":
        state = initialize_balance(grid, params, WaterState.initialize(
            grid, params, matric_potential=-0.5, surface_water=0.3, device=device))
    else:
        state = storm_state(grid, params, psi0=-1.0, rain=0.020)
    if branch == "fatal_nan":
        r, c = (int(v) for v in torch.nonzero(grid.mask[0])[0])
        state.sink_source[0, r, c] = float("nan")
    TSt.restore_best_step.count = 0
    device_loop.reset_counts()
    with device_loop.forced_eager() if eager else contextlib.nullcontext():
        st, dt, stats, _, dt_curr = TSt._compute_step(grid, params, state, 600.0)
    return (st, dt, stats, dt_curr, TSt.restore_best_step.count, device_loop.counts(),
            params)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(GRAPH_BRANCHES))
def test_graph_driver_replays_rare_branches(branch, monkeypatch):
    """Each rare branch of the step (the Courant cut, a halving on
    divergence, the restore of the best iterate, the fatal NaN) through the
    graph driver's replay against the eager driver on the card: the same
    dt, (attempts, approximations, sweeps), dt_curr and restores (the
    graph's counted on the card), heads and balance bit-equal, and the
    branch taken (the eager step calls the Courant cut's decimal floor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import step as TSt
    from criteria3d_tpu_torch.solver import water as TW
    calls = []
    floor = TSt._decimal_floor_dt
    monkeypatch.setattr(TSt, "_decimal_floor_dt", lambda dt: calls.append(1) or floor(dt))
    if branch == "diverged":
        # every sweep's norm scaled by 1e12: the first sweep of every solve
        # diverges, halving dt down to delta_t_min
        sweep = TW.jacobi_sweep_sum
        monkeypatch.setattr(TW, "jacobi_sweep_sum",
                            lambda *a: (lambda x, n: (x, n * 1e12))(*sweep(*a)))
    device_loop.clear()
    g = _branch_step(branch, "cuda", False)
    calls.clear()
    e = _branch_step(branch, "cuda", True)
    device_loop.clear()
    assert g[5]["graph_periods"] == 1 and e[5]["eager_periods"] == 1
    assert g[1:5] == e[1:5], (g[1:5], e[1:5])
    (gs, es), params = (g[0], e[0]), g[6]
    assert torch.equal(gs.h, es.h) and torch.equal(gs.best_h, es.best_h)
    for f in ("storage", "sink_source", "mbe", "mbr"):
        a, b = getattr(gs.balance_current, f), getattr(es.balance_current, f)
        assert torch.equal(a, b) or (bool(a.isnan()) and bool(b.isnan())), f
    dt, stats, dt_curr, restores = g[1:5]
    assert bool(calls) == (branch == "courant_cut")
    if branch == "courant_cut":
        assert dt_curr < 600.0 and stats[0] > 1
    elif branch == "diverged":
        assert stats[0] > 1 and dt == 60.0
    elif branch == "restore":
        assert restores > 0
    else:
        assert stats == (1, 1, params.max_iterations_for(0))
        assert bool(gs.balance_current.mbr.isnan())


@pytest.mark.cuda
def test_graph_driver_step_and_units_make_no_host_sync():
    """compute_step graph-driven equals the eager step; and every unit of
    the machine, run eagerly under torch.cuda.set_sync_debug_mode("error"),
    makes no host synchronisation (the driver's status reads outside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch import compute_step
    from criteria3d_tpu_torch.device import host_array
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import step as TSt
    params = SolverParameters.fast_f32(use_pallas=True)
    grid, state = build_problem(synthetic_catchment(0, n=32, radius=14.0), 4.0, params,
                                "cuda")
    g_state, g_dt = compute_step(grid, params, state, 3600.0)
    with device_loop.forced_eager():
        e_state, e_dt = compute_step(grid, params, state, 3600.0)
    assert g_dt == e_dt and torch.equal(g_state.h, e_state.h)
    m = TSt._Machine(grid, params, state, False)
    m.load(state, 600.0, 0.0)
    units, seen = m.units(), set()
    status = host_array(m.status)
    while status[0] != TSt.DONE:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            units[int(status[0])][1]()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen.add(int(status[0]))
        status = host_array(m.status)
    assert {TSt.START, TSt.ASSEMBLE, TSt.SOLVE_INIT, TSt.SOLVE, TSt.SOLVE_END,
            TSt.EVALUATE, TSt.ATTEMPT_END, TSt.ACCEPT} <= seen


# ----------------------------------------------------------------------
# the coupled period's state machine as CUDA graphs (solver/coupled.py)
# ----------------------------------------------------------------------

COUPLED_GRAPH_FORMS = {
    "f64": lambda **kw: SolverParameters(heat_vapor=True, **kw),
    "frozen": lambda **kw: SolverParameters.fast_f32(heat_vapor=True,
                                                     heat_frozen_props=True, **kw),
    "bundle": lambda **kw: SolverParameters.fast_f32(use_pallas=True, heat_vapor=True,
                                                     heat_frozen_props=True, **kw),
}

# tests/test_torch_coupled_machine.py's forced branches (that file imports
# JAX): (form, parameter overrides, net irradiance [W/m2], period [s],
# max_substeps) on its 12 box
COUPLED_GRAPH_BRANCHES = {
    "halving": ("frozen", {}, 80.0, 1200.0, 256),
    "accept_as_is": ("f64", dict(delta_t_min=30.0), 80.0, 1200.0, 256),
    "courant_chunk": ("exact", {}, 600.0, 600.0, 256),
    "cache_rebuild": ("exact", {}, 80.0, 1200.0, 256),
    "max_substeps": ("f64", {}, 600.0, 600.0, 2),
}


def _coupled_inputs(params, n, irradiance=80.0, device="cuda"):
    """The bench's coupled storm (problems.build_coupled_problem's forcing,
    ``irradiance`` W/m2) on an n x n box of the synthetic catchment (seed 3,
    the disc's radius 0.45 n): problems.coupled_box."""
    from criteria3d_tpu_torch import problems as TP
    return TP.coupled_box(params, device, n, irradiance)


def _coupled_period(params, inputs, period, eager: bool, max_substeps: int = 256):
    """One coupled period on the card by the graph driver (or the eager
    one): (water, heat, counts, host reads, bundle launches, drivers'
    counts, peak GiB)."""
    import contextlib
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CP.reset_counts()
    device_loop.reset_counts()
    host_read.count = 0
    before = TB.jacobi_bundle.launches
    with device_loop.forced_eager() if eager else contextlib.nullcontext():
        w, h = CP.compute_period_coupled(inputs[0], params, *inputs[1:], period,
                                         max_substeps=max_substeps)
    torch.cuda.synchronize()
    return (w, h, CP.counts(), host_read.count, TB.jacobi_bundle.launches - before,
            device_loop.counts(), torch.cuda.max_memory_allocated() / 2**30)


def _assert_coupled_same(g, e):
    assert g[2] == e[2], (g[2], e[2])
    assert torch.equal(g[0].h, e[0].h) and torch.equal(g[1].t, e[1].t)
    for a, b in ((g[0].balance_whole.mbr, e[0].balance_whole.mbr), (g[1].mbr, e[1].mbr),
                 (g[1].sink_whole, e[1].sink_whole)):
        assert torch.equal(a, b)
    assert g[4] == e[4]
    assert g[5]["graph_periods"] == 1 and e[5]["eager_periods"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(COUPLED_GRAPH_FORMS))
def test_graph_driver_coupled_hour_matches_eager(form):
    """A coupled storm hour on a 32 box of the card in the float64, frozen
    and bundle forms, graph-driven and eager-driven: every count equal, h,
    T and both balances bit-equal (the same kernels in the same order), the
    same bundle launches (some in the bundle form); the graph hour's host
    reads at most 5 % of the eager hour's, its peak at most 2 x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.solver import device_loop
    params = COUPLED_GRAPH_FORMS[form]()
    inputs = _coupled_inputs(params, 32)
    device_loop.clear()
    g = _coupled_period(params, inputs, 3600.0, False)
    device_loop.clear()
    e = _coupled_period(params, inputs, 3600.0, True)
    _assert_coupled_same(g, e)
    assert (g[4] > 0) == (form == "bundle")
    assert g[5]["captures"] == 1 and g[3] * 20 <= e[3], (g[3], e[3])
    assert g[6] <= 2.0 * e[6], (g[6], e[6])


@pytest.mark.cuda
@pytest.mark.parametrize("branch", list(COUPLED_GRAPH_BRANCHES))
def test_graph_driver_replays_coupled_rare_branches(branch):
    """The heat sub-stepping's rare branches (tests/test_torch_coupled_machine.py's
    cases, on its 12 box) through the graph driver's replay against the
    eager driver on the card: every count equal, h, T and balances
    bit-equal, and the branch taken as the counts show it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.solver import device_loop
    form, kw, irradiance, period, max_substeps = COUPLED_GRAPH_BRANCHES[branch]
    make = COUPLED_GRAPH_FORMS.get(form) or (
        lambda **k: SolverParameters.fast_f32(heat_vapor=True, **k))
    params = make(**kw)
    inputs = _coupled_inputs(params, 12, irradiance)
    device_loop.clear()
    g = _coupled_period(params, inputs, period, False, max_substeps)
    e = _coupled_period(params, inputs, period, True, max_substeps)
    device_loop.clear()
    _assert_coupled_same(g, e)
    counts = g[2]
    if branch in ("halving", "cache_rebuild"):
        assert counts["substeps_rejected"] > 0
    elif branch == "accept_as_is":
        assert counts["substeps_rejected"] == 0
    elif branch == "courant_chunk":
        assert counts["chunks"] > counts["steps"]
    else:
        assert counts["chunks"] == max_substeps * counts["steps"]


@pytest.mark.cuda
def test_coupled_units_make_no_host_sync():
    """compute_step_coupled graph-driven equals the eager step; and every
    unit of the coupled machine (frozen and exact mode), run eagerly under
    torch.cuda.set_sync_debug_mode("error"), makes no host synchronisation
    (the driver's status reads outside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.device import host_array
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    exact = SolverParameters.fast_f32(heat_vapor=True)
    for params in (COUPLED_GRAPH_FORMS["frozen"](), exact):
        inputs = _coupled_inputs(params, 12, 600.0)
        gw, gh, gdt = CP.compute_step_coupled(inputs[0], params, *inputs[1:], 1200.0)
        with device_loop.forced_eager():
            ew, eh, edt = CP.compute_step_coupled(inputs[0], params, *inputs[1:], 1200.0)
        device_loop.clear()
        assert gdt == edt and torch.equal(gw.h, ew.h) and torch.equal(gh.t, eh.t)
        m = CP._CoupledMachine(inputs[0], params, *inputs[1:], False, 256)
        m.load(*inputs[1:], 1200.0)
        units, seen = m.units(), set()
        status = host_array(m.status)
        while status[0] != CP.DONE:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                units[int(status[0])][1]()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seen.add(int(status[0]))
            status = host_array(m.status)
        want = {CP.STEP_START, CP.WATER_END, CP.CHUNK, CP.SUBSTEP, CP.SWEEP,
                CP.SUBSTEP_END, CP.CHUNK_END, CP.STEP_END, CP.PERIOD_END}
        if params is exact:
            want.add(CP.REBUILD)
        assert want <= seen, want - seen


@pytest.mark.cuda
def test_coupled_model_hours_capture_once():
    """Two consecutive coupled model hours (``compute_heat``, every layer-1
    node a HeatSurface, a fresh HeatBoundary each hour) on a 32 box of the
    card: both graph-driven, one capture, the graph machine's launches and
    host reads few; the second hour against the same hour eager-driven
    from the same model state: h and T bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    import copy
    from criteria3d_tpu_torch.model import ModelConfig
    from criteria3d_tpu_torch.problems import (MODEL_CONFIG, build_model_problem,
                                               model_day_forcing, synthetic_catchment)
    from criteria3d_tpu_torch.solver import device_loop
    params = COUPLED_GRAPH_FORMS["frozen"]()
    model = build_model_problem(synthetic_catchment(0, n=32, radius=32 * 366.0 / 768), 4.0,
                                params, "cuda", ModelConfig(compute_heat=True,
                                                            **MODEL_CONFIG))
    device_loop.clear()
    device_loop.reset_counts()
    model.run_hour(model_day_forcing(model.grid, None, 10), 2023, 3, 21, 10)
    twin = copy.copy(model)
    model.run_hour(model_day_forcing(model.grid, None, 11), 2023, 3, 21, 11)
    counts = device_loop.counts()
    assert counts["graph_periods"] == 2 and counts["captures"] == 1
    assert counts["eager_periods"] == 0
    with device_loop.forced_eager():
        twin.run_hour(model_day_forcing(twin.grid, None, 11), 2023, 3, 21, 11)
    device_loop.clear()
    assert torch.equal(model.water.h, twin.water.h) and torch.equal(model.heat.t, twin.heat.t)


@pytest.mark.cuda
def test_constants_made_under_a_capture_are_not_kept():
    """ops.const and Grid.astype keep nothing made while a CUDA graph
    captures: such a tensor holds its value only once the graph replays, so
    a kept one would give another graph, or eager code, an unfilled
    constant (a coupled machine's first unit read conductances from one).
    Made outside a capture they are kept and serve captures too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch import ops
    from criteria3d_tpu_torch.problems import catchment_grid, synthetic_catchment
    grid = catchment_grid(synthetic_catchment(0, n=16, radius=7.0), 4.0, "cuda")
    value = 1234.5678
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        inside = ops.const(value, torch.float64, grid.device)
        cast = grid.astype(torch.float16)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    outside = ops.const(value, torch.float64, grid.device)
    assert outside is not inside and float(outside) == value
    assert ops.const(value, torch.float64, grid.device) is outside
    assert grid.astype(torch.float16) is not cast
    assert grid.astype(torch.float16) is grid.astype(torch.float16)
    graph.replay()
    torch.cuda.synchronize()
    assert float(inside) == value


# ----------------------------------------------------------------------
# the partitioned periods on one card's blocks and the fixed points, as
# CUDA graphs against the eager driver
# ----------------------------------------------------------------------

def _driven(run, eager: bool):
    """``run()`` on the card under the graph driver (or the eager one), the
    kept machines dropped and every count set to 0 before it: (result,
    host reads, bundle launches, coupled counts, the drivers' counts, peak
    GiB)."""
    import contextlib
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    device_loop.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    device_loop.reset_counts()
    CP.reset_counts()
    host_read.count = 0
    before = TB.jacobi_bundle.launches
    with device_loop.forced_eager() if eager else contextlib.nullcontext():
        out = run()
    torch.cuda.synchronize()
    res = (out, host_read.count, TB.jacobi_bundle.launches - before, CP.counts(),
           device_loop.counts(), torch.cuda.max_memory_allocated() / 2**30)
    device_loop.clear()
    return res


def _card_mesh():
    from criteria3d_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(4, devices=[torch.device("cuda")] * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(GRAPH_FORMS))
def test_graph_driver_on_blocks_matches_eager(form):
    """The water hour of a 64-box catchment on 2 x 2 blocks of the card,
    twice graph-driven (the second run on the kept machine) and once
    eager-driven on the same blocks: the same stats, MBR and bundle
    launches, heads bit-equal; one capture, the graph hours' host reads at
    most 5 % of the eager hour's, the peak at most 2 x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch import compute_period_stats
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    mesh = _card_mesh()
    params = dataclasses.replace(GRAPH_FORMS[form](), mesh=mesh)
    grid, state = build_problem(synthetic_catchment(0, n=64, radius=30.0), 4.0,
                                GRAPH_FORMS[form](), "cuda")
    grid, state = shard_pytree(grid, mesh), shard_pytree(state, mesh)
    assert device_loop.driver_for(mesh.home, mesh) == ("graph", "")
    def hour():
        return compute_period_stats(grid, params, state, 3600.0)
    g = _driven(lambda: [hour(), hour()], False)
    e = _driven(hour, True)
    eo, es = e[0]
    assert g[2] == 2 * e[2] and (e[2] > 0) == (form == "bundle")
    for go, gs in g[0]:
        assert tuple(gs) == tuple(es)
        assert torch.equal(go.balance_whole.mbr, eo.balance_whole.mbr)
        assert torch.equal(gather_pytree(go).h, gather_pytree(eo).h)
    assert g[4]["graph_periods"] == 2 and g[4]["captures"] == 1
    assert e[4]["eager_periods"] == 1 and g[1] * 10 <= e[1], (g[1], e[1])
    assert g[5] <= 2.0 * e[5], (g[5], e[5])


@pytest.mark.cuda
@pytest.mark.parametrize("form,machines", [("bundle", (0, 1, 2, 3)), ("bundle", (0, 0, 1, 1)),
                                           ("cg_line", (0, 1, 2, 3)), ("f64", (0, 1, 2, 3))],
                         ids=["bundle-4", "bundle-2", "cg_line-4", "f64-4"])
def test_machines_on_one_card_match_one_machine(form, machines):
    """The water hour of a 64-box catchment on 2 x 2 blocks of the card
    split into 4 (or 2) machines, run in rounds twice (the second on the
    kept machines), each machine on its own stream with the rounds
    enqueued from the host, as on several cards, against one machine over
    the same blocks graph-driven: the same stats, MBR and bundle launches,
    heads bit-equal; one capture; host reads one a batch of rounds, as
    many batches as the rounds run need (a batch ends early once the last
    segment has run)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch import compute_period_stats
    from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh, remesh,
                                                        shard_pytree)
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    one = _card_mesh()
    split = make_mesh(4, devices=[torch.device("cuda")] * 4, machines=machines)
    grid, state = build_problem(synthetic_catchment(0, n=64, radius=30.0), 4.0,
                                GRAPH_FORMS[form](), "cuda")
    grid, state = shard_pytree(grid, one), shard_pytree(state, one)
    assert device_loop.driver_for(split.home, split) == ("rounds", "")

    def hour(mesh, n):
        params = dataclasses.replace(GRAPH_FORMS[form](), mesh=mesh)
        g, s = remesh(grid, mesh), remesh(state, mesh)
        return [compute_period_stats(g, params, s, 3600.0) for _ in range(n)]
    r = _driven(lambda: hour(split, 2), False)
    o = _driven(lambda: hour(one, 1), False)
    oo, os_ = o[0][0]
    assert r[2] == 2 * o[2] and (o[2] > 0) == (form == "bundle")
    for ro, rs in r[0]:
        assert tuple(rs) == tuple(os_)
        assert torch.equal(ro.balance_whole.mbr, oo.balance_whole.mbr)
        assert torch.equal(gather_pytree(ro).h, gather_pytree(oo).h)
    assert r[4]["rounds_periods"] == 2 and r[4]["captures"] == 1
    assert r[1] == r[4]["launches"] >= 2, (r[1], r[4])
    per_hour = r[4]["rounds"] // 2
    assert r[4]["launches"] == 2 * -(-per_hour // device_loop.UNITS_PER_LAUNCH), r[4]
    assert per_hour <= r[4]["rounds_enqueued"] // 2 < per_hour + device_loop.UNITS_PER_LAUNCH


@pytest.mark.cuda
@pytest.mark.parametrize("machines", [None, (0, 1, 2, 3)], ids=["one", "rounds"])
def test_profiled_hour_on_blocks_runs_clean(machines):
    """A graph-driven bundle hour of a 64-box catchment on 2 x 2 blocks of
    the card under torch.profiler (one machine, or 4 in rounds; one such
    profiled run faulted with an illegal memory access at full size once,
    PERF.md section 7): no fault, the stats of the same hour unprofiled,
    and the profiler's device events counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from torch.profiler import ProfilerActivity, profile
    from criteria3d_tpu_torch import compute_period_stats
    from criteria3d_tpu_torch.parallel.sharding import make_mesh, shard_pytree
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    mesh = make_mesh(4, devices=[torch.device("cuda")] * 4, machines=machines)
    params = dataclasses.replace(GRAPH_FORMS["bundle"](), mesh=mesh)
    grid, state = build_problem(synthetic_catchment(0, n=64, radius=30.0), 4.0,
                                GRAPH_FORMS["bundle"](), "cuda")
    grid, state = shard_pytree(grid, mesh), shard_pytree(state, mesh)
    device_loop.clear()
    _, plain = compute_period_stats(grid, params, state, 1800.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, stats = compute_period_stats(grid, params, state, 1800.0)
        torch.cuda.synchronize()
    device_loop.clear()
    events = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    print(f"profiled 2 x 2 bundle hour, machines {machines}: {events} device events")
    assert tuple(stats) == tuple(plain) and events > 0


@pytest.mark.cuda
def test_graph_driver_coupled_hour_on_blocks_matches_eager():
    """The frozen coupled storm hour of a 32 valley (cell 10 m) on 2 x 2
    blocks of the card, twice graph-driven (the second run on the kept
    machine) and once eager-driven on the same blocks: every count and both
    balances equal, h and T bit-equal; one capture, the graph hours' host
    reads at most 5 % of the eager hour's, the peak at most 2 x."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.problems import build_coupled_problem
    from criteria3d_tpu_torch.solver import coupled as CP
    n = 32
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8
    mesh = _card_mesh()
    params = COUPLED_GRAPH_FORMS["frozen"](mesh=mesh)
    inputs = build_coupled_problem(dem, 10.0, COUPLED_GRAPH_FORMS["frozen"](), "cuda")
    blocked = [shard_pytree(t, mesh) for t in inputs]
    def hour():
        return CP.compute_period_coupled(blocked[0], params, *blocked[1:], 3600.0)
    g = _driven(lambda: [hour(), hour()], False)
    e = _driven(hour, True)
    ew, eh = e[0]
    assert g[3] == {k: 2 * v for k, v in e[3].items()} and e[3]["heat_sweeps"] > 0
    assert g[2] == e[2] == 0
    for gw, gh in g[0]:
        for a, b in ((gw.balance_whole.mbr, ew.balance_whole.mbr), (gh.mbr, eh.mbr),
                     (gh.sink_whole, eh.sink_whole)):
            assert torch.equal(a, b)
        assert torch.equal(gather_pytree(gw).h, gather_pytree(ew).h)
        assert torch.equal(gather_pytree(gh).t, gather_pytree(eh).t)
    assert g[4]["graph_periods"] == 2 and g[4]["captures"] == 1
    assert e[4]["eager_periods"] == 1 and g[1] * 10 <= e[1], (g[1], e[1])
    assert g[5] <= 2.0 * e[5], (g[5], e[5])


@pytest.mark.cuda
@pytest.mark.parametrize("form,machines", [("frozen", (0, 1, 2, 3)), ("frozen", (0, 0, 1, 1)),
                                           ("bundle", (0, 1, 2, 3))],
                         ids=["frozen-4", "frozen-2", "bundle-4"])
def test_coupled_machines_on_one_card_match_one_machine(form, machines):
    """The coupled storm hour of a 32 valley (cell 10 m) on 2 x 2 blocks of
    the card split into 4 (or 2) machines, run in rounds (each machine on
    its own stream), against one machine over the same blocks graph-driven:
    every count (the heat sweeps counted once, not once a machine), the
    bundle launches and both balances equal, h and T bit-equal; one
    capture; host reads one a batch of rounds, as many batches as the
    rounds run need."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh, remesh,
                                                        shard_pytree)
    from criteria3d_tpu_torch.problems import build_coupled_problem
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    n = 32
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8
    one = _card_mesh()
    split = make_mesh(4, devices=[torch.device("cuda")] * 4, machines=machines)
    make = COUPLED_GRAPH_FORMS[form]
    blocked = [shard_pytree(t, one)
               for t in build_coupled_problem(dem, 10.0, make(), "cuda")]
    assert device_loop.driver_for(split.home, split) == ("rounds", "")

    def hour(mesh):
        b = [remesh(t, mesh) for t in blocked]
        return CP.compute_period_coupled(b[0], make(mesh=mesh), *b[1:], 3600.0)
    r = _driven(lambda: hour(split), False)
    o = _driven(lambda: hour(one), False)
    assert r[3] == o[3] and o[3]["heat_sweeps"] > 0, (r[3], o[3])
    assert r[2] == o[2] and (o[2] > 0) == (form == "bundle")
    (rw, rh), (ow, oh) = r[0], o[0]
    for a, b in ((rw.balance_whole.mbr, ow.balance_whole.mbr), (rh.mbr, oh.mbr),
                 (rh.sink_whole, oh.sink_whole)):
        assert torch.equal(a, b)
    assert torch.equal(gather_pytree(rw).h, gather_pytree(ow).h)
    assert torch.equal(gather_pytree(rh).t, gather_pytree(oh).t)
    assert r[4]["rounds_periods"] == 1 and r[4]["captures"] == 1
    rounds = r[4]["rounds"]
    assert r[1] == r[4]["launches"] == -(-rounds // device_loop.UNITS_PER_LAUNCH), r[4]


@pytest.mark.cuda
def test_units_on_blocks_make_no_host_sync():
    """Every unit of the float64 water machine and of the coupled machine on
    2 x 2 blocks of the card (the ring-refresh units among them), run
    eagerly under torch.cuda.set_sync_debug_mode("error"), makes no host
    synchronisation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.device import host_array
    from criteria3d_tpu_torch.parallel.sharding import shard_pytree
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import step as TSt

    def run_units(m):
        units, seen = m.units(), set()
        status = host_array(m.status)
        while status[0] != m.DONE:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                units[int(status[0])][1]()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            seen.add(int(status[0]))
            status = host_array(m.status)
        return seen
    mesh = _card_mesh()
    grid, state = build_problem(synthetic_catchment(0, n=32, radius=14.0), 4.0,
                                SolverParameters(), "cuda")
    grid, state = shard_pytree(grid, mesh), shard_pytree(state, mesh)
    m = TSt._Machine(grid, SolverParameters(mesh=mesh), state, False)
    m.load(state, 600.0, 0.0)
    assert {TSt.SOLVE, TSt.X_EXCHANGE, TSt.SOLVE_END} <= run_units(m)
    frozen = COUPLED_GRAPH_FORMS["frozen"]
    blocked = [shard_pytree(t, mesh) for t in _coupled_inputs(frozen(), 16)]
    mc = CP._CoupledMachine(blocked[0], frozen(mesh=mesh), *blocked[1:], False, 256)
    mc.load(*blocked[1:], 1200.0)
    assert {CP.SWEEP, CP.H_EXCHANGE, CP.SUBSTEP_END} <= run_units(mc)


@pytest.mark.cuda
@pytest.mark.parametrize("n,period", [(12, 1200.0), (32, 1800.0)], ids=["12", "32"])
def test_exact_f32_coupled_on_card(n, period):
    """ROADMAP C5: the float32 exact-mode coupled period
    (``fast_f32(heat_vapor=True, heat_frozen_props=False)``, whose rejected
    sub-steps rebuild the energy cache) on the 12 box of the forced
    cache-rebuild case and on a 32 box: graph-driven against eager-driven
    on the card, every count equal, h, T and both balances bit-equal;
    against the CPU h within 1e-4 m and T within 1.5e-2 K (the fast exact
    periods' bar against JAX, tests/test_torch_coupled_machine.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    from criteria3d_tpu_torch.solver import coupled as CP
    params = SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=False)
    inputs = _coupled_inputs(params, n)
    g = _coupled_period(params, inputs, period, False)
    e = _coupled_period(params, inputs, period, True)
    _assert_coupled_same(g, e)
    assert g[2]["substeps_rejected"] > 0
    cpu = _coupled_inputs(params, n, device="cpu")
    CP.reset_counts()
    cw, ch = CP.compute_period_coupled(cpu[0], params, *cpu[1:], period)
    assert float((g[0].h.cpu() - cw.h).abs().max()) <= 1e-4
    assert float((g[1].t.cpu() - ch.t).abs().max()) <= 1.5e-2


def _recorded(module, name, stops):
    """``module.name`` replaced by a wrapper recording each call's per-cell
    stops; returns the original, to put back."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        *out, info = orig(*args, return_stop=True, **kw)
        stops.append(info)
        return tuple(out)
    wrapper.iterations = wrapper.calls = 0
    setattr(module, name, wrapper)
    return orig


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["hydrall", "vine"])
def test_fixed_points_graph_driven_match_eager(side, tmp_path):
    """A daylight hour of a 16-box HYDRALL model (2 fixed-point calls) and
    of a 16-box vineyard project (4 calls, cells that run to max_iter
    among them) on the card, graph-driven and eager-driven from the same
    state: every call graph-driven in one launch, the outputs and every
    call's stop iterations and |dASS| equal; the vineyard hour's host reads
    a few against the eager hour's hundreds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    import copy
    import datetime
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.solver import device_loop
    if side == "hydrall":
        from criteria3d_tpu_torch.physics import hydrall as module
        from criteria3d_tpu_torch.problems import model_day_forcing, small_hydrall_model
        name, calls = "photosynthesis_kernel", 2
        model = small_hydrall_model(SolverParameters.fast_f32(), "cuda", n=16)
        forcing = model_day_forcing(model.grid, None, 12)
        when = (2023, 3, 21, 12)
    else:
        from criteria3d_tpu_torch.physics import vine_photosynthesis as module
        from criteria3d_tpu_torch.problems import (VINE_DATE, seed_vine_canopy,
                                                   write_vine_project)
        from criteria3d_tpu_torch.vine3d_project import Vine3DProject
        name, calls = "photosynthesis_kernel_simplified", 4
        ini = write_vine_project(str(tmp_path / "v16"), n=16, seed=0)
        prj = Vine3DProject.load(ini, output_dir=str(tmp_path / "out"))
        prj.initialize(fast=True, device="cuda")
        seed_vine_canopy(prj.model)
        model = prj.model
        forcing = prj.hourly_forcing(datetime.datetime(*VINE_DATE, 12))
        when = (*VINE_DATE, 12)
    twin = copy.copy(model)
    runs = []
    for m, eager in ((model, False), (twin, True)):
        stops = []
        orig = _recorded(module, name, stops)
        try:
            out = _driven(lambda: m.run_hour(forcing, *when), eager)
        finally:
            setattr(module, name, orig)
        runs.append((out, stops))
    (g, gs), (e, es) = runs
    assert len(gs) == len(es) == calls
    for a, b in zip(gs, es):
        assert torch.equal(a["stop"], b["stop"]) and torch.equal(a["d_ass"], b["d_ass"])
        assert a["iterations"] == b["iterations"]
    for k, v in e[0].items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(g[0][k], v), k
    assert g[4]["graph_fixed_points"] == calls and g[4]["eager_fixed_points"] == 0
    assert e[4]["eager_fixed_points"] == calls
    if side == "vine":
        assert max(int(s["iterations"]) for s in gs) > 100
        assert g[1] * 20 <= e[1], (g[1], e[1])


# ----------------------------------------------------------------------
# the water assembly's kernel pair (csrc/assemble_fast.cu) against the chain
# ----------------------------------------------------------------------

# case -> (parameter overrides, grid edits, hooks, how the call is made)
ASSEMBLE_CASES = {
    "storm768-approx0": dict(storm=True, approx=0),
    "storm768-approx1": dict(storm=True, approx=1),
    "vg-arithmetic": dict(params=dict(wrc_model=0, mean_type=0)),
    "vg-geometric": dict(params=dict(wrc_model=0, mean_type=1)),
    "vg-logarithmic": dict(params=dict(wrc_model=0, mean_type=2)),
    "mvg-arithmetic": dict(params=dict(mean_type=0)),
    "mvg-geometric": dict(params=dict(mean_type=1)),
    "mvg-logarithmic": dict(params=dict(mean_type=2), approx=1),
    "culvert-compat": dict(culvert=True),
    "culvert-plain": dict(culvert=True, params=dict(culvert_reference_compat=False)),
    "prescribed": dict(prescribed=True),
    "courant-plain": dict(params=dict(courant_reference_compat=False)),
    "hook-frozen": dict(hooks="frozen"),
    "hook-closure": dict(hooks="closure"),
    "blocks-2x2": dict(blocks=True, approx=1),
    "graph-replay": dict(graph=True),
    "hour-water": dict(hour="water"),
    "hour-coupled": dict(hour="coupled"),
}


def _assemble_inputs(case, seed=7):
    """The assembly's inputs on the card: the storm cell's catchment (768
    box) at its initial storm state, or a 70-box catchment (not a multiple
    of the kernel's tiles) in a seeded state that takes every branch:
    ponded and dry surface cells, saturated and unchanged soil nodes, sinks
    of both signs, and the case's culverts or prescribed nodes."""
    from criteria3d_tpu_torch.core.soil import MeanType, WRCModel
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import water as TW
    over = dict(case.get("params", {}))
    if "wrc_model" in over:
        over["wrc_model"] = WRCModel(over["wrc_model"])
    if "mean_type" in over:
        over["mean_type"] = MeanType(over["mean_type"])
    params = SolverParameters.fast_f32(**over)
    if case.get("storm"):
        grid, state = build_problem(synthetic_catchment(0), 4.0, params, "cuda")
        psi = torch.where(grid.mask, state.h - grid.z, 0.0).float()
        return params, grid, psi, psi.clone(), TW.compute_se_psi(grid, params, psi), \
            state.sink_source, state.pond
    n = 70
    grid, state = build_problem(synthetic_catchment(seed, n=n, radius=32.0), 4.0, params,
                                "cuda")
    rng = np.random.default_rng(seed)
    valid = np.argwhere(grid.mask[0].cpu().numpy())
    picks = [tuple(int(v) for v in valid[k]) for k in rng.choice(len(valid), 6, replace=False)]
    if case.get("culvert"):
        for (r, c), hh in zip(picks, (0.05, 0.1, 0.2, 0.4, 0.08, 0.15)):
            grid = grid.set_culvert(r, c, roughness=0.013, slope=0.02, width=0.5, height=hh)
    if case.get("prescribed"):
        z = grid.z.cpu().numpy()
        for k, (r, c) in enumerate(picks):
            layer = 1 + k % (grid.n_layers - 1)
            grid = grid.set_prescribed(layer, r, c, float(z[layer, r, c]) + (-2.0, 0.5)[k % 2])
    shape = tuple(grid.mask.shape)
    psi = rng.uniform(-3.0, 0.2, shape)
    psi[0] = rng.uniform(-0.02, 0.06, shape[1:])
    psi[psi > 0.1] = 0.0                                  # saturated soil
    for (r, c), v in zip(picks, (0.5, 0.3, 0.12, 0.07, 0.02, 0.0)):
        psi[0, r, c] = v                                  # culverts' levels
    step = np.where(rng.random(shape) < 0.3, 0.0, rng.normal(0.0, 0.05, shape))
    step[rng.random(shape) < 0.1] *= 1e-4                 # below the secant's resolution
    mask = grid.mask.cpu().numpy()
    f32 = lambda a: torch.tensor(np.where(mask, a, 0.0), dtype=torch.float32, device="cuda")
    psi_t, psi_old = f32(psi), f32(psi + step)
    sink = rng.uniform(-2e-5, 2e-5, shape)
    sink[0] = rng.uniform(-2e-4, 1e-3, shape[1:])
    pond = torch.tensor(rng.uniform(0.0, 0.004, shape[1:]), dtype=torch.float64, device="cuda")
    return (params, grid, psi_t, psi_old, TW.compute_se_psi(grid, params, psi_t),
            torch.tensor(sink, dtype=torch.float64, device="cuda"), pond)


def _assemble_hooks(kind, grid):
    """A frozen thermal flux (a buffer, as the coupled step's frozen mode
    hands it), or closures that read psi and k and a boundary sink."""
    if kind is None:
        return {}
    g = torch.Generator(device="cuda").manual_seed(3)
    if kind == "frozen":
        buf = torch.randn(grid.mask.shape, generator=g, device="cuda",
                          dtype=torch.float64) * 1e-6
        return dict(extra_flux_fn=lambda psi, k: buf)
    scale = torch.rand(grid.mask.shape, generator=g, device="cuda", dtype=torch.float64)
    return dict(extra_flux_fn=lambda psi, k: (k.double() * 3.0 - psi.double() * 1e-7),
                boundary_flux_fn=lambda psi, dt: -1e-6 * scale * torch.clamp_min(
                    psi.double(), 0.0) / dt)


def _same_bits(a, b, name):
    assert a.dtype == b.dtype and a.shape == b.shape, name
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    diff = (a.view(view) != b.view(view)).sum().item()
    assert diff == 0, f"{name}: {diff} values differ"


def _assert_assembly_same(kern, chain):
    (sk, wk, rk, kk), (sc, wc, rc, kc) = kern, chain
    for f in ("b", "c_up", "c_down", "c_lat", "diag", "courant"):
        _same_bits(getattr(sk, f), getattr(sc, f), f)
    for name, x, y in (("water_flow", wk, wc), ("rate", rk, rc), ("k", kk, kc)):
        _same_bits(x, y, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ASSEMBLE_CASES))
def test_assemble_kernel_matches_chain(name):
    """On the card: assemble_fast's kernel pair against its plain chain
    (assemble_fast_reference) on the same CUDA tensors, bit for bit in b,
    c_up, c_down, c_lat, diag, the Courant number, the water flow, the rate
    and k, over the branches (both retention models, the three means,
    culverts under both compat flags, prescribed nodes, the Courant
    truncation off), the hooks, each grown block of a 2 x 2 partition, and
    replays of a captured CUDA graph (counted on the card); one launch a
    call. And the benchmark cells' graph-driven storm hours with the
    kernels: the counts the chain gave, one launch per assemble unit and
    restore."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels run only on the card")
    from criteria3d_tpu_torch.device import tallies_on_device
    from criteria3d_tpu_torch.solver import water as TW
    case = ASSEMBLE_CASES[name]
    if case.get("hour"):
        _storm_hour_counts(case["hour"])
        return
    params, grid, psi, psi_old, se, sink, pond = _assemble_inputs(case)
    hooks = _assemble_hooks(case.get("hooks"), grid)
    approx = case.get("approx", 0)
    dt = torch.tensor(300.0, dtype=torch.float64, device="cuda")
    approx_t = torch.tensor(approx, dtype=torch.int64, device="cuda")
    before = TW.assemble_fast.launches
    if case.get("blocks"):
        from criteria3d_tpu_torch.parallel.sharding import shard_pytree
        mesh = _card_mesh()
        blocks = [shard_pytree(t, mesh).blocks for t in (grid, psi, psi_old, se, sink, pond)]
        for idx in np.ndindex(blocks[0].shape):
            g, *arrays = (b[idx] for b in blocks)
            _assert_assembly_same(TW.assemble_fast(g, params, *arrays, approx_t, dt),
                                  TW.assemble_fast_reference(g, params, *arrays, approx_t, dt))
        assert TW.assemble_fast.launches == before + 4
        return
    if case.get("graph"):
        out = TW.assemble_fast(grid, params, psi, psi_old, se, sink, pond, approx_t, dt)
        out = (out[0]._replace(courant=None), *out[1:])
        slot = torch.zeros((), dtype=torch.int64, device="cuda")
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), \
                tallies_on_device({(TW.assemble_fast, "launches"): slot}):
            graph.capture_begin()
            got = TW.assemble_fast(grid, params, psi, psi_old, se, sink, pond, approx_t, dt,
                                   out=out)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        rng = np.random.default_rng(11)
        for k, a in enumerate((1, 0, 2)):
            psi.add_(torch.tensor(rng.normal(0.0, 0.01, psi.shape), dtype=torch.float32,
                                  device="cuda") * grid.mask)
            approx_t.fill_(a)
            dt.fill_(120.0 * (k + 1))
            graph.replay()
            torch.cuda.synchronize()
            _assert_assembly_same(got, TW.assemble_fast_reference(
                grid, params, psi, psi_old, se, sink, pond, approx_t, dt))
        assert int(slot) == 3 and TW.assemble_fast.launches == before + 1
        return
    for a, d in ((approx, 300.0), (approx_t, dt)):
        kern = TW.assemble_fast(grid, params, psi, psi_old, se, sink, pond, a, d, **hooks)
        chain = TW.assemble_fast_reference(grid, params, psi, psi_old, se, sink, pond, a, d,
                                           **hooks)
        torch.cuda.synchronize()
        _assert_assembly_same(kern, chain)
    assert TW.assemble_fast.launches == before + 2
    if name == "courant-plain":
        assert float(chain[0].courant) > 0.0


def _storm_hour_counts(cell):
    """The benchmark cell's storm hour (the 768-box catchment, fast_f32,
    graph-driven) with the assembly's kernels: the counts the eager chain
    gave (water: 528 CG iterations, 164 assemblies; coupled: 477, 139 and
    5,513 heat sweeps), and one kernel launch per assemble unit and
    restore."""
    from criteria3d_tpu_torch import compute_period_stats
    from criteria3d_tpu_torch.problems import build_problem, coupled_storm, synthetic_catchment
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import step as TSt
    from criteria3d_tpu_torch.solver import water as TW
    kw = dict(heat_vapor=True, heat_frozen_props=True) if cell == "coupled" else {}
    params = SolverParameters.fast_f32(**kw)
    grid, water = build_problem(synthetic_catchment(0), 4.0, params, "cuda")
    before, restores = TW.assemble_fast.launches, TSt.restore_best_step.count
    CP.reset_counts()
    with device_loop.unit_clock() as clock:
        if cell == "coupled":
            grid, water, heat, boundary = coupled_storm(grid, params, water)
            CP.compute_period_coupled(grid, params, water, heat, boundary, 3600.0)
            cnt = CP.counts()
            iters, sweeps = cnt["inner_iterations"], cnt["heat_sweeps"]
        else:
            _, stats = compute_period_stats(grid, params, water, 3600.0)
            iters, sweeps = stats[3], None
    torch.cuda.synchronize()
    assembles = clock.units()["assemble"][0]
    expected = {"water": (528, 164, None), "coupled": (477, 139, 5513)}[cell]
    assert (iters, assembles, sweeps) == expected
    assert TW.assemble_fast.launches - before == assembles + (
        TSt.restore_best_step.count - restores)
    device_loop.clear()
