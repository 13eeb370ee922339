"""The port's device mesh against the JAX package's: the mesh factorisation,
padding, the decomposition checks, the halo exchange, the mesh form of the
bundled-Jacobi loop and the partitioned water step in its three forms.

The JAX side runs on the virtual 8-device CPU mesh of tests/conftest.py,
with the Pallas kernel in interpret mode, as tests/test_sharding.py runs
it; the port's mesh is 8 CPU blocks (``make_mesh(8, devices=[cpu] * 8)``),
on which each block runs the kernel's plain twin. The partitioned step is
also held against the port's own whole-box step over (2, 4), (1, 4),
(4, 1) and (2, 2) blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import criteria3d_tpu as J
from criteria3d_tpu.parallel import sharding as JS
from criteria3d_tpu.solver import pallas_jacobi as JP
from criteria3d_tpu.solver import water as JW
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel import sharding as TS
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from criteria3d_tpu_torch.solver import step as TSt
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import SOIL, build_grids, rain_states
from tests.test_torch_cuda import seeded_system

torch.set_num_threads(1)

CPU = torch.device("cpu")
K = TB.SWEEPS_PER_BUNDLE
MESHES = [(2, 4), (1, 4), (4, 1), (2, 2)]
# the three forms of the water step: the bundle (through the kernel's plain
# version), CG with the line preconditioner, and the float64 parity path
FORMS = {"bundle": dict(use_pallas=True), "cg_line": {}, "f64": None}


def form_params(form: str, pkg=T, **kw):
    if FORMS[form] is None:
        return pkg.SolverParameters(**kw)
    return pkg.SolverParameters.fast_f32(**FORMS[form], **kw)


def cpu_mesh(rows: int, cols: int) -> TS.Mesh:
    devices = np.empty((rows, cols), dtype=object)
    devices[...] = CPU
    return TS.Mesh(devices)


def jax_mesh(rows: int, cols: int) -> JMesh:
    return JMesh(np.asarray(jax.devices()[:rows * cols]).reshape(rows, cols),
                 ("row", "col"))


@pytest.fixture(scope="module")
def valley32():
    """The 32 valley of tests/test_sharding.py's Pallas case in both
    packages: grids, the rain states (20 mm/h, psi0 = -1 m) and the
    assembled float32 system of a 600 s step."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(32))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    psi = jnp.where(jg.mask, js.h - jg.z, 0.0).astype(jnp.float32)
    se = JW.compute_se_psi(jg, jp, psi)
    system, *_ = JW.assemble_fast(jg, jp, psi, psi, se, js.sink_source, js.pond,
                                  jnp.asarray(0, jnp.int32), jnp.asarray(600.0))
    mask_f = jg.mask.astype(jnp.float32)
    arrays = [np.array(a) for a in (system.b, system.c_up, system.c_down,
                                    system.c_lat, mask_f, psi)]
    return dict(jg=jg, tg=tg, js=js, ts=ts, arrays=arrays)


# ----------------------------------------------------------------------
# (a) the mesh, (b) padding and the decomposition checks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    mesh = TS.make_mesh(n, devices=[CPU] * 8)
    assert mesh.shape == dict(JS.make_mesh(n).shape)
    assert mesh.devices.shape == (mesh.shape["row"], mesh.shape["col"])
    assert mesh.home == CPU


@pytest.mark.parametrize("shape,mult", [((13, 13), (2, 4)), ((20, 20), (32, 32)),
                                        ((16, 24), (2, 4)), ((7, 30), (4, 1))])
def test_pad_to_multiple_matches_jax(shape, mult):
    dem = valley_dem(max(shape))[:shape[0], :shape[1]]
    t = TS.pad_to_multiple(dem, *mult)
    j = JS.pad_to_multiple(dem, *mult)
    assert t.shape == j.shape and t.dtype == j.dtype
    assert t.tobytes() == j.tobytes()


def test_unshardable_domain_raises(valley32):
    """A 13 box over (2, 4) raises (naming pad_to_multiple), as JAX's
    shard_pytree does; (L, 1, 1) and scalar leaves are replicated."""
    _, tg = build_grids(valley_dem(13))
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="pad"):
        TS.shard_pytree(tg, mesh)
    with pytest.raises(ValueError, match="pad"):
        TS.replicate_pytree(tg, mesh)
    assert not TS.check_shardable(torch.zeros(7, 1, 1), mesh)
    assert not TS.check_shardable(torch.zeros(()), mesh)
    assert TS.check_shardable(valley32["tg"].mask, mesh)
    placed = TS.shard_pytree(valley32["ts"], mesh)
    assert placed.dt_curr.device == mesh.home
    whole = TS.gather_pytree(placed)
    assert whole.h.device == mesh.home and torch.equal(whole.h, valley32["ts"].h)


def test_block_smaller_than_halo_raises():
    """A block side below K along an axis with neighbours raises, naming
    the side and K (JAX's slice of K cells fails there too); a 1-block axis
    is a plain zero pad at any side."""
    a = torch.zeros(2, 12, 24)
    with pytest.raises(ValueError, match=r"block side of 6 .* k = 8"):
        TS.halo_exchange(TS.split_blocks(a, cpu_mesh(2, 4)), 8, cpu_mesh(2, 4))
    grown = TS.halo_exchange(TS.split_blocks(a, cpu_mesh(1, 4)), 2, cpu_mesh(1, 4))
    assert tuple(grown[0, 0].shape) == (2, 16, 10)


# ----------------------------------------------------------------------
# (c) the halo exchange
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(2,), (3, 2)], ids=["3d", "4d"])
@pytest.mark.parametrize("rows,cols", [(2, 4), (1, 4), (4, 1)])
def test_halo_exchange_matches_windows_and_jax(rows, cols, lead):
    """Every grown block bit-equal to the numpy zero-padded window and to
    JAX's halo_exchange under shard_map (blocks interleaved in its
    output), corners included."""
    k = 2
    R, C = 4 * rows, 4 * cols
    a = np.arange(np.prod(lead) * R * C, dtype=np.float32).reshape(*lead, R, C) + 1.0
    mesh = cpu_mesh(rows, cols)
    grown = TS.halo_exchange(TS.split_blocks(torch.from_numpy(a), mesh), k, mesh)

    jm = jax_mesh(rows, cols)
    spec = P(*(None,) * len(lead), "row", "col")
    out = np.asarray(shard_map(lambda x: JS.halo_exchange(x, k, jm), mesh=jm,
                               in_specs=spec, out_specs=spec, check_vma=False)(
        jnp.asarray(a)))
    padded = np.pad(a, [(0, 0)] * len(lead) + [(k, k), (k, k)])
    lr, lc = R // rows, C // cols
    for (i, j), g in np.ndenumerate(grown):
        assert g.is_contiguous()
        window = padded[..., i * lr:i * lr + lr + 2 * k, j * lc:j * lc + lc + 2 * k]
        blk = out[..., i * (lr + 2 * k):(i + 1) * (lr + 2 * k),
                  j * (lc + 2 * k):(j + 1) * (lc + 2 * k)]
        np.testing.assert_array_equal(g.numpy(), window)
        np.testing.assert_array_equal(g.numpy(), blk)
    assert torch.equal(TS.join_blocks(TS.split_blocks(torch.from_numpy(a), mesh), mesh),
                       torch.from_numpy(a))


# ----------------------------------------------------------------------
# (d) the mesh loop; (e) the sharded step; (f) a padded uneven domain
# ----------------------------------------------------------------------

@pytest.mark.parametrize("approx", [0, 9])
def test_mesh_loop_matches_jax_and_single_device(valley32, approx):
    """On the assembled 32-valley system, over (2, 4): against JAX's
    shard_map loop the same n_it and divergence flag, x to rel 1e-5 of its
    largest value (f32 norm sums in another order); against the port's
    single-device loop x bit-equal (the same arithmetic per cell), the same
    n_it and one host read per bundle in both."""
    jg, arrays = valley32["jg"], valley32["arrays"]
    max_iter = T.SolverParameters.fast_f32(use_pallas=True).max_iterations_for(approx)
    xj, dj, nj = JP.jacobi_solve_loop(*(jnp.asarray(a) for a in arrays), max_iter,
                                      1e-7, jg.n_nodes, mesh=JS.make_mesh(8))
    t = [torch.from_numpy(a) for a in arrays]
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    host_read.count = 0
    xm, dm, nm = TB.jacobi_solve_loop(*(TS.shard_pytree(a, mesh) for a in t), max_iter,
                                      1e-7, jg.n_nodes, mesh=mesh)
    xm = TS.gather_pytree(xm)
    reads_mesh, host_read.count = host_read.count, 0
    xs, ds, ns = TB.jacobi_solve_loop(*t, max_iter, 1e-7, jg.n_nodes)
    assert nm == int(nj) and dm == bool(dj)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xm.numpy(), xj, rtol=1e-5,
                               atol=1e-5 * float(np.abs(xj).max()))
    assert torch.equal(xm, xs) and (nm, dm) == (ns, ds)
    assert reads_mesh == host_read.count == nm // K


def test_masked_block_gives_zero():
    """A block whose every cell is masked (a padded column of blocks) gives
    x = 0 on its owned cells and a norm of 0, whatever x held there."""
    arrays = [torch.from_numpy(a) for a in seeded_system((5, 16, 32), seed=11)]
    for a in arrays[:5]:
        a[..., 24:] = 0.0
    mesh = cpu_mesh(2, 4)
    system = tuple(TS.shard_pytree(a, mesh) for a in arrays[:5])
    xh = TS.shard_pytree(arrays[5], mesh)
    for i in range(2):
        x, norm = TB.jacobi_bundle(*(s.blocks[i, 3] for s in system), xh.blocks[i, 3],
                                   K=K, halo=K)
        assert not bool(TS.owned(x, K).any()) and float(norm) == 0.0
    xs, total = TB.mesh_bundle(system, xh)
    assert not bool(TS.owned(xs.blocks[0, 3], K).any()) and float(total) > 0.0


def test_sharded_step_matches_jax(valley32):
    """compute_step under fast_f32(use_pallas=True, mesh) on the case of
    test_sharded_pallas_matches_single_device. Against JAX's sharded step:
    h within 1e-5 m, dt equal, MBR within 1e-6 (the port's float32 step is
    held to JAX's at 1e-6, tests/test_torch_step.py: here the unsharded
    steps are 7.1e-7 apart). Against the port's unsharded step, JAX's own
    sharded-vs-single bar: h within 1e-5 m, dt equal, MBR within 1e-8."""
    jg, js, tg, ts = (valley32[k] for k in ("jg", "js", "tg", "ts"))
    jm = JS.make_mesh(8)
    jout, jdt = J.compute_step(JS.shard_pytree(jg, jm),
                               J.SolverParameters.fast_f32(use_pallas=True, mesh=jm),
                               JS.shard_pytree(js, jm), 3600.0)
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    tout, tdt = T.compute_step(TS.shard_pytree(tg, mesh),
                               T.SolverParameters.fast_f32(use_pallas=True, mesh=mesh),
                               TS.shard_pytree(ts, mesh), 3600.0)
    tout = TS.gather_pytree(tout)
    sout, sdt = T.compute_step(tg, T.SolverParameters.fast_f32(use_pallas=True),
                               ts, 3600.0)
    mbr = float(tout.balance_current.mbr)
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0, atol=1e-5)
    assert float(tdt) == float(jdt)
    assert mbr == pytest.approx(float(jout.balance_current.mbr), abs=1e-6)
    np.testing.assert_allclose(tout.h.numpy(), sout.h.numpy(), rtol=0, atol=1e-5)
    assert float(tdt) == float(sdt)
    assert mbr == pytest.approx(float(sout.balance_current.mbr), abs=1e-8)


def port_case(form: str, dem: np.ndarray):
    """The port's grid and rain state (20 mm/h, psi0 = -1 m) on ``dem``,
    initialised under ``form``'s parameters, on the CPU."""
    params = form_params(form)
    grid = T.Grid.build(dem, 10.0, T.SoilFields.uniform(dem.shape, device="cpu", **SOIL),
                        total_depth=0.6, device="cpu")
    state = T.initialize_balance(grid, params, T.WaterState.initialize(
        grid, params, matric_potential=-1.0, device="cpu"))
    sink = torch.zeros_like(state.sink_source)
    sink[0] = torch.where(grid.mask[0], torch.full_like(
        sink[0], 0.020 * float(grid.area) / 3600.0), 0.0)
    return grid, dataclasses.replace(state, sink_source=sink)


def padded_step(form: str):
    """A 20 valley padded to 32 over (2, 4), so the last column of blocks
    is all nodata, against the unpadded whole-box port step: heads and dt."""
    n = 20
    dem = valley_dem(n)
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    grid, state = port_case(form, dem)
    ref, dt_ref = T.compute_step(grid, form_params(form), state, 3600.0)
    dem_pad = TS.pad_to_multiple(dem, 2 * 16, 4 * 8)
    assert dem_pad.shape == (32, 32) and (dem_pad[:, 24:] == -9999.0).all()
    grid, state = port_case(form, dem_pad)
    out, dt_pad = T.compute_step(TS.shard_pytree(grid, mesh), form_params(form, mesh=mesh),
                                 TS.shard_pytree(state, mesh), 3600.0)
    return TS.gather_pytree(out).h[:, :n, :n], ref.h, float(dt_pad), float(dt_ref)


def test_padded_uneven_domain():
    """The padded 20 valley under the bundle: h within 1e-5 m on the
    original cells, dt equal."""
    h_pad, h_ref, dt_pad, dt_ref = padded_step("bundle")
    np.testing.assert_allclose(h_pad.numpy(), h_ref.numpy(), rtol=0, atol=1e-5)
    assert dt_pad == dt_ref


@pytest.mark.parametrize("form", ["cg_line", "f64"])
def test_padded_uneven_domain_cg_and_f64(form):
    """The padded 20 valley under CG line and the float64 path: dt equal,
    heads within 1e-5 m (float32) or 1e-9 m (float64) on the original
    cells."""
    h_pad, h_ref, dt_pad, dt_ref = padded_step(form)
    atol = 1e-9 if form == "f64" else 1e-5
    np.testing.assert_allclose(h_pad.numpy(), h_ref.numpy(), rtol=0, atol=atol)
    assert dt_pad == dt_ref


# ----------------------------------------------------------------------
# (g) the partitioned step in its three forms against the whole box and
# against JAX's GSPMD step; (h) what it refuses
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def whole_runs():
    """Each form's whole-box compute_step and one-hour compute_period_stats
    on the 32 valley, with the hour's host reads."""
    runs = {}
    for form in FORMS:
        grid, state = port_case(form, valley_dem(32))
        params = form_params(form)
        step, dt = T.compute_step(grid, params, state, 3600.0)
        host_read.count = 0
        hour, stats = T.compute_period_stats(grid, params, state, 3600.0)
        runs[form] = dict(grid=grid, state=state, step=step, dt=dt, hour=hour,
                          stats=stats, reads=host_read.count)
    return runs


# each form's hour on the 32 valley: (steps, attempts, approximations,
# inner iterations) and the eager driver's host reads, as the port gave them
# before per-sweep Jacobi's ring refresh became a unit of the machine (the
# float64 hour's 1,607 sweeps are no multiple of RING)
PARENT_HOURS = {"bundle": ((16, 17, 47, 1360), 265), "cg_line": ((16, 17, 48, 68), 212),
                "f64": ((16, 17, 48, 1607), 1704)}


@pytest.mark.parametrize("shape", MESHES, ids=[f"{r}x{c}" for r, c in MESHES])
@pytest.mark.parametrize("form", list(FORMS))
def test_partitioned_step_matches_whole_box(whole_runs, form, shape):
    """compute_step and a one-hour compute_period_stats on blocks of the
    32 valley, gathered, against the port's whole-box runs: identical stats,
    dt and host reads, the ones the port gave before the ring refresh
    became a unit (PARENT_HOURS); float32 heads bit-equal (the stats agree,
    and every cell does the whole box's arithmetic), float64 heads within
    1e-9 m; MBR within 1e-8 (the float64 sums of the balance add in another
    order)."""
    ref = whole_runs[form]
    mesh = cpu_mesh(*shape)
    params = form_params(form, mesh=mesh)
    grid, state = TS.shard_pytree(ref["grid"], mesh), TS.shard_pytree(ref["state"], mesh)
    step, dt = T.compute_step(grid, params, state, 3600.0)
    host_read.count = 0
    hour, stats = T.compute_period_stats(grid, params, state, 3600.0)
    reads = host_read.count
    step, hour = TS.gather_pytree(step), TS.gather_pytree(hour)
    assert dt == ref["dt"] and tuple(stats) == tuple(ref["stats"]) and reads == ref["reads"]
    assert (tuple(stats), reads) == PARENT_HOURS[form]
    for out, whole, bal in ((step, ref["step"], "balance_current"),
                            (hour, ref["hour"], "balance_whole")):
        if form == "f64":
            np.testing.assert_allclose(out.h.numpy(), whole.h.numpy(), rtol=0, atol=1e-9)
        else:
            assert torch.equal(out.h, whole.h)
        assert float(getattr(out, bal).mbr) == pytest.approx(
            float(getattr(whole, bal).mbr), abs=1e-8)


# per-sweep Jacobi's ring refresh, a unit the phase guards: (parameters,
# the form the rain state is initialised under) of a 600 s period on the 32
# valley whose one solve takes 25 sweeps, so it ends between two refreshes
RING_FORMS = {"f64": (lambda **m: T.SolverParameters(**m), "f64"),
              "f32_jacobi": (lambda **m: T.SolverParameters.fast_f32(inner_solver="jacobi",
                                                                      **m), "cg_line")}
RING_MESHES = [(2, 2), (1, 4), (2, 4)]


@pytest.mark.parametrize("shape", RING_MESHES, ids=[f"{r}x{c}" for r, c in RING_MESHES])
@pytest.mark.parametrize("form", list(RING_FORMS))
def test_ring_refresh_unit_keeps_the_parents_counts(form, shape, monkeypatch):
    """A 600 s period of per-sweep Jacobi (float64 and float32) on blocks of
    the 32 valley under the eager driver: its one solve of 25 sweeps
    refreshes x's rings after sweeps 8, 16 and 24 and at its end (the
    ring-refresh unit, 4 exchanges); the stats and host reads are the ones
    the port gave when a host counter refreshed them ((1, 1, 1, 25) and 28)
    and the whole box's; float32 heads bit-equal to the whole box's,
    float64 within 1e-9 m."""
    make, init = RING_FORMS[form]
    grid, state = port_case(init, valley_dem(32))
    host_read.count = 0
    whole, stats = T.compute_period_stats(grid, make(), state, 600.0)
    assert (tuple(stats), host_read.count) == ((1, 1, 1, 25), 28)
    mesh = cpu_mesh(*shape)
    exchanges = []

    def counted(x):
        exchanges.append(1)
        return TS.exchange(x)
    monkeypatch.setattr(TSt, "exchange", counted)
    host_read.count = 0
    out, stats_m = T.compute_period_stats(TS.shard_pytree(grid, mesh), make(mesh=mesh),
                                          TS.shard_pytree(state, mesh), 600.0)
    assert (tuple(stats_m), host_read.count) == ((1, 1, 1, 25), 28)
    assert len(exchanges) == 4
    h = TS.gather_pytree(out).h
    if form == "f64":
        np.testing.assert_allclose(h.numpy(), whole.h.numpy(), rtol=0, atol=1e-9)
    else:
        assert torch.equal(h, whole.h)


@pytest.mark.parametrize("f64", [False, True], ids=["cg_diag", "f64_cg"])
def test_partitioned_link_flows_match_whole_box(f64):
    """track_link_flow on (2, 4) blocks, 600 s of the 32 valley under
    fast_f32(cg_precond="diag") and the float64 CG path: link_flow_sum
    and every link_flows getter, gathered, against the whole box's:
    float32 bit-equal (the flows are per-cell sums of heads and
    conductances that are bit-equal); float64 within 1e-9 of the largest
    |flow| (float64 CG's dot products add per-block partials, so its heads
    differ by ulps: 1.4e-14 m, the flows by 6.7e-15 of 1.1e-2 m3, on the
    CPU)."""
    from criteria3d_tpu_torch.solver import link_flows as LF
    kw = dict(track_link_flow=True)
    make = ((lambda **m: T.SolverParameters(inner_solver="cg", **kw, **m)) if f64
            else (lambda **m: T.SolverParameters.fast_f32(cg_precond="diag", **kw, **m)))
    grid, state = port_case("f64" if f64 else "cg_line", valley_dem(32))
    state = dataclasses.replace(state, link_flow_sum=torch.zeros(
        (10,) + tuple(state.h.shape), dtype=state.h.dtype))
    whole, _ = T.compute_period_stats(grid, make(), state, 600.0)
    mesh = cpu_mesh(2, 4)
    out, _ = T.compute_period_stats(TS.shard_pytree(grid, mesh), make(mesh=mesh),
                                    TS.shard_pytree(state, mesh), 600.0)
    scale = float(whole.link_flow_sum.abs().max())
    assert scale > 0

    def same(a, b):
        if f64:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9 * scale)
        else:
            assert torch.equal(a, b)
    same(TS.gather_pytree(out).link_flow_sum, whole.link_flow_sum)
    for getter in (LF.up_flow, LF.down_flow, LF.max_lateral_flow, LF.sum_lateral_flow,
                   LF.sum_lateral_flow_in, LF.sum_lateral_flow_out):
        same(TS.gather_pytree(getter(out)), getter(whole))


@pytest.mark.parametrize("form", ["cg_line", "f64"])
def test_partitioned_step_matches_jax(valley32, form):
    """compute_step under CG line and the float64 path on 8 CPU blocks
    against JAX's GSPMD-partitioned step on its 8 virtual devices: dt
    equal; float32 heads within 1e-5 m, float64 heads and MBR within 1e-9.
    The float32 MBR is held within 2e-6, not the 1e-6 of
    test_sharded_step_matches_jax: with no partition at all, the port's
    whole-box CG-line step is 1.09e-6 from JAX's on this valley (heads,
    se, k and pond bit-equal; the storage of the step's float32 balance
    differs by 3.6e-4 m3 of 2.0e4, the ulps of float32 per-cell theta,
    divided by a 330 m3 sink), and the partition adds 0.0 to that."""
    jp, tp = form_params(form, J), form_params(form)
    jg, tg = valley32["jg"], valley32["tg"]
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    jm = JS.make_mesh(8)
    jout, jdt = J.compute_step(JS.shard_pytree(jg, jm), jp, JS.shard_pytree(js, jm),
                               3600.0)
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    tout, tdt = T.compute_step(TS.shard_pytree(tg, mesh), form_params(form, mesh=mesh),
                               TS.shard_pytree(ts, mesh), 3600.0)
    tout = TS.gather_pytree(tout)
    tol_h, tol_mbr = (1e-9, 1e-9) if form == "f64" else (1e-5, 2e-6)
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0, atol=tol_h)
    assert float(tdt) == float(jdt)
    assert float(tout.balance_current.mbr) == pytest.approx(
        float(jout.balance_current.mbr), abs=tol_mbr)


@pytest.mark.parametrize("form", list(FORMS))
def test_nothing_whole_inside_the_step(whole_runs, form, monkeypatch):
    """A 600 s compute_period_stats on (2, 4) blocks with join_blocks,
    split_blocks and gather_pytree made to raise: the step never builds a
    whole field. Every tensor of the returned grid and state is its
    block's tile with its ring, on its block's device (the grid's (L, 1, 1),
    (8, 1, 1) and 0-d fields replicated), apart from the 0-d balances,
    dt_curr and courant on mesh.home."""
    ref = whole_runs[form]
    mesh = cpu_mesh(2, 4)
    grid, state = TS.shard_pytree(ref["grid"], mesh), TS.shard_pytree(ref["state"], mesh)

    def refuse(*args, **kwargs):
        raise AssertionError("a whole field was built inside the step")
    for name in ("join_blocks", "split_blocks", "gather_pytree"):
        monkeypatch.setattr(TS, name, refuse)
    out, stats = T.compute_period_stats(grid, form_params(form, mesh=mesh), state, 600.0)
    assert stats[0] > 0
    tile = (32 // 2 + 2 * K, 32 // 4 + 2 * K)
    for (i, j), g in np.ndenumerate(grid.blocks):
        for t in TS._leaves(g):
            assert t.device == mesh.devices[i, j]
            assert tuple(t.shape[-2:]) in (tile, (1, 1)) or t.dim() < 2
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        if isinstance(v, TS.Blocked):
            assert v.mesh is mesh
            for (i, j), t in np.ndenumerate(v.blocks):
                assert tuple(t.shape[-2:]) == tile and t.device == mesh.devices[i, j]
        else:
            leaves = [v] if isinstance(v, torch.Tensor) else TS._leaves(v)
            assert f.name in ("link_flow_sum", "dt_curr", "courant") or \
                f.name.startswith("balance_")
            for t in leaves:
                assert t.device == mesh.home and (t.dim() == 0 or t.numel() == 0)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{r}x{c}" for r, c in MESHES])
def test_shard_and_gather_round_trip(valley32, shape):
    """shard_pytree then gather_pytree gives back the grid and state bit for
    bit; every tile is its window of the zero-padded field (the fill past
    the global edge that shift2d reads: False for the mask, 0 else)."""
    mesh = cpu_mesh(*shape)
    tg, ts = valley32["tg"], valley32["ts"]
    gs, ss = TS.shard_pytree(tg, mesh), TS.shard_pytree(ts, mesh)
    for whole, back in ((tg, TS.gather_pytree(gs)), (ts, TS.gather_pytree(ss))):
        a, b = TS._leaves(whole), TS._leaves(back)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    r, c = 32 // shape[0], 32 // shape[1]
    pad = torch.nn.functional.pad(tg.mask, (K, K, K, K))
    zpad = torch.nn.functional.pad(ts.h, (K, K, K, K))
    for (i, j), g in np.ndenumerate(gs.blocks):
        window = (slice(None), slice(i * r, i * r + r + 2 * K), slice(j * c, j * c + c + 2 * K))
        assert torch.equal(g.mask, pad[window]) and torch.equal(ss.h.blocks[i, j], zpad[window])
        assert g.n_nodes == tg.n_nodes and g.has_culvert == tg.has_culvert


def test_mesh_configurations_it_does_not_run_raise(valley32):
    """No fallback: a whole grid with params.mesh, a blocked one without,
    use_pallas on the float64 path, and a block side below the ring raise
    ValueError."""
    tg, ts = valley32["tg"], valley32["ts"]
    mesh = cpu_mesh(2, 4)
    gs, ss = TS.shard_pytree(tg, mesh), TS.shard_pytree(ts, mesh)
    cases = [
        (tg, T.SolverParameters.fast_f32(mesh=mesh), ts, "shard_pytree"),
        (gs, T.SolverParameters.fast_f32(), ss, "gather_pytree"),
        (gs, T.SolverParameters(use_pallas=True, mesh=mesh), ss, "float32"),
    ]
    for grid, params, state, match in cases:
        with pytest.raises(ValueError, match=match):
            T.compute_step(grid, params, state, 600.0)
    # 8 rows of 4 cells: a block side below the ring of K = 8
    with pytest.raises(ValueError, match="smaller than the halo"):
        TS.shard_pytree(tg, cpu_mesh(8, 1))


def test_dryrun_mesh():
    """scaling_bench.dryrun_mesh, the counterpart of dryrun_multichip's
    shard_map leg: one hour on 2 x 4 CPU blocks of a 128 box closes mass
    (|MBR| < 1e-2) in the same steps, approximations and sweeps as the
    hour on one device."""
    from criteria3d_tpu_torch import scaling_bench
    from criteria3d_tpu_torch.problems import SMALL_SOIL, build_problem
    out = scaling_bench.dryrun_mesh(8, "cpu")
    assert out["shape"][1:] == (128, 128) and abs(out["mbr"]) < 1e-2
    params = T.SolverParameters.fast_f32(use_pallas=True)
    grid, state = build_problem(scaling_bench.sloped_dem(128, 128), 10.0, params, "cpu",
                                total_depth=0.6, min_thickness=0.02, max_thickness=0.1,
                                max_thickness_depth=0.4, soil=SMALL_SOIL, psi0=-1.0,
                                rain=0.010)
    _, stats = T.compute_period_stats(grid, params, state, 3600.0)
    assert tuple(stats) == tuple(out["stats"])


def test_scaling_bench_legs():
    """scaling_bench.scaling times the legs of scripts/scaling_bench.py
    under its keys ("1": SolverParameters() on one device, "<n>": the same
    step over n blocks, "<n>_pallas": the bundle over them) and the
    bundle on one device as "1_pallas"; each mesh leg's efficiency is its
    one-device leg's step time over its own, per card."""
    from criteria3d_tpu_torch import scaling_bench
    out = scaling_bench.scaling(16, 16, 4, "cpu")
    legs = out["devices"]
    assert set(legs) == {"1", "4", "4_pallas", "1_pallas"}
    assert out["grid"][1:] == [16, 16] and out["platform"] == "cpu"
    for one, mesh_leg in (("1", "4"), ("1_pallas", "4_pallas")):
        assert legs[one]["efficiency"] == 1.0
        assert legs[mesh_leg]["mesh"] == {"row": 2, "col": 2} and legs[mesh_leg]["devices"] == 1
        assert legs[mesh_leg]["efficiency"] == pytest.approx(
            legs[one]["step_s"] / legs[mesh_leg]["step_s"])
        for leg in (one, mesh_leg):
            assert legs[leg]["nodes_per_s"] == pytest.approx(
                out["n_nodes"] / legs[leg]["step_s"])
