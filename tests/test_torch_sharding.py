"""The port's device mesh against the JAX package's: the mesh factorisation,
padding, the decomposition checks, the halo exchange, the mesh form of the
bundled-Jacobi loop and a whole sharded step.

The JAX side runs on the virtual 8-device CPU mesh of tests/conftest.py,
with the Pallas kernel in interpret mode, as tests/test_sharding.py runs
it; the port's mesh is 8 CPU blocks (``make_mesh(8, devices=[cpu] * 8)``),
on which each block runs the kernel's plain twin.
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
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states
from tests.test_torch_cuda import seeded_system

torch.set_num_threads(1)

CPU = torch.device("cpu")
K = TB.SWEEPS_PER_BUNDLE


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
    assert placed.h.device == mesh.home and torch.equal(placed.h, valley32["ts"].h)


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
    xm, dm, nm = TB.jacobi_solve_loop(*t, max_iter, 1e-7, jg.n_nodes, mesh=mesh)
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
    x = 0 and a norm of 0, whatever x held there."""
    arrays = [torch.from_numpy(a) for a in seeded_system((5, 16, 32), seed=11)]
    for a in arrays[:5]:
        a[..., 24:] = 0.0
    mesh = cpu_mesh(2, 4)
    system = TB.mesh_system(*arrays[:5], mesh)
    xh = TS.halo_exchange(TS.split_blocks(arrays[5], mesh), K, mesh)
    for i in range(2):
        x, norm = TB.jacobi_bundle(*(s[i, 3] for s in system), xh[i, 3], K=K, halo=K)
        assert not bool(x[:, K:-K, K:-K].any()) and float(norm) == 0.0
    xs, total = TB.mesh_bundle(system, TS.split_blocks(arrays[5], mesh), mesh)
    assert not bool(xs[0, 3].any()) and float(total) > 0.0


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
    sout, sdt = T.compute_step(tg, T.SolverParameters.fast_f32(use_pallas=True),
                               ts, 3600.0)
    mbr = float(tout.balance_current.mbr)
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0, atol=1e-5)
    assert float(tdt) == float(jdt)
    assert mbr == pytest.approx(float(jout.balance_current.mbr), abs=1e-6)
    np.testing.assert_allclose(tout.h.numpy(), sout.h.numpy(), rtol=0, atol=1e-5)
    assert float(tdt) == float(sdt)
    assert mbr == pytest.approx(float(sout.balance_current.mbr), abs=1e-8)


def test_padded_uneven_domain():
    """A 20 valley padded to 32 over (2, 4), so the last column of blocks
    is all nodata, against the unpadded single-device port run: h within
    1e-5 m on the original cells, dt equal."""
    n = 20
    dem = valley_dem(n)
    mesh = TS.make_mesh(8, devices=[CPU] * 8)

    def run(dem_arr, mesh):
        params = T.SolverParameters.fast_f32(use_pallas=True, mesh=mesh)
        soil = T.SoilFields.uniform(dem_arr.shape, vg_alpha=1.2, vg_n=1.5,
                                    vg_he=0.02, theta_s=0.41, theta_r=0.04,
                                    k_sat=5e-6, device="cpu")
        grid = T.Grid.build(dem_arr, 10.0, soil, total_depth=0.6, device="cpu")
        state = T.initialize_balance(grid, params, T.WaterState.initialize(
            grid, params, matric_potential=-1.0, device="cpu"))
        sink = torch.zeros_like(state.sink_source)
        sink[0] = torch.where(grid.mask[0], torch.full_like(
            sink[0], 0.020 * float(grid.area) / 3600.0), 0.0)
        state = dataclasses.replace(state, sink_source=sink)
        if mesh is not None:
            grid, state = TS.shard_pytree(grid, mesh), TS.shard_pytree(state, mesh)
        out, dt = T.compute_step(grid, params, state, 3600.0)
        return out.h.numpy(), float(dt)

    h_ref, dt_ref = run(dem, None)
    dem_pad = TS.pad_to_multiple(dem, 2 * 16, 4 * 8)
    assert dem_pad.shape == (32, 32) and (dem_pad[:, 24:] == -9999.0).all()
    h_pad, dt_pad = run(dem_pad, mesh)
    np.testing.assert_allclose(h_pad[:, :n, :n], h_ref, rtol=0, atol=1e-5)
    assert dt_pad == dt_ref


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
