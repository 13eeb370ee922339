"""The bundled Jacobi kernel's plain twin and the solve loop against the
JAX package's Pallas kernel (run in interpret mode on the CPU, as the JAX
package's own tests run it), plus the wrapper's checks. The CUDA kernel
itself is held against the plain twin in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import pallas_jacobi as JP
from criteria3d_tpu.solver import water as JW
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states
from tests.test_torch_cuda import seeded_system

torch.set_num_threads(1)

ULP = 2.0 ** -23


@pytest.mark.parametrize("shape", [(5, 37, 45), (11, 10, 10)])
def test_bundle_reference_matches_pallas(shape):
    """x to 4 ulp of max|x| (same sweeps and term order; XLA may contract
    a multiply-add); the norm to rel 1e-5 (f32 sums in another order)."""
    arrays = seeded_system(shape, seed=sum(shape))
    xj, nj = JP.jacobi_bundle(*(jnp.asarray(a) for a in arrays))
    xt, nt = TB.jacobi_bundle_reference(*(torch.from_numpy(a) for a in arrays))
    xj = np.asarray(xj)
    assert xt.dtype == torch.float32 and xt.shape == shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=4 * ULP * float(np.abs(xj).max()))
    assert float(nt) == pytest.approx(float(nj), rel=1e-5)


def test_bundle_reference_matches_pallas_halo():
    """The sharded mode's norm (halo = 8: the outer ring of 8 rows and
    columns left out of the norm, still swept) against the Pallas kernel's
    ``halo`` mode in interpret mode: x to 4 ulp, the norm to rel 1e-5."""
    shape = (5, 37, 45)
    arrays = seeded_system(shape, seed=7)
    xj, nj = JP.jacobi_bundle(*(jnp.asarray(a) for a in arrays), halo=8)
    xt, nt = TB.jacobi_bundle_reference(*(torch.from_numpy(a) for a in arrays),
                                        halo=8)
    _, n0 = TB.jacobi_bundle_reference(*(torch.from_numpy(a) for a in arrays))
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=4 * ULP * float(np.abs(xj).max()))
    assert float(nt) == pytest.approx(float(nj), rel=1e-5)
    assert float(nt) < 0.5 * float(n0)       # the ring really is left out


def tiled_emulation(arrays, K, TI, S, halo=0):
    """The schedule of csrc/jacobi_bundle.cu's tiled design in PyTorch, for
    the CPU: ceil(K / S) launches; per TI x TI tile an x tile with an S ring;
    sweep s of a launch of n sweeps updates only the in-box cells at ring
    >= S - n + s of the tile; the interior is written out; the last launch
    gives one norm partial per (row, col) column, summed over l in order.
    Returns (x, norm plane)."""
    b, cu, cd, cl, m, x = arrays
    L, R, C = x.shape
    TW = TI + 2 * S
    nty, ntx = -(-R // TI), -(-C // TI)

    def pad(a):   # zero ring of S, plus room for the ragged last tile
        return torch.nn.functional.pad(a, (S, S + TI, S, S + TI))

    bp, cup, cdp, mp = pad(b), pad(cu), pad(cd), pad(m)
    clp = torch.stack([pad(c) for c in cl])
    inbox = pad(torch.ones((R, C)))
    ii = torch.arange(TW)
    ring = torch.minimum(torch.minimum(ii[:, None], ii[None, :]),
                         torch.minimum(TW - 1 - ii[:, None], TW - 1 - ii[None, :]))
    rows = torch.arange(R)[:, None]
    cols = torch.arange(C)[None, :]
    counted = (rows >= halo) & (rows < R - halo) & (cols >= halo) & (cols < C - halo)
    norm_plane = torch.zeros((R, C))
    launches = -(-K // S)
    for q in range(launches):
        n = min(S, K - q * S)
        xp = pad(x)
        y = torch.empty_like(x)
        for ty in range(nty):
            for tx in range(ntx):
                win = (slice(ty * TI, ty * TI + TW), slice(tx * TI, tx * TI + TW))
                bt, ut, dt, mt = (a[:, win[0], win[1]] for a in (bp, cup, cdp, mp))
                ct = clp[:, :, win[0], win[1]]
                live = inbox[win] > 0
                xt = xp[:, win[0], win[1]].clone()
                for s in range(1, n + 1):
                    x_up = torch.zeros_like(xt)
                    x_up[1:] = xt[:-1]
                    x_dn = torch.zeros_like(xt)
                    x_dn[:-1] = xt[1:]
                    acc = bt
                    acc = acc + ut * x_up
                    acc = acc + dt * x_dn
                    for k, (dr, dc) in enumerate(TB.LATERAL_OFFSETS):
                        acc = acc + ct[k] * TB.shift2d(xt, dr, dc)
                    acc[0] = torch.clamp_min(acc[0], 0.0)
                    new = acc * mt
                    if q == launches - 1 and s == n:
                        dx = torch.abs(new - xt)
                        apsi = torch.abs(new)
                        contrib = dx * torch.where(apsi > 1.0, 1.0 / apsi, 1.0) * mt
                        local = torch.zeros(contrib.shape[1:])
                        for l in range(L):
                            local = local + contrib[l]
                    xt = torch.where(live & (ring >= S - n + s), new, xt)
                r0, c0 = ty * TI, tx * TI
                hr, hc = min(TI, R - r0), min(TI, C - c0)
                y[:, r0:r0 + hr, c0:c0 + hc] = xt[:, S:S + hr, S:S + hc]
                if q == launches - 1:
                    norm_plane[r0:r0 + hr, c0:c0 + hc] = local[S:S + hr, S:S + hc]
        x = y
    return x, torch.where(counted, norm_plane, 0.0)


@pytest.mark.parametrize("shape,K,tile,halo", [
    ((5, 37, 45), 8, None, 0),        # the planned tile
    ((7, 23, 19), 8, (4, 4), 0),      # many tiles, ragged on both axes
    ((3, 17, 21), 5, (4, 4), 0),      # K not a multiple of S: 4 + 1 sweeps
    ((2, 13, 9), 7, (4, 3), 3),       # 3 + 3 + 1 sweeps, halo mode
    ((4, 6, 5), 1, (8, 1), 2),        # one sweep, box smaller than a tile
])
def test_tiled_schedule_matches_reference(shape, K, tile, halo):
    """The tiled design's schedule (tiles, rings, the launches of a bundle,
    the per-column norm plane) gives the plain version's x bit for bit,
    and its norm plane sums to the plain norm (rel 1e-5: another order)."""
    arrays = [torch.from_numpy(a) for a in seeded_system(shape, seed=sum(shape) + K)]
    TI, S = tile or TB.plan_tiles(shape[0], K)
    x_e, plane = tiled_emulation(arrays, K, TI, S, halo)
    x_r, n_r = TB.jacobi_bundle_reference(*arrays, K=K, halo=halo)
    assert torch.equal(x_e, x_r)
    assert float(plane.sum()) == pytest.approx(float(n_r), rel=1e-5)


def test_plan_tiles_fits_a_block():
    """The planned tile fits a Hopper block (shared memory, 512 threads),
    has a side that is a multiple of 4 (TMA boxes start on 16-byte columns)
    and keeps at most K sweeps on chip. Against the per-sweep design's 14
    box-array passes a sweep, its modelled passes are fewer wherever two or
    more sweeps share a launch and L <= 10; taller columns get small tiles
    and pay their rings (at most 30 passes a sweep up to L = 64). At the
    main path's (L, K) = (7, 8) it is 16 x 16 with S = 4: 56 passes against
    112."""
    for L in range(1, 65):
        for K in (1, 2, 3, 5, 8, 12):
            TI, S = TB.plan_tiles(L, K)
            assert 1 <= S <= K and TI >= 4 and TI % 4 == 0
            assert (TI + 2 * S - 2) ** 2 <= TB.MAX_THREADS
            assert TB.tile_smem(L, TI, S) <= TB.SMEM_PER_BLOCK
            passes = TB.modelled_passes(K, TI, S)
            assert passes <= 30 * K
            if K > 1 and L <= 10:
                assert passes < 14 * K
    assert TB.plan_tiles(7, 8) == (16, 4)
    assert TB.modelled_passes(8, 16, 4) == 56.0
    with pytest.raises(ValueError):
        TB.plan_tiles(300, 8)


def test_per_sweep_design_runs_on_cuda_only():
    arrays = [torch.from_numpy(a) for a in seeded_system((3, 9, 7), seed=3)]
    with pytest.raises(ValueError):
        TB.jacobi_bundle_per_sweep(*arrays)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper IS the plain version and counts no
    kernel launch."""
    arrays = [torch.from_numpy(a) for a in seeded_system((3, 9, 7), seed=3)]
    before = TB.jacobi_bundle.launches
    for halo in (0, 2):
        x, n = TB.jacobi_bundle(*arrays, K=3, halo=halo)
        xr, nr = TB.jacobi_bundle_reference(*arrays, K=3, halo=halo)
        assert torch.equal(x, xr) and torch.equal(n, nr)
    assert TB.jacobi_bundle.launches == before


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous"])
def test_wrapper_checks_reject_bad_inputs(fault):
    arrays = [torch.from_numpy(a) for a in seeded_system((3, 9, 7), seed=4)]
    if fault == "dtype":
        arrays[0] = arrays[0].double()
    elif fault == "shape":
        arrays[3] = arrays[3][:7]
    else:
        arrays[1] = arrays[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        TB._check(*arrays)


@pytest.mark.parametrize("case", [0, 1])
def test_solve_loop_matches_jax(case):
    """The port's host loop of bundles against the JAX while_loop on an
    assembled system: same n_it and divergence flag, x to rel 1e-5."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(12))
    js, _ = rain_states(jg, jp, tg, tp, psi0=-1.0 - case, rain_mm_h=20.0)
    psi = jnp.where(jg.mask, js.h - jg.z, 0.0).astype(jnp.float32)
    se = JW.compute_se_psi(jg, jp, psi)
    dt = 600.0 * (1 + case)
    system, *_ = JW.assemble_fast(jg, jp, psi, psi, se, js.sink_source,
                                  js.pond, jnp.asarray(0, jnp.int32),
                                  jnp.asarray(dt))
    mask_f = jg.mask.astype(jnp.float32)
    max_iter = jp.max_iterations_for(0)
    xj, dj, nj = JP.jacobi_solve_loop(system.b, system.c_up, system.c_down,
                                      system.c_lat, mask_f, psi, max_iter,
                                      1e-7, jg.n_nodes)
    t = [torch.from_numpy(np.array(a)) for a in
         (system.b, system.c_up, system.c_down, system.c_lat, mask_f, psi)]
    xt, dt_, nt = TB.jacobi_solve_loop(*t, tp.max_iterations_for(0), 1e-7,
                                       tg.n_nodes)
    assert nt == int(nj) and nt % TB.SWEEPS_PER_BUNDLE == 0
    assert dt_ == bool(dj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(xj)).max()))


def test_params_match_jax():
    """The preset and the per-approximation sweep cap (computed in
    float32) equal the JAX package's."""
    TP = T.SolverParameters
    for kw in ({}, dict(use_pallas=True), dict(inner_solver="jacobi"),
               dict(max_iterations=150, max_approximations=7)):
        jp, tp = J.SolverParameters.fast_f32(**kw), TP.fast_f32(**kw)
        for name in ("inner_solver", "cg_precond", "residual_tolerance",
                     "use_pallas", "mbr_threshold", "delta_t_max"):
            assert getattr(tp, name) == getattr(jp, name), (kw, name)
        for approx in range(10):
            assert tp.max_iterations_for(approx) == int(jp.max_iterations_for(approx))
    for acc in range(1, 6):
        jp, tp = (J.SolverParameters.from_model_accuracy(acc, 4.0),
                  TP.from_model_accuracy(acc, 4.0))
        for name in ("delta_t_min", "delta_t_max", "max_iterations",
                     "residual_tolerance", "mbr_threshold"):
            assert getattr(tp, name) == getattr(jp, name)
