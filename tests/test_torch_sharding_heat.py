"""The coupled water + heat step on the mesh's blocks: ``HeatState`` and
``HeatBoundary`` through ``shard_pytree`` / ``gather_pytree``, the heat
Jacobi sweeps on blocks, and ``compute_period_coupled`` partitioned over
(2, 4), (1, 4), (4, 1) and (2, 2) CPU blocks against the port's whole box
and, on 8 blocks, against JAX's GSPMD-partitioned coupled hour on its 8
virtual devices (tests/test_sharding.py's coupled case, on the 32 valley:
a 16 box cannot be cut into blocks of at least the 8-cell ring over
(2, 4)).

Every cell of a block does the whole box's arithmetic and the sweeps' stop
is a maximum, which does not depend on order; only the float64 sums of the
balances add per-block partials in another order. So the counts and host
reads are the whole box's, float32 fields bit-equal, float64 ones within
1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import BoundaryType as JBT
from criteria3d_tpu.parallel import sharding as JS
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver.coupled import compute_period_coupled as j_period
from criteria3d_tpu.solver.step import initialize_balance as j_ib
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel import sharding as TS
from criteria3d_tpu_torch.problems import build_coupled_problem
from criteria3d_tpu_torch.solver import coupled as CP
from criteria3d_tpu_torch.solver import heat as TH
from chip_smoke import heat_outcome
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import port_grid, port_state
from tests.test_torch_coupled import port_heat
from tests.test_torch_sharding import MESHES, cpu_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
RING = TS.RING
MESH_IDS = [f"{r}x{c}" for r, c in MESHES]

# name -> (parameters, period [s], mesh shapes): the coupled storm hour of
# chip_smoke.py phase 3e (frozen properties) over every mesh; exact mode
# and float64 for 600 s on (2, 4); advection on (2, 2)
CASES = {
    "frozen": (lambda **m: T.SolverParameters.fast_f32(
        heat_vapor=True, heat_frozen_props=True, **m), 3600.0, MESHES),
    "exact": (lambda **m: T.SolverParameters.fast_f32(heat_vapor=True, **m),
              600.0, [(2, 4)]),
    "f64": (lambda **m: T.SolverParameters(heat_vapor=True, **m), 600.0, [(2, 4)]),
    "advection": (lambda **m: T.SolverParameters.fast_f32(
        heat_vapor=True, heat_advection=True, heat_frozen_props=True, **m),
        1800.0, [(2, 2)]),
}


def coupled_run(grid, params, water, heat, boundary, period):
    """compute_period_coupled with its counts and host reads."""
    CP.reset_counts()
    host_read.count = 0
    w, h = CP.compute_period_coupled(grid, params, water, heat, boundary, period)
    return w, h, CP.counts(), host_read.count


@pytest.fixture(scope="module")
def whole_runs():
    """Each case's whole-box run on the 32 valley's coupled storm problem
    (problems.build_coupled_problem), with its inputs."""
    runs = {}
    for name, (make, period, _) in CASES.items():
        params = make()
        grid, water, heat, boundary = inputs = build_coupled_problem(
            valley_dem(32), 10.0, params, "cpu")
        runs[name] = dict(inputs=inputs, out=coupled_run(grid, params, water, heat,
                                                         boundary, period))
    return runs


def blocked_run(ref, name, shape):
    make, period, _ = CASES[name]
    mesh = cpu_mesh(*shape)
    grid, water, heat, boundary = (TS.shard_pytree(t, mesh) for t in ref["inputs"])
    return mesh, coupled_run(grid, make(mesh=mesh), water, heat, boundary, period)


# ----------------------------------------------------------------------
# (a) HeatState and HeatBoundary through shard_pytree / gather_pytree
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_heat_shard_and_gather_round_trip(whole_runs, shape):
    """shard_pytree then gather_pytree gives HeatState and HeatBoundary
    back bit for bit; each (L, R, C) or (R, C) field becomes a Blocked of
    tiles, each its window of the zero-padded field (False for the mask),
    the 0-d balance scalars move to mesh.home and a None field stays
    None."""
    _, _, heat, boundary = whole_runs["frozen"]["inputs"]
    noise = np.random.default_rng(3).random(tuple(heat.t.shape))
    heat = dataclasses.replace(heat, t=heat.t + torch.from_numpy(noise), mbr=None)
    mesh = cpu_mesh(*shape)
    r, c = 32 // shape[0], 32 // shape[1]
    for whole in (heat, boundary):
        blocked = TS.shard_pytree(whole, mesh)
        assert type(blocked) is type(whole)
        back = TS.gather_pytree(blocked)
        for f in dataclasses.fields(whole):
            a, s, b = getattr(whole, f.name), getattr(blocked, f.name), getattr(back, f.name)
            if a is None:
                assert s is None and b is None
                continue
            assert a.dtype == b.dtype and torch.equal(a, b)
            if a.dim() == 0:
                assert s.device == mesh.home and s.dim() == 0
                continue
            assert isinstance(s, TS.Blocked) and s.mesh is mesh
            pad = torch.nn.functional.pad(a, (RING,) * 4)
            for (i, j), tile in np.ndenumerate(s.blocks):
                window = pad[..., i * r:i * r + r + 2 * RING, j * c:j * c + c + 2 * RING]
                assert tile.dtype == a.dtype and torch.equal(tile, window)


# ----------------------------------------------------------------------
# (b) the heat Jacobi sweeps on blocks
# ----------------------------------------------------------------------

def seeded_heat_system(dtype, n=32, L=5, seed=11):
    """A diagonally dominant preconditioned heat system on an (L, n, n)
    box: couplings summing to 0.93 of the diagonal, a random mask with
    layer 0 off."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand(L, n, n, generator=g) < 0.9
    mask[0] = False
    w = torch.rand(10, L, n, n, generator=g, dtype=torch.float64)
    w = 0.93 * w / w.sum(0)
    b_p = (280.0 * 0.07 + torch.rand(L, n, n, generator=g, dtype=torch.float64)).to(dtype)
    x0 = torch.where(mask, 283.0 + 10.0 * torch.rand(L, n, n, generator=g,
                                                     dtype=torch.float64), 0.0).to(dtype)
    return [b_p, w[0].to(dtype), w[1].to(dtype), w[2:].to(dtype), mask, x0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_heat_jacobi_on_blocks_matches_whole_box(dtype):
    """heat_jacobi_solve on (2, 4) blocks of a seeded system against the
    whole box: the same sweep count (at least 30, so that x's rings are
    exchanged several times), the same host reads (one a sweep), x
    bit-equal, the sweep counter counting sweeps and not sweeps x
    blocks."""
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    args = seeded_heat_system(dtype)
    TH.heat_jacobi_solve.sweeps = 0
    host_read.count = 0
    x1, n1 = TH.heat_jacobi_solve(*args, 2000, tol)
    reads1 = host_read.count
    assert n1 >= 30 and TH.heat_jacobi_solve.sweeps == n1 == reads1
    mesh = cpu_mesh(2, 4)
    host_read.count = 0
    x2, n2 = TH.heat_jacobi_solve(*(TS.shard_pytree(a, mesh) for a in args), 2000, tol)
    assert n2 == n1 and host_read.count == reads1
    assert TH.heat_jacobi_solve.sweeps == 2 * n1
    assert isinstance(x2, TS.Blocked)
    whole = torch.nn.functional.pad(x1, (RING,) * 4)
    r, c = 32 // 2, 32 // 4
    for (i, j), tile in np.ndenumerate(x2.blocks):
        # the rings leave fresh: every grown tile is its window
        assert torch.equal(tile, whole[..., i * r:i * r + r + 2 * RING,
                                       j * c:j * c + c + 2 * RING])
    assert torch.equal(TS.gather_pytree(x2), x1)


# ----------------------------------------------------------------------
# (c) the partitioned coupled step against the port's whole box
# ----------------------------------------------------------------------

def heat_mbr(name, inputs, water, heat):
    """bench.py's whole-period heat MBR of an outcome, as chip_smoke.py
    reads it."""
    grid = inputs[0]
    return heat_outcome(name, grid, CASES[name][0](), water, heat)[0]


# each case's counts (COUNT_KEYS) and eager host reads, as the port gave
# them when a host counter refreshed the heat sweeps' rings: the frozen
# hour's 829 heat sweeps, exact mode's 6 and float64's 9 end between two
# refreshes
COUNT_KEYS = ("steps", "attempts", "approximations", "inner_iterations", "chunks",
              "substeps_accepted", "substeps_rejected", "heat_sweeps")
PARENT_COUNTS = {"frozen": ((18, 20, 55, 77, 18, 48, 8, 829), 1180),
                 "exact": ((1, 1, 1, 1, 1, 1, 0, 6), 15),
                 "f64": ((1, 1, 1, 8, 1, 1, 0, 9), 24),
                 "advection": ((9, 10, 26, 34, 21, 192, 49, 1374), 1778)}


@pytest.mark.parametrize("name,shape", [(n, s) for n, (_, _, shapes) in CASES.items()
                                        for s in shapes],
                         ids=[f"{n}-{r}x{c}" for n, (_, _, shapes) in CASES.items()
                              for r, c in shapes])
def test_partitioned_coupled_matches_whole_box(whole_runs, name, shape):
    """compute_period_coupled on blocks of the 32 valley's coupled storm,
    gathered, against the port's whole-box run: every counter of
    coupled.counts() and the host reads equal, and the ones the port gave
    before the heat sweeps' ring refresh became a unit (PARENT_COUNTS);
    float32 h and T bit-equal,
    float64 within 1e-9 m and 1e-9 K; the water MBR within 1e-8 and the
    heat MBR within 1e-8 of its scale (the float64 balance sums add
    per-block partials in another order)."""
    ref = whole_runs[name]
    w1, h1, counts1, reads1 = ref["out"]
    _, (w2, h2, counts2, reads2) = blocked_run(ref, name, shape)
    assert counts2 == counts1 and reads2 == reads1
    assert (tuple(counts2[k] for k in COUNT_KEYS), reads2) == PARENT_COUNTS[name]
    assert counts1["heat_sweeps"] > 0 and counts1["chunks"] > 0
    w2, h2 = TS.gather_pytree(w2), TS.gather_pytree(h2)
    if name == "f64":
        np.testing.assert_allclose(w2.h.numpy(), w1.h.numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(h2.t.numpy(), h1.t.numpy(), rtol=0, atol=1e-9)
    else:
        assert torch.equal(w2.h, w1.h) and torch.equal(h2.t, h1.t)
    assert float(w2.balance_whole.mbr) == pytest.approx(float(w1.balance_whole.mbr),
                                                        abs=1e-8)
    mbr1 = heat_mbr(name, ref["inputs"], w1, h1)
    mbr2 = heat_mbr(name, ref["inputs"], w2, h2)
    assert mbr2 == pytest.approx(mbr1, rel=1e-8, abs=1e-8)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 4)], ids=["2x2", "1x4", "2x4"])
@pytest.mark.parametrize("name", ["exact", "f64"])
def test_heat_ring_refresh_unit(whole_runs, name, shape, monkeypatch):
    """The 600 s exact-mode (float32) and float64 coupled periods on blocks
    under the eager driver: their one heat sub-step of 6 and of 9 sweeps
    refreshes x's rings in the ring-refresh unit at the sweeps' end only,
    and after sweep 8 and at the end (1 and 2 exchanges); the counts and
    host reads are the port's before (PARENT_COUNTS); float32 h and T
    bit-equal to the whole box's, float64 within 1e-9."""
    ref = whole_runs[name]
    w1, h1, counts1, reads1 = ref["out"]
    exchanges = []

    def counted(x):
        exchanges.append(1)
        return TS.exchange(x)
    monkeypatch.setattr(CP, "exchange", counted)
    _, (w2, h2, counts2, reads2) = blocked_run(ref, name, shape)
    assert (tuple(counts2[k] for k in COUNT_KEYS), reads2) == PARENT_COUNTS[name]
    assert counts2 == counts1 and reads2 == reads1
    assert len(exchanges) == {"exact": 1, "f64": 2}[name]
    w2, h2 = TS.gather_pytree(w2), TS.gather_pytree(h2)
    if name == "f64":
        np.testing.assert_allclose(w2.h.numpy(), w1.h.numpy(), rtol=0, atol=1e-9)
        np.testing.assert_allclose(h2.t.numpy(), h1.t.numpy(), rtol=0, atol=1e-9)
    else:
        assert torch.equal(w2.h, w1.h) and torch.equal(h2.t, h1.t)


# ----------------------------------------------------------------------
# (d) against JAX's GSPMD-partitioned coupled hour
# ----------------------------------------------------------------------

def jax_coupled_case(params):
    """tests/test_sharding.py's coupled inputs on the 32 valley: uniform
    soil, HeatSurface layer 1, psi0 = -2 m, soil at 285.15 K under air at
    295.15 K, 55 % relative humidity, 2 m/s wind, 250 W/m2."""
    dem = valley_dem(32)
    soil = J.SoilFields.uniform(dem.shape, vg_alpha=1.4, vg_n=1.6, vg_he=0.02,
                                theta_s=0.43, theta_r=0.05, k_sat=1e-5)
    grid = J.Grid.build(dem, 10.0, soil, total_depth=0.6)
    grid = dataclasses.replace(
        grid,
        btype=grid.btype.at[1].set(jnp.where(
            grid.mask[1], int(JBT.HEAT_SURFACE), grid.btype[1])),
        bsize=grid.bsize.at[1].set(jnp.where(
            grid.mask[1], float(grid.area), grid.bsize[1])))
    water = j_ib(grid, params, J.WaterState.initialize(grid, params,
                                                       matric_potential=-2.0))
    heat = JH.initialize_heat(grid, 285.15)
    storage = JH.heat_storage(grid, params, heat, water)
    heat = dataclasses.replace(heat, storage_prev=storage, storage_whole=storage)
    boundary = JH.HeatBoundary.uniform(
        grid.shape[1:], air_temperature=295.15, rel_humidity=55.0,
        wind_speed=2.0, net_irradiance=250.0, mask=grid.mask[1])
    return grid, water, heat, boundary


# name -> (parameters in a package, period [s], h tolerance [m], T
# tolerance [K]): the float64 coupled tolerances of
# tests/test_torch_coupled.py and the stated float32 ones (PERF.md §2);
# float64 over 1200 s (its 8-block hour takes ~50 s on one CPU thread)
JAX_CASES = {
    "f64_vapor": (lambda pkg, **m: pkg.SolverParameters(heat_vapor=True, **m),
                  1200.0, 1e-9, 1e-7),
    "frozen_vapor": (lambda pkg, **m: pkg.SolverParameters.fast_f32(
        heat_vapor=True, heat_frozen_props=True, **m), 3600.0, 1e-4, 5e-3),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_partitioned_coupled_matches_jax(name):
    """compute_period_coupled on 8 CPU blocks against JAX's
    compute_period_coupled on grid, water, heat and boundary sharded over
    its 8 virtual devices (GSPMD): the same dt; h and T within the
    tolerances of each path."""
    make, period, h_tol, t_tol = JAX_CASES[name]
    jp = make(J)
    jg0, jw0, jh, jb = jax_coupled_case(jp)
    jm = JS.make_mesh(8)
    jg, jw, jh_s, jb_s = (JS.shard_pytree(x, jm) for x in (jg0, jw0, jh, jb))
    jw_out, jh_out = j_period(jg, jp, jw, jh_s, jb_s, period)
    mesh = TS.make_mesh(8, devices=[CPU] * 8)
    th, tb = port_heat(jh, jb)
    inputs = [TS.shard_pytree(x, mesh) for x in (port_grid(jg0), port_state(jw0), th, tb)]
    tw_out, th_out = CP.compute_period_coupled(inputs[0], make(T, mesh=mesh),
                                               *inputs[1:], period)
    tw_out, th_out = TS.gather_pytree(tw_out), TS.gather_pytree(th_out)
    assert float(tw_out.dt_curr) == float(jw_out.dt_curr)
    np.testing.assert_allclose(tw_out.h.numpy(), np.asarray(jw_out.h), rtol=0, atol=h_tol)
    np.testing.assert_allclose(th_out.t.numpy(), np.asarray(jh_out.t), rtol=0, atol=t_tol)


# ----------------------------------------------------------------------
# (e) nothing whole inside the coupled step; (f) what it refuses
# ----------------------------------------------------------------------

def test_nothing_whole_inside_the_coupled_step(whole_runs, monkeypatch):
    """A 600 s coupled period on (2, 4) blocks with join_blocks,
    split_blocks and gather_pytree made to raise: no whole field is built.
    Every returned tile keeps its grown shape and its block's device; the
    0-d scalars are on mesh.home."""
    ref = whole_runs["frozen"]
    make = CASES["frozen"][0]
    mesh = cpu_mesh(2, 4)
    grid, water, heat, boundary = (TS.shard_pytree(t, mesh) for t in ref["inputs"])

    def refuse(*args, **kwargs):
        raise AssertionError("a whole field was built inside the coupled step")
    for name in ("join_blocks", "split_blocks", "gather_pytree"):
        monkeypatch.setattr(TS, name, refuse)
    CP.reset_counts()
    w, h = CP.compute_period_coupled(grid, make(mesh=mesh), water, heat, boundary, 600.0)
    assert CP.counts()["heat_sweeps"] > 0
    tile = (32 // 2 + 2 * RING, 32 // 4 + 2 * RING)
    n_blocked = 0
    for state in (w, h):
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            leaves = ([] if v is None else [v] if isinstance(v, (torch.Tensor, TS.Blocked))
                      else TS._leaves(v))
            for leaf in leaves:
                if isinstance(leaf, TS.Blocked):
                    n_blocked += 1
                    assert leaf.mesh is mesh
                    for (i, j), t in np.ndenumerate(leaf.blocks):
                        assert tuple(t.shape[-2:]) == tile and t.device == mesh.devices[i, j]
                else:
                    assert leaf.device == mesh.home and (leaf.dim() == 0 or leaf.numel() == 0)
    assert n_blocked >= 9       # the water fields, T, T_old and the heat sink


REFUSALS = ["blocked water, whole heat", "blocked inputs, no mesh", "mesh, whole inputs"]


@pytest.mark.parametrize("case", REFUSALS)
def test_coupled_configurations_it_does_not_run_raise(whole_runs, case):
    """No fallback: compute_step_coupled and compute_period_coupled raise
    ValueError, and gather nothing, for blocked water with whole heat and
    boundary, blocked inputs without a mesh, and a mesh with whole
    inputs."""
    inputs = whole_runs["frozen"]["inputs"]
    make = CASES["frozen"][0]
    mesh = cpu_mesh(2, 2)
    blocked = [TS.shard_pytree(t, mesh) for t in inputs]
    params, args, match = {
        REFUSALS[0]: (make(mesh=mesh), blocked[:2] + list(inputs[2:]), "shard_pytree"),
        REFUSALS[1]: (make(), blocked, "gather_pytree"),
        REFUSALS[2]: (make(mesh=mesh), list(inputs), "shard_pytree"),
    }[case]
    for fn in (CP.compute_step_coupled, CP.compute_period_coupled):
        with pytest.raises(ValueError, match=match):
            fn(args[0], params, *args[1:], 600.0)
