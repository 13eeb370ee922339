"""The water period on a mesh whose blocks several machines run: the
rounds driver (solver/device_loop.py), the counterpart of JAX's GSPMD
period over several chips.

A mesh over several cards gives each card's blocks a machine of their
own; ``make_mesh(..., machines=)`` groups the blocks explicitly, which on
the CPU (and on one card) runs the same rounds. Each machine holds its
blocks' part of every buffer and its own scalars, and the machines meet
at every sum, maximum and ring refresh (``sharding.Join``). Here 2 x 2
and 1 x 4 meshes of CPU blocks of the 32 valley are split into 2 and 4
machines: each form's period is bit-equal to one machine's over the same
blocks (the parent's mesh period) and within the bars of
tests/test_torch_sharding.py of JAX's GSPMD period on the conftest's
virtual CPU devices.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import criteria3d_tpu as J
from criteria3d_tpu.parallel import sharding as JS
from criteria3d_tpu.solver.step import compute_period_stats as jax_period_stats
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel import sharding as TS
from criteria3d_tpu_torch.solver import device_loop as DL
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from criteria3d_tpu_torch.solver import step as TSt
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states
from tests.test_torch_sharding import FORMS, form_params

torch.set_num_threads(1)

CPU = torch.device("cpu")
# a period of several steps from the rain state (600 s is one step)
PERIOD = 1800.0
# (mesh shape, machine of each block in row-major order)
GROUPINGS = [((2, 2), (0, 1, 2, 3)), ((2, 2), (0, 0, 1, 1)), ((1, 4), (0, 1, 2, 3)),
             ((1, 4), (0, 0, 1, 1))]


def cpu_mesh(shape, machines=None) -> TS.Mesh:
    devices = np.empty(shape, dtype=object)
    devices[...] = CPU
    return TS.Mesh(devices, None if machines is None
                   else np.asarray(machines, dtype=np.int64).reshape(shape))


@pytest.fixture(scope="module")
def valley():
    jg, tg = build_grids(valley_dem(32))
    return dict(jg=jg, tg=tg, states={}, runs={})


def states(valley, form):
    if form not in valley["states"]:
        valley["states"][form] = rain_states(valley["jg"], form_params(form, J),
                                             valley["tg"], form_params(form),
                                             psi0=-1.0, rain_mm_h=20.0)
    return valley["states"][form]


def period(valley, form, shape, machines=None) -> dict:
    """The port's PERIOD on ``shape`` CPU blocks (one machine, or the
    ``machines`` grouping), gathered, with its host reads and the drivers'
    counts (each run once a module)."""
    key = (form, shape, machines)
    if key not in valley["runs"]:
        mesh = cpu_mesh(shape, machines)
        _, ts = states(valley, form)
        grid, state = TS.shard_pytree(valley["tg"], mesh), TS.shard_pytree(ts, mesh)
        host_read.count = 0
        TB.jacobi_bundle.launches = 0
        DL.reset_counts()
        out, stats = T.compute_period_stats(grid, form_params(form, mesh=mesh), state,
                                            PERIOD)
        valley["runs"][key] = dict(out=TS.gather_pytree(out), stats=tuple(stats),
                                   reads=host_read.count, counts=DL.counts(),
                                   launches=TB.jacobi_bundle.launches,
                                   driver=DL.driver_for(mesh.home, mesh)[0])
    return valley["runs"][key]


@pytest.mark.parametrize("shape,machines", GROUPINGS,
                         ids=[f"{r}x{c}-{len(set(m))}" for (r, c), m in GROUPINGS])
@pytest.mark.parametrize("form", list(FORMS))
def test_machines_bit_equal_to_one_machine(valley, form, shape, machines):
    """The period with the blocks split into 2 or 4 machines, in rounds,
    against one machine over the same blocks (the eager driver, as the
    mesh's period ran before the split): stats, heads, dt, every balance
    and the bundle launches equal, bit for bit. The rounds driver reads
    the host once a batch of at most UNITS_PER_LAUNCH rounds, a batch
    ending early once machine 0 has no segment left, and nothing else in
    the period reads it; the rounds counted are those that ran a segment,
    as many for 2 as for 4 machines."""
    one = period(valley, form, shape)
    split = period(valley, form, shape, machines)
    assert one["driver"] == "eager" and split["driver"] == "rounds"
    assert split["counts"]["rounds_periods"] == 1 and split["counts"]["eager_periods"] == 0
    assert split["stats"] == one["stats"] and one["stats"][0] > 1
    a, b = one["out"], split["out"]
    for f in ("h", "h_old", "best_h", "se", "k", "boundary_flow_sum"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("dt_curr", "courant"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for bal in ("balance_prev", "balance_current", "balance_period", "balance_whole"):
        for f in dataclasses.fields(getattr(a, bal)):
            assert torch.equal(getattr(getattr(a, bal), f.name),
                               getattr(getattr(b, bal), f.name)), (bal, f.name)
    assert split["launches"] == one["launches"]
    assert split["reads"] == split["counts"]["launches"] >= 1
    rounds = split["counts"]["rounds"]
    assert split["counts"]["launches"] == -(-rounds // DL.UNITS_PER_LAUNCH)
    assert split["counts"]["rounds_enqueued"] == rounds
    other = next(m for s, m in GROUPINGS if s == shape and m != machines)
    assert period(valley, form, shape, other)["counts"]["rounds"] == rounds


@pytest.mark.parametrize("form", list(FORMS))
def test_machines_match_jax_gspmd_period(valley, form):
    """The period on 2 x 2 CPU blocks split into 4 machines against JAX's
    GSPMD period on a 2 x 2 mesh of the conftest's virtual CPU devices, at
    tests/test_torch_sharding.py's bars for the partitioned step: the same
    stats, dt equal; bundle heads within 1e-5 m and MBR within 1e-6; CG
    line heads within 1e-5 m and MBR within 2e-6; float64 heads and MBR
    within 1e-9 (the MBR the period's, ``balance_whole``)."""
    js, _ = states(valley, form)
    jm = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("row", "col"))
    jout, jstats = jax_period_stats(JS.shard_pytree(valley["jg"], jm),
                                    form_params(form, J, mesh=jm),
                                    JS.shard_pytree(js, jm), PERIOD)
    run = period(valley, form, (2, 2), (0, 1, 2, 3))
    out = run["out"]
    assert run["stats"] == tuple(int(v) for v in jstats)
    assert float(out.dt_curr) == float(jout.dt_curr)
    tol_h, tol_mbr = {"bundle": (1e-5, 1e-6), "cg_line": (1e-5, 2e-6),
                      "f64": (1e-9, 1e-9)}[form]
    np.testing.assert_allclose(out.h.numpy(), np.asarray(jout.h), rtol=0, atol=tol_h)
    assert float(out.balance_whole.mbr) == pytest.approx(float(jout.balance_whole.mbr),
                                                         abs=tol_mbr)


def test_one_step_split_into_machines(valley):
    """compute_step (the machine's one-step mode, which also hands back
    the last assembly's boundary rate) on 2 x 2 blocks in 4 machines
    against one machine: state, dt and rate bit-equal."""
    _, ts = states(valley, "cg_line")
    outs = []
    for machines in (None, (0, 1, 2, 3)):
        mesh = cpu_mesh((2, 2), machines)
        grid, state = TS.shard_pytree(valley["tg"], mesh), TS.shard_pytree(ts, mesh)
        st, dt, counts, rate, dt_curr = TSt._compute_step(
            grid, form_params("cg_line", mesh=mesh), state, 3600.0)
        outs.append((TS.gather_pytree(st), dt, counts, TS.gather_pytree(rate), dt_curr))
    (a, *ra), (b, *rb) = outs
    assert torch.equal(a.h, b.h) and torch.equal(a.se, b.se)
    assert ra[0] == rb[0] and ra[1] == rb[1] and ra[3] == rb[3]
    assert torch.equal(ra[2], rb[2])


def test_join_exchange_and_sums_equal_the_whole_mesh():
    """A Join's exchange and combine, driven by hand on each machine of a
    2 x 4 mesh split into 3 machines (its cut copies the machines' posts as
    the driver does): every grown block equal to ``halo_exchange``'s, sums
    and maxima equal to ``block_sum`` / ``block_max`` (float32 and float64
    partials), bit for bit."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(7, 32, 64, generator=g)
    whole = cpu_mesh((2, 4))
    xb = TS.shard_pytree(x, whole)
    p32 = TS.bmap(lambda b: b.sum(), xb)
    p64 = TS.bmap(lambda b: b.sum(dtype=torch.float64), xb)
    want = (TS.exchange(xb), TS.block_sum(p32), TS.block_sum(p64), TS.block_max(p32))
    machines = (0, 0, 1, 1, 2, 2, 2, 1)
    mesh = cpu_mesh((2, 4), machines)
    groups = TS.machine_groups(mesh)
    xm, q32, q64 = (TS.remesh(v, mesh) for v in (xb, p32, p64))
    joins = [TS.Join(mesh, groups, k, TS.first_block(xb)) for k in range(len(groups))]

    def copies():
        for j in joins:
            for h, other in enumerate(joins):
                lo, hi = other.rows[h]
                j.board[lo:hi].copy_(other.board[lo:hi])
    # the round a cut ends: every machine posts, the posts are copied, then
    # every machine reads
    gate = threading.Barrier(len(joins), action=copies)
    results = [None] * len(joins)

    def machine(k):
        joins[k].cut = gate.wait
        with TS.joining(joins[k]):
            results[k] = TS.combine(TS.part(xm, groups[k]),
                                    sums=(TS.part(q32, groups[k]), TS.part(q64, groups[k])),
                                    maxes=(TS.part(q32, groups[k]),))
    threads = [threading.Thread(target=machine, args=(k,)) for k in range(len(joins))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    grown = TS.merge([r[0] for r in results])
    for idx in np.ndindex(2, 4):
        assert torch.equal(grown.blocks[idx], want[0].blocks[idx])
    for r in results:
        for got, ref in zip(r[1:], want[1:]):
            assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_a_failed_machine_raises_and_no_machine_waits():
    """A unit that raises in one machine of the rounds ends the period with
    RuntimeError naming it; the other machines' threads stop (no hang)."""
    jg, tg = build_grids(valley_dem(32))
    _, ts = rain_states(jg, form_params("cg_line", J), tg, form_params("cg_line"),
                        psi0=-1.0, rain_mm_h=20.0)
    mesh = cpu_mesh((2, 2), (0, 1, 2, 3))
    grid, state = TS.shard_pytree(tg, mesh), TS.shard_pytree(ts, mesh)
    real = TSt._Machine._evaluate

    def broken(self):
        if self.grid.blocks[1, 1] is not None:
            raise ValueError("a broken balance")
        return real(self)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TSt._Machine, "_evaluate", broken)
        with pytest.raises(RuntimeError, match="a broken balance"):
            T.compute_period_stats(grid, form_params("cg_line", mesh=mesh), state, PERIOD)


def test_driver_for_and_machine_groups():
    """driver_for names the rounds driver for a water or coupled period on
    a mesh over several cards or with an explicit grouping, and the graph
    driver for one card's mesh of one machine; the default grouping is one
    machine per device; a machine over two devices, and remesh onto other
    devices, raise."""
    cards = [torch.device("cuda", i) for i in range(4)]
    over = TS.make_mesh(4, devices=cards)
    assert TS.machine_groups(over) == [((0, 0),), ((0, 1),), ((1, 0),), ((1, 1),)]
    assert DL.driver_for(cards[0], over) == ("rounds", "")
    one = TS.make_mesh(4, devices=[cards[0]] * 4)
    assert TS.machine_groups(one) == [((0, 0), (0, 1), (1, 0), (1, 1))]
    assert DL.driver_for(cards[0], one) == ("graph", "")
    grouped = TS.make_mesh(4, devices=[cards[0]] * 4, machines=[0, 1, 1, 0])
    assert TS.machine_groups(grouped) == [((0, 0), (1, 1)), ((0, 1), (1, 0))]
    assert DL.driver_for(cards[0], grouped) == ("rounds", "")
    with DL.forced_eager():
        assert DL.driver_for(cards[0], over)[0] == "eager"
    with pytest.raises(ValueError, match="several devices"):
        TS.make_mesh(4, devices=cards[:2] * 2, machines=[0, 0, 1, 1])
    x = TS.shard_pytree(torch.zeros(1, 32, 32), cpu_mesh((2, 2)))
    with pytest.raises(ValueError, match="devices differ"):
        TS.remesh(x, one)
