"""The coupled water + heat period on a mesh whose blocks several machines
run: the rounds driver (solver/device_loop.py), the counterpart of JAX's
GSPMD-sharded ``compute_period_coupled`` over several chips.

Each machine holds its blocks' part of every water and heat buffer and its
own scalars; the heat units meet the other machines at every sum, maximum
and ring refresh as the water units do (``sharding.Join``), and every
machine combines all blocks' partials in the mesh's row-major order. On
tests/test_sharding.py's coupled inputs on the 32 valley
(tests/test_torch_sharding_heat.py's ``jax_coupled_case``), 2 x 2 and
1 x 4 meshes of CPU blocks split into 4 and 2 machines give one machine's
period over the same blocks bit for bit, and JAX's GSPMD period on the
conftest's virtual CPU devices within the bars of
tests/test_torch_sharding_heat.py (``JAX_CASES``).
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
from criteria3d_tpu.solver.coupled import compute_period_coupled as j_period
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel import sharding as TS
from criteria3d_tpu_torch.solver import coupled as CP
from criteria3d_tpu_torch.solver import device_loop as DL
from criteria3d_tpu_torch.solver import heat as TH
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from tests.test_torch_core import port_grid, port_state
from tests.test_torch_coupled import port_heat
from tests.test_torch_mesh_cards import cpu_mesh
from tests.test_torch_sharding_heat import JAX_CASES, jax_coupled_case

torch.set_num_threads(1)

# name -> (parameters in a package, period [s], (mesh shape, machine of each
# block in row-major order) of each split run): the frozen coupled period
# on both meshes in 4 and in 2 machines; float64 vapor and the bundle form
# (the CUDA bundle's plain twin here) on one grouping each
FORMS = {
    "frozen": (lambda pkg, **m: pkg.SolverParameters.fast_f32(
        heat_vapor=True, heat_frozen_props=True, **m), 1800.0,
        [((2, 2), (0, 1, 2, 3)), ((2, 2), (0, 0, 1, 1)), ((1, 4), (0, 1, 2, 3)),
         ((1, 4), (0, 0, 1, 1))]),
    "f64": (lambda pkg, **m: pkg.SolverParameters(heat_vapor=True, **m), 600.0,
            [((2, 2), (0, 1, 2, 3))]),
    "bundle": (lambda pkg, **m: pkg.SolverParameters.fast_f32(
        use_pallas=True, heat_vapor=True, heat_frozen_props=True, **m), 600.0,
        [((2, 2), (0, 0, 1, 1))]),
}
SPLITS = [(form, shape, machines) for form, (_, _, runs) in FORMS.items()
          for shape, machines in runs]


@pytest.fixture(scope="module")
def cases():
    return dict(inputs={}, runs={})


def inputs(cases, form):
    """``jax_coupled_case`` for ``form``: JAX's inputs and the port's (the
    same arrays on the CPU)."""
    if form not in cases["inputs"]:
        jin = jax_coupled_case(FORMS[form][0](J))
        th, tb = port_heat(jin[2], jin[3])
        cases["inputs"][form] = (jin, (port_grid(jin[0]), port_state(jin[1]), th, tb))
    return cases["inputs"][form]


def period(cases, form, shape, machines=None) -> dict:
    """The port's period of ``form`` on ``shape`` CPU blocks (one machine,
    or the ``machines`` grouping), gathered, with its counts, host reads,
    bundle launches and the drivers' counts (each run once a module)."""
    key = (form, shape, machines)
    if key not in cases["runs"]:
        make, length, _ = FORMS[form]
        mesh = cpu_mesh(shape, machines)
        blocked = [TS.shard_pytree(x, mesh) for x in inputs(cases, form)[1]]
        CP.reset_counts()
        DL.reset_counts()
        host_read.count = 0
        TB.jacobi_bundle.launches = 0
        w, h = CP.compute_period_coupled(blocked[0], make(T, mesh=mesh), *blocked[1:], length)
        cases["runs"][key] = dict(w=TS.gather_pytree(w), h=TS.gather_pytree(h),
                                  counts=CP.counts(), reads=host_read.count,
                                  launches=TB.jacobi_bundle.launches, drivers=DL.counts(),
                                  driver=DL.driver_for(mesh.home, mesh)[0])
    return cases["runs"][key]


@pytest.mark.parametrize("form,shape,machines", SPLITS,
                         ids=[f"{f}-{r}x{c}-{len(set(m))}" for f, (r, c), m in SPLITS])
def test_machines_bit_equal_to_one_machine(cases, form, shape, machines):
    """The coupled period with the blocks split into 4 or 2 machines, in
    rounds, against one machine over the same blocks (the eager driver):
    water stats, chunks, sub-steps accepted and rejected, heat sweeps and
    bundle launches equal; h, T, T_old, the heat sink, both MBRs and every
    water balance bit-equal. The rounds driver reads the host once a batch
    of at most UNITS_PER_LAUNCH rounds and nowhere else in the period; the
    rounds counted are those that ran a segment."""
    one = period(cases, form, shape)
    split = period(cases, form, shape, machines)
    assert one["driver"] == "eager" and split["driver"] == "rounds"
    assert split["drivers"]["rounds_periods"] == 1 and split["drivers"]["eager_periods"] == 0
    assert split["counts"] == one["counts"]
    assert one["counts"]["heat_sweeps"] > 0 and one["counts"]["chunks"] > 0
    assert split["launches"] == one["launches"]
    (wa, ha), (wb, hb) = (one["w"], one["h"]), (split["w"], split["h"])
    for f in ("h", "h_old", "se", "k", "boundary_flow_sum", "dt_curr", "courant"):
        assert torch.equal(getattr(wa, f), getattr(wb, f)), f
    for bal in ("balance_current", "balance_period", "balance_whole"):
        for f in dataclasses.fields(getattr(wa, bal)):
            assert torch.equal(getattr(getattr(wa, bal), f.name),
                               getattr(getattr(wb, bal), f.name)), (bal, f.name)
    for f in ("t", "t_old", "sink_source", "storage_prev", "sink_whole", "mbr"):
        assert torch.equal(getattr(ha, f), getattr(hb, f)), f
    rounds = split["drivers"]["rounds"]
    assert split["reads"] == split["drivers"]["launches"] == -(-rounds // DL.UNITS_PER_LAUNCH)
    assert split["drivers"]["rounds_enqueued"] == rounds > 0


@pytest.mark.parametrize("form", ["f64", "frozen"])
def test_machines_match_jax_gspmd_period(cases, form):
    """The period on 2 x 2 CPU blocks in 4 machines against JAX's
    ``compute_period_coupled`` on grid, water, heat and boundary sharded
    over a 2 x 2 mesh of the conftest's virtual CPU devices (GSPMD), at
    JAX_CASES' bars: float64 h within 1e-9 m and T within 1e-7 K, frozen h
    within 1e-4 m and T within 5e-3 K; dt equal."""
    make, length, _ = FORMS[form]
    h_tol, t_tol = {"f64": JAX_CASES["f64_vapor"][2:], "frozen": JAX_CASES["frozen_vapor"][2:]}[
        form]
    jin, _ = inputs(cases, form)
    jm = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("row", "col"))
    jg, jw0, jh0, jb = (JS.shard_pytree(x, jm) for x in jin)
    jw, jh = j_period(jg, make(J), jw0, jh0, jb, length)
    run = period(cases, form, (2, 2), (0, 1, 2, 3))
    assert float(run["w"].dt_curr) == float(jw.dt_curr)
    np.testing.assert_allclose(run["w"].h.numpy(), np.asarray(jw.h), rtol=0, atol=h_tol)
    np.testing.assert_allclose(run["h"].t.numpy(), np.asarray(jh.t), rtol=0, atol=t_tol)


def test_heat_sweeps_counted_once(cases, monkeypatch):
    """``heat_jacobi_solve.sweeps`` of the float64 period in 4 machines is
    one machine's: only the machine holding block (0, 0) counts a sweep.
    Were every machine to count its own (the gate forced open), the
    rounds would report 4 times the sweeps."""
    one = period(cases, "f64", (2, 2))["counts"]["heat_sweeps"]
    assert period(cases, "f64", (2, 2), (0, 1, 2, 3))["counts"]["heat_sweeps"] == one > 0
    make, length, _ = FORMS["f64"]
    mesh = cpu_mesh((2, 2), (0, 1, 2, 3))
    blocked = [TS.shard_pytree(x, mesh) for x in inputs(cases, "f64")[1]]
    monkeypatch.setattr(TH, "holds_home", lambda x: True)
    CP.reset_counts()
    CP.compute_period_coupled(blocked[0], make(T, mesh=mesh), *blocked[1:], length)
    assert TH.heat_jacobi_solve.sweeps == 4 * one


def test_one_step_split_into_machines(cases):
    """``compute_step_coupled`` (the machine's one-step mode) on 2 x 2
    blocks in 4 machines against one machine: water and heat states and
    dt bit-equal, the same counts."""
    make, _, _ = FORMS["frozen"]
    outs = []
    for machines in (None, (0, 1, 2, 3)):
        mesh = cpu_mesh((2, 2), machines)
        blocked = [TS.shard_pytree(x, mesh) for x in inputs(cases, "frozen")[1]]
        CP.reset_counts()
        w, h, dt = CP.compute_step_coupled(blocked[0], make(T, mesh=mesh), *blocked[1:],
                                           3600.0)
        outs.append((TS.gather_pytree(w), TS.gather_pytree(h), dt, CP.counts()))
    (wa, ha, dta, ca), (wb, hb, dtb, cb) = outs
    assert dta == dtb and ca == cb and ca["steps"] == 1 and ca["heat_sweeps"] > 0
    assert torch.equal(wa.h, wb.h) and torch.equal(wa.se, wb.se)
    assert torch.equal(ha.t, hb.t) and torch.equal(ha.mbr, hb.mbr)


def test_a_failed_coupled_machine_raises_and_no_machine_waits(cases, monkeypatch):
    """A heat unit that raises in one machine of the rounds ends the period
    with RuntimeError naming it; the other machines' threads stop (no hang:
    no thread of the run is left)."""
    make, _, _ = FORMS["frozen"]
    mesh = cpu_mesh((2, 2), (0, 1, 2, 3))
    blocked = [TS.shard_pytree(x, mesh) for x in inputs(cases, "frozen")[1]]
    real = CP._CoupledMachine._substep_end

    def broken(self):
        if self.grid.blocks[1, 1] is not None:
            raise ValueError("a broken heat balance")
        return real(self)
    monkeypatch.setattr(CP._CoupledMachine, "_substep_end", broken)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="a broken heat balance"):
        CP.compute_period_coupled(blocked[0], make(T, mesh=mesh), *blocked[1:], 600.0)
    assert threading.active_count() == before
