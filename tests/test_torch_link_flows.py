"""The port's per-link flow accounting (``track_link_flow``) and its getters
against the JAX package, on tests/test_link_flows.py's case (an 8 x 8
valley, 5 mm/h for an hour): the float64 path (rel 1e-9 of max |flow|) and
``fast_f32()`` CG (rel 1e-4). Both implementations get the same numpy
inputs; the port runs on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import link_flows as JLF
from criteria3d_tpu.solver.step import compute_period as j_period
from criteria3d_tpu.solver.step import initialize_balance as j_init_balance
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.solver import link_flows as TLF
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d
from tests.test_torch_core import port_state

torch.set_num_threads(1)

GETTERS = ("up_flow", "down_flow", "max_lateral_flow", "sum_lateral_flow",
           "sum_lateral_flow_in", "sum_lateral_flow_out")
SOIL = dict(vg_alpha=1.2, vg_n=1.5, vg_he=0.02, theta_s=0.41, theta_r=0.04,
            k_sat=1e-5)


def make_case(m, params, n=8):
    """tests/test_link_flows.py's make_case for package ``m`` (J or T)."""
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 100.0 + (n - 1 - rows) * 0.4 + np.abs(cols - n // 2) * 0.6
    kw = {} if m is J else dict(device="cpu")
    grid = m.Grid.build(dem, 10.0, m.SoilFields.uniform(dem.shape, **kw, **SOIL),
                        total_depth=0.5, **kw)
    state = m.WaterState.initialize(grid, params, matric_potential=-2.0, **kw)
    if m is J:
        state = j_init_balance(grid, params, state)
        sink = jnp.zeros_like(state.sink_source).at[0].set(
            jnp.where(grid.mask[0], 0.005 * float(grid.area) / 3600.0, 0.0))
    else:
        state = T.initialize_balance(grid, params, state)
        sink = torch.zeros_like(state.sink_source)
        sink[0] = torch.where(grid.mask[0], torch.full_like(
            sink[0], 0.005 * float(grid.area) / 3600.0), 0.0)
    return grid, dataclasses.replace(state, sink_source=sink)


RUNS = {
    "f64": (lambda m: m.SolverParameters(track_link_flow=True), 1e-9),
    "fast_cg": (lambda m: m.SolverParameters.fast_f32(track_link_flow=True), 1e-4),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def run(request):
    mk, rtol = RUNS[request.param]
    jp, tp = mk(J), mk(T)
    jg, js = make_case(J, jp)
    tg, ts = make_case(T, tp)
    jout = j_period(jg, jp, js, 3600.0)
    tout = T.compute_period(tg, tp, ts, 3600.0)
    return request.param, rtol, jg, jout, tg, tout


def _close(t, j, rtol, name):
    a = np.asarray(j)
    assert t.dtype == torch.float64, name
    np.testing.assert_allclose(t.numpy(), a, rtol=0,
                               atol=rtol * float(np.abs(a).max()), err_msg=name)


def test_link_flow_sum_matches_jax(run):
    """link_flow_sum (10, L, R, C) and the heads: f64 within rel 1e-9 of
    max |flow|, fast_f32() CG within rel 1e-4; rain crosses the surface."""
    name, rtol, jg, jout, tg, tout = run
    assert tuple(tout.link_flow_sum.shape) == (10,) + tuple(tg.shape)
    _close(tout.link_flow_sum, jout.link_flow_sum, rtol, "link_flow_sum")
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-9 if name == "f64" else 1e-4)
    assert float(TLF.down_flow(tout)[0][tg.mask[0]].min()) < 0.0


@pytest.mark.parametrize("getter", GETTERS)
def test_getters_match_jax(run, getter):
    name, rtol, jg, jout, tg, tout = run
    _close(getattr(TLF, getter)(tout), getattr(JLF, getter)(jout), rtol, getter)


def test_link_flows_antisymmetric(run):
    """The port's own sums: a vertical link seen from above is minus the
    same link seen from below, and so is a lateral link seen from its two
    nodes (tests/test_link_flows.py's checks, rel 1e-9; the psi form
    rounds its two sides apart in float32, rel 1e-4 of max |flow|)."""
    name, rtol, _, _, tg, tout = run
    flows = tout.link_flow_sum.numpy()
    mask = tg.mask.numpy()
    atol = 1e-15 if name == "f64" else rtol * np.abs(flows).max()
    for layer in range(tg.shape[0] - 1):
        m = mask[layer] & mask[layer + 1]
        np.testing.assert_allclose(flows[1, layer][m], -flows[0, layer + 1][m],
                                   rtol=1e-9, atol=atol)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        opp = LATERAL_OFFSETS.index((-di, -dj))
        theirs = shift2d(tout.link_flow_sum[2 + opp], di, dj).numpy()
        m = mask & shift2d(tg.mask, di, dj, fill=False).numpy()
        np.testing.assert_allclose(flows[2 + idx][m], -theirs[m], rtol=1e-9,
                                   atol=atol)


def test_convert_carries_link_flows(run):
    """convert.py carries a float64 state with its (10, L, R, C)
    link_flow_sum exactly."""
    _, _, _, jout, _, _ = run
    cs = port_state(jout)
    assert cs.h.dtype == torch.float64
    np.testing.assert_array_equal(cs.link_flow_sum.numpy(),
                                  np.asarray(jout.link_flow_sum))
    np.testing.assert_array_equal(TLF.sum_lateral_flow_in(cs).numpy(),
                                  cs.link_flow_sum.numpy()[2:].clip(0).sum(0))


@pytest.mark.parametrize("getter", GETTERS)
def test_getters_refuse_untracked_state(getter):
    """Without track_link_flow the state holds a (0,) placeholder and
    every getter raises ValueError, as in the JAX package."""
    tp = T.SolverParameters()
    _, ts = make_case(T, tp)
    assert tuple(ts.link_flow_sum.shape) == (0,)
    with pytest.raises(ValueError, match="track_link_flow"):
        getattr(TLF, getter)(ts)
