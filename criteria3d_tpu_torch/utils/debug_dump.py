"""Solver-state / linear-system debug dumps.

PyTorch counterpart of ``criteria3d_tpu/utils/debug_dump.py``, writing the
same ``.npz`` keys. Analogue of the reference's MCR logging
(logFunctions.h:17-60, gated by MCR_ENABLED): `logNodeGridStruct` dumps the
whole nodeGrid and `createCurrStepLog` dumps each approximation's (A, b, x)
to MATLAB .mat files for hand-operated differential debugging (SURVEY §4).

Here the carrier is ``.npz`` (loadable from numpy/Matlab/Octave alike):

* :func:`dump_solver_state` — the full water state + static grid fields;
* :func:`dump_linear_system` — the assembled 11-point stencil system of the
  CURRENT state, assembled on the state's device (the per-approximation
  analogue: call it between compute_step calls, or at any Picard iterate
  you reconstruct).

Every array and number copied to the host goes through
:func:`~criteria3d_tpu_torch.device.host_array` /
:func:`~criteria3d_tpu_torch.device.host_read`, so the reads are counted.
"""

from __future__ import annotations

import numpy as np

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_array, host_read

__all__ = ["dump_solver_state", "dump_linear_system", "load_dump"]


def dump_solver_state(path: str, grid: Grid, params: SolverParameters,
                      state: WaterState) -> str:
    """Write the nodeGrid-equivalent arrays (logNodeGridStruct analogue)."""
    if not path.endswith(".npz"):
        path += ".npz"
    a = host_array
    np.savez_compressed(
        path,
        mask=a(grid.mask), z=a(grid.z),
        volume=a(grid.volume), btype=a(grid.btype),
        bslope=a(grid.bslope), bsize=a(grid.bsize),
        roughness=a(grid.roughness),
        pond_max=a(grid.pond_max),
        vg_alpha=a(grid.soil.vg_alpha),
        vg_n=a(grid.soil.vg_n),
        theta_s=a(grid.soil.theta_s),
        theta_r=a(grid.soil.theta_r),
        k_sat=a(grid.soil.k_sat),
        h=a(state.h), h_old=a(state.h_old),
        se=a(state.se), k=a(state.k),
        sink_source=a(state.sink_source),
        pond=a(state.pond),
        dt_curr=float(host_read(state.dt_curr)),
        courant=float(host_read(state.courant)),
        balance_storage=float(host_read(state.balance_current.storage)),
        balance_mbr=float(host_read(state.balance_current.mbr)))
    return path


def dump_linear_system(path: str, grid: Grid, params: SolverParameters,
                       state: WaterState, dt: float,
                       approx: int = 0) -> str:
    """Assemble and write the current linearised system
    (createCurrStepLog analogue: the preconditioned 11-point stencil —
    b, c_up/c_down/c_lat, diagonal — plus capacity, conductivity and the
    boundary flows of this iterate)."""
    from criteria3d_tpu_torch.solver import water as W

    if not path.endswith(".npz"):
        path += ".npz"

    h = state.h
    h_old = state.h_old
    se = W.compute_se(grid, params, h)
    capacity, k = W.compute_capacity(grid, params, h, h_old, se)
    flow, rate = W.update_boundary_water(
        grid, params, h, h_old, k, state.sink_source, state.pond, float(dt))
    system = W.assemble_system(grid, params, h, h_old, k, flow, capacity,
                               state.pond, int(approx), float(dt))
    a = host_array
    np.savez_compressed(
        path,
        b=a(system.b), diag=a(system.diag),
        c_up=a(system.c_up), c_down=a(system.c_down),
        c_lat=a(system.c_lat),
        courant=float(host_read(system.courant)),
        capacity=a(capacity), k=a(k),
        water_flow=a(flow), boundary_rate=a(rate),
        x0=a(h), dt=float(dt), approx=int(approx))
    return path


def load_dump(path: str) -> dict:
    """Load a dump back as {name: array} (the .mat-reader counterpart)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
