"""``solver/heat.py`` ``heat_sweep``: one Jacobi sweep of the coupled
hour's heat system (the frozen chunk system of the cell's initial state,
folded to its first chunk) and the max-norm of its update.

Reads, once each: b, c_up, c_down (boxes), c_lat (8 boxes), the heat mask
(bool box) and x. Writes the new x. 23 operations a box node: 10 products
and 10 sums of the stencil, the select, the difference's absolute value and
the maximum.
"""

from __future__ import annotations

import torch

from benchmark.roofline import Call, nbytes

FLOPS_PER_NODE = 23


def prepare(system) -> Call:
    from criteria3d_tpu_torch.solver import heat as H
    grid, water, heat, boundary = system.inputs
    params = system.params
    dt_water = 300.0
    heat_flow, chunk, _ = H.update_boundary_heat(grid, params, heat, boundary, water, 120.0,
                                                 dt_water)
    inner = grid.mask.clone()
    inner[0] = False
    flow_sum = torch.where(inner, heat_flow, 0.0).sum()
    inv = H.energy_invariants(grid, params, water, chunk, dt_water)
    fz = H.chunk_frozen_system(grid, params, heat.t, water, chunk, dt_water, heat_flow,
                               flow_sum, inv)
    b_p, c_up, c_down, c_lat, t0 = H.fold_dt(params, fz, heat.t, chunk)
    sweep_system = (b_p, c_up, c_down, c_lat, fz.heat_mask)
    x_new, _ = H.heat_sweep(sweep_system, t0)

    def fn():
        return H.heat_sweep(sweep_system, t0)

    return Call(fn, nbytes(*sweep_system, t0), nbytes(x_new),
                FLOPS_PER_NODE * grid.mask.numel(), 50)
