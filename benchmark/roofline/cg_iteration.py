"""``solver/step.py`` ``cg_iteration``: one iteration of the CG-line solve
(the scaled matvec, the line preconditioner's Thomas sweeps over the
layers, two D-weighted dot products summed in float64, the psi-weighted
norm, the x, s and p updates) from ``cg_start`` on the cell's first
system (the storm state's assembly at a 300 s step).

Reads, once each: the mask (bool box), c_up, c_down, diag (float32 boxes),
c_lat (8 float32 boxes), x, s and p (float32 boxes). Writes x, s and p.
48 float32 operations a box node: the matvec's 10 products and 10 sums and
its subtraction, the dot products' 3 + 3, the updates' 2 + 2 + 2, the
Thomas sweeps' 9, the norm's 6.
"""

from __future__ import annotations

import torch

from benchmark.roofline import Call, nbytes

FLOPS_PER_NODE = 48


def prepare(system) -> Call:
    from criteria3d_tpu_torch.solver import water as W
    from criteria3d_tpu_torch.solver.step import cg_iteration, cg_operators, cg_start
    grid, water = system.inputs[:2]
    params = system.params
    sd = params.sweep_dtype
    psi = torch.where(grid.mask, water.h - grid.z, 0.0).to(sd)
    se = W.compute_se_psi(grid, params, psi)
    lin = W.assemble_fast(grid, params, psi, psi, se, water.sink_source, water.pond, 0,
                          300.0)[0]
    ops = cg_operators(lin, grid, params, True, sd)
    s0, p0, rho0, norm0 = cg_start(ops, psi)
    tol = torch.full((), 1e-7, dtype=sd, device=psi.device)
    best = torch.maximum(norm0, tol)
    reads = [grid.mask, lin.c_up, lin.c_down, lin.diag, lin.c_lat, psi, s0, p0]
    writes = [psi, s0, p0]

    def fn():
        return cg_iteration(ops, psi, s0, p0, rho0, best, tol)

    return Call(fn, nbytes(*reads), nbytes(*writes), FLOPS_PER_NODE * grid.mask.numel(), 50)
