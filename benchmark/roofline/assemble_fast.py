"""``solver/water.py`` ``assemble_fast``: one float32 Picard assembly (the
retention chain, boundary flows, vertical and lateral conductances and the
Jacobi-scaled stencil) on the cell's storm state at a 300 s step, without
the heat hooks.

Reads, once each: psi, psi_old and se (float32 boxes), the sink (float64
box), the pond (float64 plane); of the grid's float32 copy the volume,
boundary size and slope (boxes), the ten soil fields (boxes), the
roughness (plane), the lateral distances and elevation steps (8 planes
each) and the per-layer lateral areas and vertical distances; the grid's
boundary types (int8 box), mask (bool box) and float64 vertical distances.
Writes the stencil's b, c_up, c_down, diag (boxes) and c_lat (8 boxes), the
water flow, boundary rate and conductivity (boxes). About 200 float32
operations a box node: four powers (an exp and a log each), the retention
and conductance chains, eight lateral links of ~15 each.
"""

from __future__ import annotations

import torch

from benchmark.roofline import Call, nbytes

FLOPS_PER_NODE = 200
SOIL = ("vg_alpha", "vg_n", "vg_m", "vg_he", "vg_sc", "theta_s", "theta_r", "k_sat",
        "mualem_l", "mualem_den")


def prepare(system) -> Call:
    from criteria3d_tpu_torch.solver import water as W
    grid, water = system.inputs[:2]
    params = system.params
    sd = params.sweep_dtype
    psi = torch.where(grid.mask, water.h - grid.z, 0.0).to(sd)
    psi_old = psi.clone()
    se = W.compute_se_psi(grid, params, psi)
    g32 = grid.astype(sd)
    reads = [psi, psi_old, se, water.sink_source, water.pond, g32.volume, g32.bsize,
             g32.bslope, g32.roughness, g32.lat_dist3d, g32.dz_lat, g32.lat_area,
             g32.vert_dist, g32.lat_dist2d, grid.btype, grid.mask, grid.vert_dist]
    reads += [getattr(g32.soil, f) for f in SOIL]

    def fn():
        return W.assemble_fast(grid, params, psi, psi_old, se, water.sink_source, water.pond,
                               0, 300.0)

    system_, water_flow, rate, k = fn()
    writes = [system_.b, system_.c_up, system_.c_down, system_.c_lat, system_.diag,
              water_flow, rate, k]
    return Call(fn, nbytes(*reads), nbytes(*writes), FLOPS_PER_NODE * grid.mask.numel(), 10)
