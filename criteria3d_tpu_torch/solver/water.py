"""Water-process physics: conductances, boundary fluxes, capacity, balance.

PyTorch counterpart of ``criteria3d_tpu/solver/water.py``
(agrolib/soilFluxes3D/water.cpp as dense (L, R, C) stencil passes): the
float64 parity path (``update_boundary_water``, ``compute_capacity``,
``assemble_system``, ``jacobi_sweep``, ``current_mass_balance``), the
float32 psi-carry path (``assemble_fast``, on the card a hand-written CUDA
kernel pair, and its psi-form helpers) and the
conjugate-gradient operators (``stencil_apply``,
``tridiag_vertical_solve``). Every function evaluates the same expressions
in the same order and dtypes as its JAX twin. Two dtype rules of the JAX
package (x64 on) are spelt out here because torch promotes differently: a
0-d float64 array times a float32 array is float64 in JAX but float32 in
torch, so such products cast explicitly; and balance sums accumulate
float32 values in float64 (``sum(dtype=float64)``).

Scalars that divide tensors (``dt``, ``pi``, node counts) are 0-d tensors
on the tensors' device: CUDA turns division by a host scalar into
multiplication by its rounded reciprocal, which the JAX package does not
do. The step size ``dt`` and the Picard index ``approx`` may be Python
numbers or 0-d tensors (the water step's machine passes its float64 and
int64 carries, solver/step.py): a float32 field takes one float32 rounding
of ``dt`` either way, and no function reads a tensor's value on the host,
so a CUDA graph can hold them.

On a mesh every function runs on one block of the grid and state, grown
by its ring (parallel/sharding.py): the per-cell arithmetic is the whole
box's, the stencils are exact on all but the block's outer cell when their
inputs' rings are fresh, and the functions that end in a global sum have a
``*_sum(s)`` form whose ``ring`` argument keeps the sum to the cells the
block owns (0, the whole box, is the plain function's sum).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from criteria3d_tpu_torch.constants import (DBL_EPSILON, EPSILON_METER,
                                            EPSILON_RUNOFF, PI,
                                            MIN_INFILTRATION_RATE)
from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.soil import (compute_mean, dtheta_dh,
                                            mualem_conductivity, power,
                                            se_from_psi, theta_from_se)
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import scalar, tally
from criteria3d_tpu_torch.parallel.sharding import owned
from criteria3d_tpu_torch.solver import assemble_kernel as AK
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d

__all__ = [
    "LinearSystem", "compute_se", "water_content_sums", "total_water_content",
    "update_boundary_water", "compute_capacity", "assemble_system",
    "assemble_fast", "assemble_fast_reference", "compute_se_psi", "mass_balance_sums",
    "mass_balance_sums_psi", "balance_from_sums", "current_mass_balance",
    "current_mass_balance_psi", "jacobi_sweep_sum", "jacobi_sweep_psi_sum",
    "jacobi_sweep", "jacobi_sweep_psi", "stencil_apply", "tridiag_vertical_solve",
]


class LinearSystem(NamedTuple):
    """Jacobi-preconditioned linear system in stencil form:
    ``x_new = b + c_up * x(l-1) + c_down * x(l+1) + sum_k c_lat[k] * x(nbr_k)``.
    """

    b: torch.Tensor        # (L,R,C) preconditioned RHS
    c_up: torch.Tensor     # (L,R,C) coefficient towards layer above
    c_down: torch.Tensor   # (L,R,C) coefficient towards layer below
    c_lat: torch.Tensor    # (8,L,R,C) lateral coefficients
    diag: torch.Tensor     # (L,R,C) original diagonal (C/dt + sum a)
    courant: torch.Tensor  # 0-d: max surface Courant number of this assembly


def _work_dtype(params: SolverParameters):
    """Dtype of the retention / conductivity math: the sweep dtype on the
    fast path, else the state dtype."""
    return params.sweep_dtype if params.sweep_dtype is not None else params.dtype


def _soil_wd(grid: Grid, wd):
    """Soil parameter fields in the working dtype (the grid's own on the
    f64 path)."""
    if grid.soil.vg_alpha.dtype == wd:
        return grid.soil
    return grid.astype(wd).soil


def _is_first(approx, device):
    """``approx == 0``, the approx-0 rainfall predictor's switch: a Python
    bool for a number, a 0-d bool tensor on ``device`` for a tensor."""
    if isinstance(approx, torch.Tensor):
        return (approx == 0).to(device)
    return int(approx) == 0


def _set0(a: torch.Tensor, v) -> torch.Tensor:
    """Copy of ``a`` with row 0 of the leading axis set to ``v``."""
    a = a.clone()
    a[0] = v
    return a


def compute_se(grid: Grid, params: SolverParameters,
               h: torch.Tensor) -> torch.Tensor:
    """Subsurface degree of saturation from total potential
    (computeNodeSe, soilPhysics.cpp:68-83); layer 0 keeps Se = 1. On the
    fast path the retention curve runs in float32 and the result is
    float64 holding float32-quantised values."""
    wd = _work_dtype(params)
    psi = torch.abs(h - grid.z).to(wd)
    se = torch.where(h >= grid.z, 1.0,
                     se_from_psi(grid.astype(wd).soil, psi, params.wrc_model))
    se = _set0(se, 1.0)
    return torch.where(grid.mask, se, 0.0).to(params.dtype)


def water_content_sums(grid: Grid, params: SolverParameters,
                       h: torch.Tensor, se: torch.Tensor, ring: int = 0):
    """``(surface, soil)`` water volumes [m3] of the cells a block with
    ``ring`` owns, as 0-d float64 sums: surface water depth x area, soil
    theta x volume."""
    surf = torch.clamp_min(h[0] - grid.z[0], 0.0) * grid.volume[0]
    surf = torch.where(grid.mask[0], surf, 0.0)
    wd = _work_dtype(params)
    if wd != params.dtype:
        g = grid.astype(wd)
        theta = theta_from_se(g.soil, se.to(wd))
        soil = torch.where(grid.mask, theta * g.volume, 0.0)
    else:
        theta = theta_from_se(grid.soil, se)
        soil = torch.where(grid.mask, theta * grid.volume, 0.0)
    soil = _set0(soil, 0.0)
    return (owned(surf, ring).sum(dtype=torch.float64),
            owned(soil, ring).sum(dtype=torch.float64))


def total_water_content(grid: Grid, params: SolverParameters,
                        h: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """Total water volume [m3] (computeTotalWaterContent, water.cpp:71-90):
    surface water depth x area plus soil theta x volume, summed in float64."""
    surf, soil = water_content_sums(grid, params, h, se)
    return (surf + soil).to(h.dtype)


def update_boundary_water(grid: Grid, params: SolverParameters,
                          h: torch.Tensor, h_old: torch.Tensor,
                          k: torch.Tensor, sink_source: torch.Tensor,
                          pond: torch.Tensor, dt):
    """Per-node flow [m3 s-1] = sink/source + boundary flux
    (updateBoundaryWaterData, water.cpp:632-807); returns
    ``(water_flow, boundary_rate)``. ``dt`` [s] is a number or a 0-d
    tensor. Urban and road nodes carry no boundary flow (they only modulate
    infiltration, water.cpp:503-513)."""
    dev = h.device
    dt = scalar(dt, h.dtype, dev)
    avg_h = 0.5 * (h + h_old)
    flow = torch.where(grid.mask, sink_source, 0.0)

    # surface negative flux (evaporation) limited by available water
    h_s0 = torch.clamp_min(avg_h[0] - grid.z[0], 0.0)
    max_surf_flux = -h_s0 * grid.volume[0] / dt
    flow0 = torch.where(flow[0] < 0, torch.maximum(flow[0], max_surf_flux),
                        flow[0])
    flow = _set0(flow, torch.where(grid.mask[0], flow0, 0.0))

    bt = grid.btype

    # Runoff (surface rim): Manning outflow
    hs = torch.clamp_min(avg_h[0] - (grid.z[0] + pond), 0.0)
    rough = torch.clamp_min(grid.roughness, 1e-12)
    v = (power(hs, 2.0 / 3.0) * torch.sqrt(torch.clamp_min(grid.bslope[0], 0.0))
         / rough)
    max_flow = hs * grid.volume[0] / dt
    val_flow = hs * v * grid.bsize[0]
    runoff_rate0 = torch.where(hs < EPSILON_RUNOFF, 0.0,
                               -torch.minimum(val_flow, max_flow))
    runoff_rate = _set0(torch.zeros_like(h), runoff_rate0)

    # FreeDrainage (bottom): Darcy unit gradient through the up interface
    fd_rate = -k * grid.area
    # FreeLateralDrainage (rim soil): Darcy gradient = slope
    fld_rate = -k * grid.bsize * grid.bslope * params.lateral_vertical_ratio

    if grid.has_prescribed:
        # PrescribedTotalWaterPotential: fixed head 1 m below
        wd = _work_dtype(params)
        soil_w = _soil_wd(grid, wd)
        Lb = 1.0
        boundary_z = grid.z - Lb
        boundary_psi = (grid.prescribed_h - boundary_z).to(wd)
        k_bound = torch.where(
            boundary_psi >= 0, soil_w.k_sat,
            mualem_conductivity(
                soil_w,
                se_from_psi(soil_w, torch.abs(boundary_psi), params.wrc_model),
                params.wrc_model))
        mean_k = compute_mean(k_bound, torch.clamp_min(k.to(wd), 1e-30),
                              params.mean_type)
        dh = grid.prescribed_h - h
        presc_rate = mean_k.to(params.dtype) * grid.bsize * dh / scalar(
            Lb, h.dtype, dev)
    else:
        presc_rate = torch.zeros_like(h)

    if grid.has_culvert:
        # Culvert (surface outlet): open-channel / mixed / pressure rating
        # (water.cpp:749-795)
        cw = grid.culvert_w
        ch = torch.clamp_min(grid.culvert_h, 1e-12)
        crough = torch.clamp_min(grid.culvert_rough, 1e-12)
        cslope = torch.clamp_min(grid.bslope[0], 0.0)
        if params.culvert_reference_compat:
            # the reference's verbatim 0.5*(H - Hold) - z (water.cpp:760)
            wl = 0.5 * (h[0] - h_old[0]) - grid.z[0]
        else:
            wl = 0.5 * (h[0] + h_old[0]) - grid.z[0]
        # pressure flow, Hazen-Williams with C=70 (rough concrete)
        eq_diam = torch.sqrt(4.0 * cw * ch / scalar(PI, h.dtype, dev))
        pressure_flow = (70.0 * power(cslope, 0.54) * power(eq_diam, 2.63)
                         / scalar(3.591, h.dtype, dev))
        # full-section Manning flow (bsize = width*height)
        hr_full = grid.bsize[0] / torch.clamp_min(cw + 2.0 * ch, 1e-12)
        manning_full = ((grid.bsize[0] / crough) * torch.sqrt(cslope)
                        * power(hr_full, 2.0 / 3.0))
        mix_w = torch.clamp((wl - ch) / (0.5 * ch), 0.0, 1.0)
        mixed_flow = mix_w * pressure_flow + (1.0 - mix_w) * manning_full
        # open-channel Manning at the current water level
        oc_area = cw * torch.clamp_min(wl, 0.0)
        hr_open = oc_area / torch.clamp_min(
            cw + 2.0 * torch.clamp_min(wl, 0.0), 1e-12)
        open_flow = ((oc_area / crough) * torch.sqrt(cslope)
                     * power(hr_open, 2.0 / 3.0))
        culvert_flow = torch.where(
            wl >= 1.5 * ch, pressure_flow,
            torch.where(wl >= ch, mixed_flow,
                        torch.where(wl > pond, open_flow, 0.0)))
        culvert_rate = _set0(torch.zeros_like(h), -culvert_flow)
    else:
        culvert_rate = torch.zeros_like(h)

    rate = torch.zeros_like(h)
    rate = torch.where(bt == BoundaryType.RUNOFF, runoff_rate, rate)
    rate = torch.where(bt == BoundaryType.FREE_DRAINAGE, fd_rate, rate)
    rate = torch.where(bt == BoundaryType.FREE_LATERAL_DRAINAGE, fld_rate, rate)
    rate = torch.where(bt == BoundaryType.PRESCRIBED_TOTAL_POTENTIAL,
                       presc_rate, rate)
    rate = torch.where(bt == BoundaryType.CULVERT, culvert_rate, rate)
    # rates below DBL_EPSILON are zeroed, as the reference does
    rate = torch.where(torch.abs(rate) < DBL_EPSILON, 0.0, rate)
    rate = torch.where(grid.mask, rate, 0.0)
    return flow + rate, rate


def compute_capacity(grid: Grid, params: SolverParameters,
                     h: torch.Tensor, h_old: torch.Tensor, se: torch.Tensor):
    """Capacity vector C [m2] and refreshed conductivity K [m s-1]:
    surface capacity = cell area (cpusolver.cpp:151), soil capacity =
    volume x dTheta/dH (water.cpp:279-297).

    Both branches of the JAX function: pure float64, and the working-dtype
    branch for fast parameters (psi and its difference in float64, the VG
    evaluations in float32 with the secant only where the chord is
    float32-resolvable)."""
    wd = _work_dtype(params)
    soil_w = _soil_wd(grid, wd)
    k = mualem_conductivity(soil_w, se.to(wd), params.wrc_model)
    k = _set0(torch.where(grid.mask, k, 0.0), 0.0).to(params.dtype)

    if wd == params.dtype:
        dtdh = dtheta_dh(grid.soil, h, h_old, grid.z, params.wrc_model)
    else:
        psi_c = torch.abs(torch.clamp_max(h - grid.z, 0.0)).to(wd)
        psi_p = torch.abs(torch.clamp_max(h_old - grid.z, 0.0)).to(wd)
        if params.wrc_model.name == "VAN_GENUCHTEN":
            saturated = (psi_c == 0.0) & (psi_p == 0.0)
        else:
            saturated = (psi_c <= soil_w.vg_he) & (psi_p <= soil_w.vg_he)
        n = soil_w.vg_n
        x = soil_w.vg_alpha * torch.clamp_min(psi_c, 1e-20)
        term = (power(1.0 + power(x, n), -(soil_w.vg_m + 1.0))
                * power(x, n - 1.0))
        dse_a = soil_w.vg_alpha * n * soil_w.vg_m * term / soil_w.vg_sc
        se_c = se_from_psi(soil_w, psi_c, params.wrc_model)
        se_p = se_from_psi(soil_w, psi_p, params.wrc_model)
        dh_w = (h - h_old).to(wd)
        dse_s = torch.abs((se_c - se_p) / torch.where(dh_w != 0, dh_w, 1.0))
        resolvable = torch.abs(psi_c - psi_p) > 1e-4
        dse = torch.where(resolvable, dse_s, dse_a)
        dse = torch.where(saturated, 0.0, dse)
        dtdh = (dse * (soil_w.theta_s - soil_w.theta_r)).to(params.dtype)
    cap = grid.volume * dtdh
    cap = _set0(cap, grid.volume[0])
    cap = torch.where(grid.mask, cap, 1.0)
    return cap, k


def _vertical_conductance(grid: Grid, params: SolverParameters,
                          h: torch.Tensor, h_old: torch.Tensor,
                          k: torch.Tensor, water_flow: torch.Tensor,
                          dt) -> torch.Tensor:
    """a_up[l]: conductance of the link (l, l-1), a_up[0] = 0; l >= 2
    vertical redistribution (water.cpp:542-562), l == 1 surface-soil
    infiltration (water.cpp:490-539)."""
    L = grid.n_layers
    wd = _work_dtype(params)
    dev = h.device
    dt = scalar(dt, h.dtype, dev)
    avg_h = 0.5 * (h + h_old)
    k = k.to(wd)

    # redistribution: logarithmic-mean K x area / dz (the wrapped l = 0
    # row of the roll is masked out below)
    k_above = torch.roll(k, 1, dims=0)
    mean_k = compute_mean(torch.clamp_min(k, 1e-30),
                          torch.clamp_min(k_above, 1e-30), params.mean_type)
    dist = torch.where(grid.vert_dist > 0, grid.vert_dist, 1.0).to(wd)
    a_redist = mean_k * grid.area.to(wd) / dist

    # infiltration (link 0-1): dist01 is one number (vert_dist[1,0,0]),
    # ksat1 a plane (k_sat[1])
    dist01 = grid.vert_dist[1, 0, 0]
    bt1 = grid.btype[1]
    ksat1 = grid.soil.k_sat[1]
    bf = torch.where(bt1 == BoundaryType.ROAD, 0.0, torch.ones_like(ksat1))
    bf = torch.where(bt1 == BoundaryType.URBAN, 0.33, bf)
    sat_val = ksat1 * bf * grid.area / dist01

    surf_h = avg_h[0]
    soil_h = avg_h[1]
    surface_water = torch.clamp_min(surf_h - grid.z[0], 0.0)
    sbf = water_flow[0]
    surface_water = torch.where(
        sbf < 0,
        torch.clamp_min(surface_water + sbf * dt / grid.volume[0], 0.0),
        surface_water)
    max_inf_rate = surface_water / dt
    dh = torch.clamp_min(surf_h - soil_h, 1e-12)
    max_k = max_inf_rate * dist01 / dh
    mean_k01 = compute_mean(ksat1, torch.clamp_min(k[1], 1e-30),
                            params.mean_type)
    unsat_val = torch.where(
        max_inf_rate < MIN_INFILTRATION_RATE, 0.0,
        torch.minimum(bf * mean_k01, max_k) * grid.area / dist01)
    infil = torch.where(h[1] > grid.z[0], sat_val, unsat_val)

    layer_idx = torch.arange(L, device=dev).reshape(L, 1, 1)
    a_up = torch.where(layer_idx >= 2, a_redist, 0.0)
    if L > 1:
        a_up[1] = infil.to(wd)
    # the wrapped row of the rolled mask is reset
    link_ok = _set0(grid.mask & torch.roll(grid.mask, 1, dims=0), False)
    return torch.where(link_ok, a_up, 0.0)


def _lateral_conductances(grid: Grid, params: SolverParameters,
                          h: torch.Tensor, h_old: torch.Tensor,
                          k: torch.Tensor, water_flow: torch.Tensor,
                          pond: torch.Tensor, approx_is_first, dt):
    """(a_lat[8], courant_max): layer 0 the Manning diffusive-wave runoff
    conductance with Courant tracking (runoffConductance,
    water.cpp:413-487); layers >= 1 anisotropic lateral redistribution
    (water.cpp:542-562)."""
    lvr = params.lateral_vertical_ratio
    wd = _work_dtype(params)
    dt = scalar(dt, h.dtype, h.device)
    avg_h = 0.5 * (h + h_old)

    # surface quantities with the approx-0 rainfall predictor
    # (water.cpp:423-431)
    h_surf = avg_h[0] + torch.where(
        (water_flow[0] > 0) & approx_is_first,
        0.5 * water_flow[0] * dt / grid.volume[0], 0.0)
    z_pond = grid.z[0] + pond
    rough = grid.roughness

    k_soil = torch.clamp_min(k.to(wd) * lvr, 1e-30)
    lat_area_w = grid.lat_area.to(wd)

    a_list = []
    cour_max = []
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        nbr_ok = shift2d(grid.mask, di, dj, fill=False)

        # soil lateral redistribution
        k_nbr = torch.clamp_min(shift2d(k_soil, di, dj), 1e-30)
        mean_k = compute_mean(k_soil, k_nbr, params.mean_type)
        a_soil = mean_k * lat_area_w / grid.lat_dist3d[idx].to(wd)

        # surface runoff conductance
        hi = h_surf
        hj = shift2d(h_surf, di, dj)
        zi = z_pond
        zj = shift2d(z_pond, di, dj)
        hs = torch.maximum(hi, hj) - torch.maximum(zi, zj)
        dxy = grid.lat_dist2d[idx, 0, 0]
        rough_ij = 0.5 * (rough + shift2d(rough, di, dj))
        hs23 = power(torch.clamp_min(hs, 0.0), 2.0 / 3.0)
        a_surface = (grid.lat_area[0, 0, 0] * hs) * hs23 / (rough_ij * dxy)
        invalid = (hs <= EPSILON_METER) | (rough_ij <= 0.0)
        a_surface = torch.where(invalid, 0.0, a_surface)

        # Courant: Manning velocity x dt / dx; the reference's integer abs
        # truncates |dH| < 1 m to zero (water.cpp:477)
        dh_ij = torch.abs(hi - hj)
        if params.courant_reference_compat:
            dh_ij = torch.trunc(dh_ij)
        slope = torch.where(dh_ij > EPSILON_METER, dh_ij / dxy, 0.0)
        v = hs23 * torch.sqrt(slope) / rough_ij
        cour = torch.where(invalid | ~nbr_ok[0] | ~grid.mask[0], 0.0,
                           v * dt / dxy)
        # on a grown block the ring's values repeat its neighbours' cells,
        # and a link out of the block reads nbr_ok False (0): the block's
        # max is a max over cells of the whole box
        cour_max.append(cour.amax())

        a = _set0(a_soil, a_surface.to(wd))
        a_list.append(torch.where(grid.mask & nbr_ok, a, 0.0))
    courant = torch.clamp_min(torch.stack(cour_max).amax(), 0.0)
    return torch.stack(a_list), courant


def _sum_lateral(a_lat: torch.Tensor) -> torch.Tensor:
    """Sum over the 8 lateral links in index order, as XLA's reduction
    does."""
    total = a_lat[0]
    for idx in range(1, 8):
        total = total + a_lat[idx]
    return total


def assemble_system(grid: Grid, params: SolverParameters,
                    h: torch.Tensor, h_old: torch.Tensor, k: torch.Tensor,
                    water_flow: torch.Tensor, capacity: torch.Tensor,
                    pond: torch.Tensor, approx, dt) -> LinearSystem:
    """The Jacobi-preconditioned linear system of one Picard iteration,
    (C/dt + sum_j a_ij) H_i - sum_j a_ij H_j = C/dt H_i^0 + Q_i
    (computeLinearSystemElement + computeDiagonalElement +
    preconditioningMatrix, cpusolver.cpp:335-389, 284-305). ``approx`` and
    ``dt`` are numbers or 0-d tensors."""
    dt_t = scalar(dt, h.dtype, h.device)
    a_up = _vertical_conductance(grid, params, h, h_old, k, water_flow, dt_t)
    a_lat, courant = _lateral_conductances(
        grid, params, h, h_old, k, water_flow, pond, _is_first(approx, h.device), dt_t)

    # a_down[l] = a_up[l+1] (the same link seen from above); the wrapped
    # last row is reset
    a_down = torch.roll(a_up, -1, dims=0)
    a_down[-1] = 0.0

    sum_a = a_up + a_down + _sum_lateral(a_lat)
    diag = capacity / dt_t + sum_a
    diag = torch.where(grid.mask, diag, 1.0)

    b = (capacity / dt_t) * h_old + water_flow
    b = torch.where(grid.mask, b, 0.0)

    inv_diag = 1.0 / diag
    return LinearSystem(
        b=b * inv_diag,
        c_up=a_up * inv_diag,
        c_down=a_down * inv_diag,
        c_lat=a_lat * inv_diag[None],
        diag=diag,
        courant=courant,
    )


def assemble_fast(grid: Grid, params: SolverParameters,
                  psi: torch.Tensor, psi_old: torch.Tensor,
                  se: torch.Tensor, sink_source: torch.Tensor,
                  pond: torch.Tensor, approx, dt,
                  extra_flux_fn=None, boundary_flux_fn=None, out=None):
    """Capacity + boundary flows + stencil assembly in ONE float32 pass,
    with the RHS in psi-form (criteria3d_tpu.solver.water.assemble_fast):

        b'_i = (C_i/dt) psi_old_i + Q_i + sum_j a_ij (z_j - z_i)

    ``psi``/``psi_old``/``se`` are float32 signed-psi / saturation fields;
    returns ``(system, water_flow, boundary_rate, k)`` in float32 with a
    float64 ``system.courant``. ``approx`` is the Picard iteration index and
    ``dt`` the step [s] (numbers or 0-d tensors).

    The heat-coupling hooks receive SIGNED psi: ``boundary_flux_fn(psi,
    dt)`` is a boundary flow (the HeatSurface evaporative sink) added to
    the boundary rate, so it enters the RHS and the balance;
    ``extra_flux_fn(psi, k)`` (the thermal water flows) enters the RHS
    only. Both are cast to the sweep dtype.

    On CUDA tensors this launches the hand-written kernel pair of
    ``csrc/assemble_fast.cu`` (solver/assemble_kernel.py), bit-equal to the
    plain chain, and adds one to ``assemble_fast.launches`` (under a CUDA
    graph's capture, to the graph's count on the card: ``device.tally``); an
    input it does not take raises. On CPU tensors it runs the plain chain,
    :func:`assemble_fast_reference`. ``out``, when given, is ``(system,
    water_flow, boundary_rate, k)`` of float32 buffers (``system.courant``
    unused) that the kernels write the results into and that are then
    returned; the plain chain leaves it alone and returns new tensors.
    """
    if psi.device.type != "cuda":
        return assemble_fast_reference(grid, params, psi, psi_old, se, sink_source, pond,
                                       approx, dt, extra_flux_fn, boundary_flux_fn)
    arrays = None if out is None else (*out[0][:5], *out[1:])
    b, c_up, c_down, c_lat, diag, courant, water_flow, rate, k = AK.assemble(
        grid, params, psi, psi_old, se, sink_source, pond, approx, dt,
        extra_flux_fn, boundary_flux_fn, arrays)
    tally(assemble_fast, "launches", psi.device)
    return LinearSystem(b, c_up, c_down, c_lat, diag, courant), water_flow, rate, k


assemble_fast.launches = 0


def assemble_fast_reference(grid: Grid, params: SolverParameters,
                            psi: torch.Tensor, psi_old: torch.Tensor,
                            se: torch.Tensor, sink_source: torch.Tensor,
                            pond: torch.Tensor, approx, dt,
                            extra_flux_fn=None, boundary_flux_fn=None):
    """Plain PyTorch version of :func:`assemble_fast`, the same expressions
    in the same order and dtypes as the JAX function: the CPU path, and what
    the CUDA kernels are held to."""
    sd = params.sweep_dtype
    dev = psi.device
    mask = grid.mask
    g32 = grid.astype(sd)
    soil32 = g32.soil
    dt32 = scalar(dt, sd, dev)
    lvr = params.lateral_vertical_ratio

    avg_psi = 0.5 * (psi + psi_old)
    vol32 = g32.volume
    area32 = g32.area

    # --- capacity + conductivity: one fused retention chain -------------
    psi_c = torch.abs(torch.clamp_max(psi, 0.0))
    psi_p = torch.abs(torch.clamp_max(psi_old, 0.0))
    n = soil32.vg_n
    m = soil32.vg_m
    x = soil32.vg_alpha * torch.clamp_min(psi_c, 1e-20)
    xn = power(x, n)
    one = 1.0 + xn
    base = power(one, -m)

    se_c = torch.clamp(se, 1e-12, 1.0)
    frac = xn / one
    num = 1.0 - power(frac, m)
    if params.wrc_model.name == "VAN_GENUCHTEN":
        saturated = (psi_c == 0.0) & (psi_p == 0.0)
        temp = num
    else:
        saturated = (psi_c <= soil32.vg_he) & (psi_p <= soil32.vg_he)
        temp = num / soil32.mualem_den
    k = soil32.k_sat * power(se_c, soil32.mualem_l) * temp * temp
    k = torch.where(se >= 1.0, soil32.k_sat, k)
    k = _set0(torch.where(mask, k, 0.0), 0.0)

    term = (base / one) * (xn / x)
    dse_a = soil32.vg_alpha * n * m * term / soil32.vg_sc
    se_c = se
    se_p = se_from_psi(soil32, psi_p, params.wrc_model)
    dh32 = psi - psi_old
    dse_s = torch.abs((se_c - se_p) / torch.where(dh32 != 0, dh32, 1.0))
    resolvable = torch.abs(psi_c - psi_p) > 1e-4
    dse = torch.where(resolvable, dse_s, dse_a)
    dse = torch.where(saturated, 0.0, dse)
    capacity = vol32 * dse * (soil32.theta_s - soil32.theta_r)
    capacity = _set0(capacity, vol32[0])
    capacity = torch.where(mask, capacity, 1.0)

    # --- boundary flows (update_boundary_water in offset space) ---------
    flow = torch.where(mask, sink_source.to(sd), 0.0)
    h_s0 = torch.clamp_min(avg_psi[0], 0.0)
    max_surf_flux = -h_s0 * vol32[0] / dt32
    flow0 = torch.where(flow[0] < 0, torch.maximum(flow[0], max_surf_flux),
                        flow[0])
    flow = _set0(flow, torch.where(mask[0], flow0, 0.0))

    bt = grid.btype
    pond32 = pond.to(sd)
    bslope32 = g32.bslope
    bsize32 = g32.bsize
    rough32 = g32.roughness

    # Runoff (surface rim): Manning outflow
    hs0 = torch.clamp_min(avg_psi[0] - pond32, 0.0)
    rough_s = torch.clamp_min(rough32, 1e-12)
    v = power(hs0, 2.0 / 3.0) * torch.sqrt(torch.clamp_min(bslope32[0], 0.0)) / rough_s
    max_flow = hs0 * vol32[0] / dt32
    val_flow = hs0 * v * bsize32[0]
    runoff_rate0 = torch.where(hs0 < EPSILON_RUNOFF, 0.0,
                               -torch.minimum(val_flow, max_flow))
    runoff_rate = _set0(torch.zeros_like(psi), runoff_rate0)

    # FreeDrainage (bottom): Darcy unit gradient
    fd_rate = -k * area32
    # FreeLateralDrainage (rim soil)
    fld_rate = -k * bsize32 * bslope32 * lvr

    rate = torch.zeros_like(psi)
    rate = torch.where(bt == BoundaryType.RUNOFF, runoff_rate, rate)
    rate = torch.where(bt == BoundaryType.FREE_DRAINAGE, fd_rate, rate)
    rate = torch.where(bt == BoundaryType.FREE_LATERAL_DRAINAGE, fld_rate, rate)

    if grid.has_prescribed:
        # PrescribedTotalWaterPotential: fixed head 1 m below
        Lb = 1.0
        prescribed_psi = (grid.prescribed_h - grid.z).to(sd)
        boundary_psi = prescribed_psi + Lb
        k_bound = torch.where(
            boundary_psi >= 0, soil32.k_sat,
            mualem_conductivity(
                soil32,
                se_from_psi(soil32, torch.abs(boundary_psi), params.wrc_model),
                params.wrc_model))
        mean_kb = compute_mean(k_bound, torch.clamp_min(k, 1e-30),
                               params.mean_type)
        presc_rate = mean_kb * bsize32 * (prescribed_psi - psi) / scalar(
            Lb, sd, dev)
        rate = torch.where(bt == BoundaryType.PRESCRIBED_TOTAL_POTENTIAL,
                           presc_rate, rate)

    if grid.has_culvert:
        # Culvert (surface outlet)
        cw = g32.culvert_w
        ch = torch.clamp_min(g32.culvert_h, 1e-12)
        crough = torch.clamp_min(g32.culvert_rough, 1e-12)
        cslope = torch.clamp_min(bslope32[0], 0.0)
        if params.culvert_reference_compat:
            # the reference's verbatim 0.5*(H - Hold) - z (water.cpp:760)
            wl = 0.5 * (psi[0] - psi_old[0]) - g32.z[0]
        else:
            wl = avg_psi[0]
        eq_diam = torch.sqrt(4.0 * cw * ch / scalar(PI, sd, dev))
        pressure_flow = (70.0 * power(cslope, 0.54) * power(eq_diam, 2.63)
                         / scalar(3.591, sd, dev))
        hr_full = bsize32[0] / torch.clamp_min(cw + 2.0 * ch, 1e-12)
        manning_full = ((bsize32[0] / crough) * torch.sqrt(cslope)
                        * power(hr_full, 2.0 / 3.0))
        mix_w = torch.clamp((wl - ch) / (0.5 * ch), 0.0, 1.0)
        mixed_flow = mix_w * pressure_flow + (1.0 - mix_w) * manning_full
        oc_area = cw * torch.clamp_min(wl, 0.0)
        hr_open = oc_area / torch.clamp_min(
            cw + 2.0 * torch.clamp_min(wl, 0.0), 1e-12)
        open_flow = ((oc_area / crough) * torch.sqrt(cslope)
                     * power(hr_open, 2.0 / 3.0))
        culvert_flow = torch.where(
            wl >= 1.5 * ch, pressure_flow,
            torch.where(wl >= ch, mixed_flow,
                        torch.where(wl > pond32, open_flow, 0.0)))
        culvert_rate = _set0(torch.zeros_like(psi), -culvert_flow)
        rate = torch.where(bt == BoundaryType.CULVERT, culvert_rate, rate)
    rate = torch.where(torch.abs(rate) < DBL_EPSILON, 0.0, rate)
    rate = torch.where(mask, rate, 0.0)
    if boundary_flux_fn is not None:
        # per-iteration boundary flow (HeatSurface evaporative water sink,
        # water.cpp:708-747): enters RHS and balance like any boundary rate
        rate = rate + boundary_flux_fn(psi, dt).to(sd)
    water_flow = flow + rate

    # --- vertical conductances (offset-space infiltration) --------------
    L = grid.n_layers
    vd32 = torch.where(grid.vert_dist > 0, grid.vert_dist, 1.0).to(sd)
    k_above = torch.roll(k, 1, dims=0)
    mean_k = compute_mean(torch.clamp_min(k, 1e-30),
                          torch.clamp_min(k_above, 1e-30), params.mean_type)
    a_redist = mean_k * area32 / vd32

    dist01 = g32.vert_dist[1, 0, 0]
    bt1 = bt[1]
    bf = torch.where(bt1 == BoundaryType.ROAD, 0.0,
                     torch.ones(bt1.shape, dtype=sd, device=dev))
    bf = torch.where(bt1 == BoundaryType.URBAN, 0.33, bf)
    ksat1 = soil32.k_sat[1]
    sat_val = ksat1 * bf * area32 / dist01

    surface_water = torch.clamp_min(avg_psi[0], 0.0)
    sbf = water_flow[0]
    surface_water = torch.where(
        sbf < 0,
        torch.clamp_min(surface_water + sbf * dt32 / vol32[0], 0.0),
        surface_water)
    max_inf_rate = surface_water / dt32
    # surf_h - soil_h = avg_psi0 - avg_psi1 + (z0 - z1)
    dh01 = torch.clamp_min(avg_psi[0] - avg_psi[1] + dist01, 1e-12)
    max_k = max_inf_rate * dist01 / dh01
    mean_k01 = compute_mean(ksat1, torch.clamp_min(k[1], 1e-30),
                            params.mean_type)
    unsat_val = torch.where(
        max_inf_rate < MIN_INFILTRATION_RATE, 0.0,
        torch.minimum(bf * mean_k01, max_k) * area32 / dist01)
    # h[1] > z[0]  <=>  psi[1] > z[0] - z[1]
    infil = torch.where(psi[1] > dist01, sat_val, unsat_val)

    layer_idx = torch.arange(L, device=dev).reshape(L, 1, 1)
    a_up = torch.where(layer_idx >= 2, a_redist, 0.0)
    if L > 1:
        a_up[1] = infil
    link_ok = _set0(mask & torch.roll(mask, 1, dims=0), False)
    a_up = torch.where(link_ok, a_up, 0.0)

    # --- lateral conductances + Courant (offset space) ------------------
    first = _is_first(approx, dev)
    hi = avg_psi[0] + torch.where(
        (water_flow[0] > 0) & first,
        0.5 * water_flow[0] * dt32 / vol32[0], 0.0)
    k_soil = torch.clamp_min(k * lvr, 1e-30)
    lat_area32 = g32.lat_area
    dz_lat32 = g32.dz_lat

    a_lat_list = []
    cour_max = []
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        nbr_ok = shift2d(mask, di, dj, fill=False)
        dz = dz_lat32[idx]                        # (R,C): z(nbr) - z

        k_nbr = torch.clamp_min(shift2d(k_soil, di, dj), 1e-30)
        mean_kl = compute_mean(k_soil, k_nbr, params.mean_type)
        a_soil = mean_kl * lat_area32 / g32.lat_dist3d[idx]

        hj = shift2d(hi, di, dj)
        pond_j = shift2d(pond32, di, dj)
        hs = (torch.maximum(hi, hj + dz)
              - torch.maximum(pond32, pond_j + dz))
        dxy = g32.lat_dist2d[idx, 0, 0]
        rough_ij = 0.5 * (rough32 + shift2d(rough32, di, dj))
        hs23 = power(torch.clamp_min(hs, 0.0), 2.0 / 3.0)
        a_surface = (lat_area32[0, 0, 0] * hs) * hs23 / (rough_ij * dxy)
        invalid = (hs <= EPSILON_METER) | (rough_ij <= 0.0)
        a_surface = torch.where(invalid, 0.0, a_surface)

        dh_ij = torch.abs(hi - hj - dz)
        if params.courant_reference_compat:
            # the reference's integer abs (water.cpp:477)
            dh_ij = torch.trunc(dh_ij)
        slope = torch.where(dh_ij > EPSILON_METER, dh_ij / dxy, 0.0)
        vv = hs23 * torch.sqrt(slope) / rough_ij
        cour = torch.where(invalid | ~nbr_ok[0] | ~mask[0], 0.0,
                           vv * dt32 / dxy)
        cour_max.append(cour.amax())

        a = _set0(a_soil, a_surface)
        a_lat_list.append(torch.where(mask & nbr_ok, a, 0.0))
    a_lat = torch.stack(a_lat_list)
    courant = torch.clamp_min(torch.stack(cour_max).amax(), 0.0)

    # --- psi-form system + Jacobi preconditioning -----------------------
    a_down = torch.roll(a_up, -1, dims=0)
    a_down[-1] = 0.0
    sum_a = a_up + a_down + _sum_lateral(a_lat)
    diag = capacity / dt32 + sum_a
    diag = torch.where(mask, diag, 1.0)

    # RHS-only extra flux (the invariantFluxes mechanism,
    # cpusolver.cpp:388): the thermal water flows enter b but not the
    # balance sums (water.cpp:130-141)
    rhs_flow = water_flow
    if extra_flux_fn is not None:
        rhs_flow = water_flow + extra_flux_fn(psi, k).to(sd)

    vd_down = torch.roll(vd32, -1, dims=0)
    b = (capacity / dt32) * psi_old + rhs_flow
    b = b + a_up * vd32 - a_down * vd_down
    for idx in range(8):
        b = b + a_lat[idx] * dz_lat32[idx]
    b = torch.where(mask, b, 0.0)

    inv_diag = 1.0 / diag
    system = LinearSystem(
        b=b * inv_diag,
        c_up=a_up * inv_diag,
        c_down=a_down * inv_diag,
        c_lat=a_lat * inv_diag[None],
        diag=diag,
        courant=courant.to(params.dtype),
    )
    return system, water_flow, rate, k


def compute_se_psi(grid: Grid, params: SolverParameters,
                   psi: torch.Tensor) -> torch.Tensor:
    """Degree of saturation from SIGNED PSI in the sweep dtype (the
    psi-carry form of :func:`compute_se`)."""
    soil = grid.astype(psi.dtype).soil
    se = torch.where(psi >= 0, 1.0,
                     se_from_psi(soil, torch.abs(psi), params.wrc_model))
    se = _set0(se, 1.0)
    return torch.where(grid.mask, se, 0.0)


def mass_balance_sums_psi(grid: Grid, params: SolverParameters,
                          psi: torch.Tensor, se: torch.Tensor,
                          water_flow: torch.Tensor, ring: int = 0):
    """``(surface, soil, flow)`` of the balance from the f32 psi-carry
    state, as 0-d float64 sums over the cells a block with ``ring`` owns:
    the water volumes [m3] and the net flow [m3 s-1]."""
    g = grid.astype(psi.dtype)
    surf = torch.where(grid.mask[0],
                       torch.clamp_min(psi[0], 0.0) * g.volume[0], 0.0)
    theta = theta_from_se(g.soil, se)
    soil = _set0(torch.where(grid.mask, theta * g.volume, 0.0), 0.0)
    return (owned(surf, ring).sum(dtype=torch.float64),
            owned(soil, ring).sum(dtype=torch.float64),
            owned(torch.where(grid.mask, water_flow, 0.0), ring).sum(
                dtype=torch.float64))


def mass_balance_sums(grid: Grid, params: SolverParameters,
                      h: torch.Tensor, se: torch.Tensor,
                      water_flow: torch.Tensor, ring: int = 0):
    """:func:`mass_balance_sums_psi` from the float64 total-head state."""
    return (*water_content_sums(grid, params, h, se, ring),
            owned(torch.where(grid.mask, water_flow, 0.0), ring).sum(
                dtype=torch.float64))


def balance_from_sums(params: SolverParameters, surf, soil, flow,
                      prev_storage, dt):
    """(storage, sink, MBE, MBR) as 0-d tensors of the state dtype from the
    whole domain's sums (computeCurrentMassBalance, water.cpp:96-123).
    ``dt`` [s] is a Python number or a 0-d tensor of the state dtype."""
    storage = (surf + soil).to(params.dtype)
    delta_storage = storage - prev_storage
    sink = (flow * dt).to(params.dtype)
    mbe = delta_storage - sink

    if isinstance(dt, torch.Tensor):
        time_pct = 0.001 * torch.clamp_min(dt, 30.0) / scalar(
            3600.0, dt.dtype, dt.device)
    else:
        time_pct = 0.001 * max(dt, 30.0) / 3600.0
    min_ref = torch.clamp_min(storage * time_pct, 0.001)
    ref_water = torch.maximum(torch.abs(sink), min_ref)
    mbr = mbe / ref_water
    return storage, sink, mbe, mbr


def current_mass_balance_psi(grid: Grid, params: SolverParameters,
                             psi: torch.Tensor, se: torch.Tensor,
                             water_flow: torch.Tensor,
                             prev_storage, dt):
    """(storage, sink, MBE, MBR) as 0-d float64 tensors from the f32
    psi-carry state (computeCurrentMassBalance, water.cpp:96-123); sums
    accumulate in float64. ``dt`` [s] is a number or a 0-d tensor."""
    return balance_from_sums(
        params, *mass_balance_sums_psi(grid, params, psi, se, water_flow),
        prev_storage, dt)


def jacobi_sweep_psi_sum(system: LinearSystem, psi: torch.Tensor, grid: Grid,
                         ring: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi iteration in psi-form; returns (psi_new, psi-weighted
    |dx| sum over the cells a block with ``ring`` owns) with the surface
    clamp psi >= 0 (JacobiWaterCPU, water.cpp:565-601), on every cell."""
    acc = system.b
    acc = acc + system.c_up * torch.roll(psi, 1, dims=0)
    acc = acc + system.c_down * torch.roll(psi, -1, dims=0)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        acc = acc + system.c_lat[idx] * shift2d(psi, di, dj)

    psi_new = _set0(acc, torch.clamp_min(acc[0], 0.0))
    psi_new = torch.where(grid.mask, psi_new, 0.0)

    dx = torch.abs(psi_new - psi)
    apsi = torch.abs(psi_new)
    weight = torch.where(apsi > 1.0, 1.0 / apsi, 1.0)
    return psi_new, owned(torch.where(grid.mask, dx * weight, 0.0), ring).sum()


def jacobi_sweep_psi(system: LinearSystem, psi: torch.Tensor, grid: Grid,
                     n_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi iteration in psi-form; returns (psi_new, psi-weighted mean
    |dx| norm) with the surface clamp psi >= 0 (JacobiWaterCPU,
    water.cpp:565-601)."""
    psi_new, total = jacobi_sweep_psi_sum(system, psi, grid)
    return psi_new, total / scalar(float(n_nodes), total.dtype, total.device)


def jacobi_sweep_sum(system: LinearSystem, x: torch.Tensor, grid: Grid,
                     ring: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi iteration on total heads; returns (x_new, psi-weighted
    |dx| sum over the cells a block with ``ring`` owns) with the surface
    clamp x >= z, on every cell, and the 1/psi weight for |psi| > 1
    (JacobiWaterCPU, water.cpp:565-601). The rolls' wrapped rows meet zero
    coefficients."""
    acc = system.b
    acc = acc + system.c_up * torch.roll(x, 1, dims=0)
    acc = acc + system.c_down * torch.roll(x, -1, dims=0)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        acc = acc + system.c_lat[idx] * shift2d(x, di, dj)

    x_new = _set0(acc, torch.maximum(acc[0], grid.z[0]))
    x_new = torch.where(grid.mask, x_new, 0.0)

    dx = torch.abs(x_new - x)
    psi = torch.abs(x_new - grid.z)
    weight = torch.where(psi > 1.0, 1.0 / psi, 1.0)
    return x_new, owned(torch.where(grid.mask, dx * weight, 0.0), ring).sum()


def jacobi_sweep(system: LinearSystem, x: torch.Tensor, grid: Grid,
                 n_nodes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobi iteration on total heads; returns (x_new, psi-weighted
    mean |dx| norm) (:func:`jacobi_sweep_sum` over the whole box)."""
    x_new, total = jacobi_sweep_sum(system, x, grid)
    return x_new, total / scalar(float(n_nodes), total.dtype, total.device)


def stencil_apply(system: LinearSystem, x: torch.Tensor) -> torch.Tensor:
    """The preconditioned off-diagonal stencil ``(C x)_i = sum_j c_ij x_j``
    (c_ij = a_ij / diag_i); the CG matvec is ``D^-1 A x = x - C x``
    (cpusolver.cpp:608-669)."""
    acc = system.c_up * torch.roll(x, 1, dims=0)
    acc = acc + system.c_down * torch.roll(x, -1, dims=0)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        acc = acc + system.c_lat[idx] * shift2d(x, di, dj)
    return acc


def tridiag_vertical_solve(c_up: torch.Tensor, c_down: torch.Tensor,
                           rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``T z = rhs`` for the vertical tridiagonal part of the
    Jacobi-scaled operator: unit diagonal, sub-diagonal ``-c_up[l]``,
    super-diagonal ``-c_down[l]`` -- the CG line preconditioner.

    Thomas elimination unrolled over the layer axis, as the JAX package
    unrolls it: one set of whole-(R, C)-plane operations per layer, batched
    over every column. T is strictly diagonally dominant, so no pivoting;
    masked-out cells have zero couplings and reduce to z = rhs (the caller
    masks afterwards)."""
    L = rhs.shape[0]
    w = [None] * L
    g = [None] * L
    w_prev = torch.zeros_like(rhs[0])
    g_prev = torch.zeros_like(rhs[0])
    for l in range(L):
        denom = 1.0 + c_up[l] * w_prev
        w[l] = -c_down[l] / denom
        g[l] = (rhs[l] + c_up[l] * g_prev) / denom
        w_prev, g_prev = w[l], g[l]

    z = [None] * L
    z[L - 1] = g[L - 1]
    for l in range(L - 2, -1, -1):
        z[l] = g[l] - w[l] * z[l + 1]
    return torch.stack(z)


def current_mass_balance(grid: Grid, params: SolverParameters,
                         h: torch.Tensor, se: torch.Tensor,
                         water_flow: torch.Tensor, prev_storage, dt):
    """(storage, sink, MBE, MBR) as 0-d tensors of the state dtype
    (computeCurrentMassBalance, water.cpp:96-123); sums accumulate in
    float64. ``dt`` [s] is a number or a 0-d tensor."""
    return balance_from_sums(
        params, *mass_balance_sums(grid, params, h, se, water_flow),
        prev_storage, dt)
