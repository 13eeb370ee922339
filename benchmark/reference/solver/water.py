"""Water-process physics on the path the cells run: the float32 psi-carry
assembly and balance, and the conjugate-gradient operators.

The port's eager water code (agrolib/soilFluxes3D/water.cpp as dense (L,
R, C) stencil passes): ``assemble_fast`` and its psi-form helpers, the
balance sums, and the CG operators (``stencil_apply``,
``tridiag_vertical_solve``). Two dtype rules are spelt out here because
torch promotes differently from JAX: a 0-d float64 array times a float32
array is float64 in JAX but float32 in torch, so such products cast
explicitly; and balance sums accumulate float32 values in float64
(``sum(dtype=float64)``, :mod:`benchmark.reference.precision`).

Scalars that divide tensors (``dt``, ``pi``, node counts) are 0-d tensors
on the tensors' device: CUDA turns division by a host scalar into
multiplication by its rounded reciprocal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.constants import (DBL_EPSILON, EPSILON_METER,
                                            EPSILON_RUNOFF, PI,
                                            MIN_INFILTRATION_RATE)
from benchmark.reference.core.grid import BoundaryType, Grid
from benchmark.reference.core.soil import (compute_mean,
                                            mualem_conductivity, power,
                                            se_from_psi, theta_from_se)
from benchmark.reference.core.state import SolverParameters
from benchmark.reference import precision
from benchmark.reference.device import scalar
from benchmark.reference.solver.shifts import LATERAL_OFFSETS, shift2d

__all__ = [
    "LinearSystem", "compute_se", "water_content_sums", "assemble_fast",
    "compute_se_psi", "mass_balance_sums_psi", "balance_from_sums",
    "stencil_apply", "tridiag_vertical_solve",
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
                       h: torch.Tensor, se: torch.Tensor):
    """``(surface, soil)`` water volumes [m3], as 0-d float64 sums: surface
    water depth x area, soil theta x volume."""
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
    return (surf.sum(dtype=precision.accumulator()),
            soil.sum(dtype=precision.accumulator()))


def _sum_lateral(a_lat: torch.Tensor) -> torch.Tensor:
    """Sum over the 8 lateral links in index order, as XLA's reduction
    does."""
    total = a_lat[0]
    for idx in range(1, 8):
        total = total + a_lat[idx]
    return total


def assemble_fast(grid: Grid, params: SolverParameters,
                  psi: torch.Tensor, psi_old: torch.Tensor,
                  se: torch.Tensor, sink_source: torch.Tensor,
                  pond: torch.Tensor, approx, dt,
                  extra_flux_fn=None, boundary_flux_fn=None):
    """Capacity + boundary flows + stencil assembly in ONE float32 pass,
    with the RHS in psi-form (criteria3d_tpu.solver.water.assemble_fast):

        b'_i = (C_i/dt) psi_old_i + Q_i + sum_j a_ij (z_j - z_i)

    ``psi``/``psi_old``/``se`` are float32 signed-psi / saturation fields;
    returns ``(system, water_flow, boundary_rate, k)`` in float32 with a
    float64 ``system.courant``. ``approx`` is the Picard iteration index and
    ``dt`` the step [s] (a number or a 0-d tensor).

    The heat-coupling hooks receive SIGNED psi: ``boundary_flux_fn(psi,
    dt)`` is a boundary flow (the HeatSurface evaporative sink) added to
    the boundary rate, so it enters the RHS and the balance;
    ``extra_flux_fn(psi, k)`` (the thermal water flows) enters the RHS
    only. Both are cast to the sweep dtype.
    """
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
    first = int(approx) == 0
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
    del a_lat_list
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
                          water_flow: torch.Tensor):
    """``(surface, soil, flow)`` of the balance from the f32 psi-carry
    state, as 0-d float64 sums: the water volumes [m3] and the net flow
    [m3 s-1]."""
    g = grid.astype(psi.dtype)
    surf = torch.where(grid.mask[0],
                       torch.clamp_min(psi[0], 0.0) * g.volume[0], 0.0)
    theta = theta_from_se(g.soil, se)
    soil = _set0(torch.where(grid.mask, theta * g.volume, 0.0), 0.0)
    return (surf.sum(dtype=precision.accumulator()),
            soil.sum(dtype=precision.accumulator()),
            torch.where(grid.mask, water_flow, 0.0).sum(dtype=precision.accumulator()))


def balance_from_sums(params: SolverParameters, surf, soil, flow,
                      prev_storage, dt):
    """(storage, sink, MBE, MBR) as 0-d tensors of the state dtype from the
    whole domain's sums (computeCurrentMassBalance, water.cpp:96-123).
    ``dt`` is a Python number [s]."""
    storage = (surf + soil).to(params.dtype)
    delta_storage = storage - prev_storage
    sink = (flow * dt).to(params.dtype)
    mbe = delta_storage - sink

    time_pct = 0.001 * max(dt, 30.0) / 3600.0
    min_ref = torch.clamp_min(storage * time_pct, 0.001)
    ref_water = torch.maximum(torch.abs(sink), min_ref)
    mbr = mbe / ref_water
    return storage, sink, mbe, mbr


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


