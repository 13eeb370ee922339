"""Station-to-grid meteorological interpolation: detrended IDW.

PyTorch counterpart of ``criteria3d_tpu/physics/interpolation.py``: proxy
detrending by simple linear regression (regressionSimple/regressionGeneric,
interpolation.cpp:304-365), inverse-distance weighting with the reference's
cube-of-(distance/10km) kernel (inverseDistanceWeighted,
interpolation.cpp:1031-1051), retrending at the target cells and
variable-specific post-processing (interpolate, interpolation.cpp:2502-2560).

Where the work lives:

- station-sized arithmetic (the regressions, the detrended residuals, the
  leave-one-out spatial QC) runs on the device of the station arrays it is
  given: the CPU for numpy arrays, as a project passes them, so the host
  never waits for the card to decide which stations count;
- the maps (:func:`idw_map`, the retrend, :func:`shepard_idw_map`) are
  float64 tensors on the device of the grid's coordinate maps.

The JAX ``lax.scan`` over stations of :func:`idw_map` is a Python loop that
adds one station's whole (R, C) weighted map at a time, in station order,
so the sums accumulate in the JAX order. ``regression_orography_t`` is host
numpy, copied line for line. Every float expression keeps the JAX form
(``ops.py``): true divisions by constants, integer powers as products.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import EPSILON, NODATA
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where

__all__ = ["VariableKind", "idw_map", "detrended_idw", "simple_regression",
           "quality_range_check", "shepard_idw_map", "OrographyLapse",
           "regression_orography_t", "orography_trend",
           "spatial_quality_control", "ProxyResult"]


class VariableKind(enum.IntEnum):
    """Post-processing class of the interpolated variable
    (interpolate, interpolation.cpp:2540-2560)."""

    GENERIC = 0
    TEMPERATURE = 1
    PRECIPITATION = 2
    RELATIVE_HUMIDITY = 3
    NON_NEGATIVE = 4     # radiation, wind, leaf wetness, transmissivity


_DETRENDABLE = (VariableKind.TEMPERATURE, VariableKind.GENERIC,
                VariableKind.RELATIVE_HUMIDITY)


def _station(a, device=None) -> torch.Tensor:
    """Station values as a float64 tensor: a tensor stays where it is, an
    array or list goes to ``device`` (the CPU when None)."""
    return as_f64(a, device)


def _station_bool(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(a, dtype=bool), device=device)


def simple_regression(values, proxy, active=None):
    """(slope, intercept, r2) of values ~ proxy over active stations, as
    0-d float64 tensors on the device of ``values``.

    Mirrors regressionSimple (interpolation.cpp:304-344) + statistics.cpp
    linearRegression. Inactive/NODATA stations are excluded by masking.
    """
    values = _station(values)
    proxy = _station(proxy, values.device)
    ok = (values != NODATA) & (proxy != NODATA)
    if active is not None:
        ok = ok & _station_bool(active, values.device)
    n = torch.clamp_min(torch.sum(ok), 1).to(torch.float64)
    w = ok.to(values.dtype)
    mx = torch.sum(w * proxy) / n
    my = torch.sum(w * values) / n
    sxx = torch.sum(w * sq(proxy - mx))
    sxy = torch.sum(w * (proxy - mx) * (values - my))
    syy = torch.sum(w * sq(values - my))
    slope = where(sxx > 0, sxy / torch.clamp_min(sxx, 1e-12), 0.0)
    intercept = my - slope * mx
    r2 = where((sxx > 0) & (syy > 0),
               (sxy * sxy) / torch.clamp_min(sxx * syy, 1e-12), 0.0)
    return slope, intercept, r2


# ----------------------------------------------------------------------
# thermal-inversion orography lapse (regressionOrographyT)
# ----------------------------------------------------------------------

MIN_REGRESSION_POINTS = 5    # interpolationConstants.h:4
_DELTAZ_INI = 80.0           # interpolation.cpp:450


@dataclasses.dataclass(frozen=True)
class OrographyLapse:
    """Fitted piecewise elevation lapse (Crit3DProxy orography state,
    interpolationSettings.h:40-50): below the inversion top ``h1`` the
    value increases with height at ``inversion_lapse``; above it decreases
    at ``slope``. ``valid=False`` means no usable fit (no detrending)."""

    valid: bool = False
    inversion_significant: bool = False
    h0: float = 0.0
    h1: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    inversion_lapse: float = 0.0
    slope: float = 0.0
    r2: float = 0.0


def _linreg(x, y):
    """(intercept q, slope m, r2) — statistics::linearRegression."""
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    if len(x) < 2 or np.ptp(x) == 0.0:
        return 0.0, 0.0, 0.0
    mx, my = x.mean(), y.mean()
    sxx = ((x - mx) ** 2).sum()
    sxy = ((x - mx) * (y - my)).sum()
    syy = ((y - my) ** 2).sum()
    m = sxy / sxx
    q = my - m * mx
    r2 = (sxy * sxy) / (sxx * syy) if syy > 0 else 0.0
    return float(q), float(m), float(r2)


def _intersect(q1, m1, q2, m2):
    """findLinesIntersection (basicMath.cpp:138-152)."""
    if abs(m1 - m2) < 1e-12:
        return None
    x = (q2 - q1) / (m1 - m2)
    return x, m1 * x + q1


def regression_orography_t(heights, values, *, climate_lapse_rate=0.0,
                           max_height_inversion=1000.0,
                           min_regression_r2=0.1) -> OrographyLapse:
    """Thermal-inversion elevation lapse fit for temperature-like
    variables (regressionOrographyT, interpolation.cpp:433-797).

    Height-interval averages (80 m bands growing exponentially toward the
    1000 m max inversion height) locate the inversion top; separate
    regressions below/above it — on raw stations and on the interval
    averages as fallbacks — produce the piecewise lapse, with the monthly
    climate lapse rate as last resort. Host-side numpy: a handful of
    stations, heavy data-dependent branching, run once per hour exactly
    like the reference's serial fit.
    """
    z = np.asarray(heights, float)
    v = np.asarray(values, float)
    ok = ~np.isclose(v, NODATA) & ~np.isclose(z, NODATA)
    z, v = z[ok], v[ok]

    sig_r2 = max(min_regression_r2, 0.2)
    sig_r2_inv = max(min_regression_r2, 0.1)
    max_inv = max_height_inversion

    def generic():
        """regressionGeneric (interpolation.cpp:346-365)."""
        q, m, r2 = _linreg(z, v)
        return OrographyLapse(valid=r2 >= min_regression_r2,
                              inversion_significant=False, t0=q, slope=m,
                              r2=r2)

    if len(z) < MIN_REGRESSION_POINTS or z.max() == z.min():
        # not enough data to define a curve: climate lapse
        # (interpolation.cpp:471-473)
        return OrographyLapse(valid=True, slope=climate_lapse_rate)

    # --- height-interval averages (interpolation.cpp:475-492) ---
    max_z, h_inf = z.max(), z.min()
    int_h, int_v = [], []
    h_sup, dz = h_inf, _DELTAZ_INI
    guard = 0
    while h_sup <= max_z and guard < 1000:
        guard += 1
        avg = None
        while avg is None and guard < 1000:
            h_sup += dz
            sel = (z >= h_inf) & (z <= h_sup)
            n = int(sel.sum())
            if n > 1 or (n > 0 and h_sup >= max_z):
                avg = float(v[sel].mean())
            guard += 1
        if avg is None:
            break
        int_h.append(0.5 * (h_sup + h_inf))
        int_v.append(avg)
        dz = _DELTAZ_INI * float(np.exp(h_inf / max_inv))
        h_inf = h_sup
    if not int_h:
        return generic()

    # --- find inversion height (interpolation.cpp:494-503) ---
    h0 = 0.0
    h1, t1 = int_h[0], int_v[0]
    inv_sig = False
    for i in range(1, len(int_v)):
        if int_h[i] <= max_inv and int_v[i] >= t1 \
                and int_v[i] > int_v[0] + 0.001 * (int_h[i] - int_h[0]):
            h1, t1 = int_h[i], int_v[i]
            inv_sig = True

    if not inv_sig:
        return generic()

    below = z <= h1
    z1, v1 = z[below], v[below]
    z2, v2 = z[~below], v[~below]
    ih = np.asarray(int_h)
    iv = np.asarray(int_v)
    ibelow = ih <= h1
    ih1, iv1 = ih[ibelow], iv[ibelow]
    ih2, iv2 = ih[~ibelow], iv[~ibelow]

    # --- only positive lapse rate (interpolation.cpp:539-570) ---
    if len(iv1) == len(iv):
        q, m, r2 = _linreg(z, v)
        if r2 >= sig_r2:
            return OrographyLapse(valid=True, inversion_significant=True,
                                  h0=h0, h1=h1, t0=q, t1=q + m * h1,
                                  inversion_lapse=m,
                                  slope=climate_lapse_rate, r2=r2)
        q, m, r2 = _linreg(ih1, iv1)
        if r2 >= sig_r2:
            return OrographyLapse(valid=True, inversion_significant=True,
                                  h0=h0, h1=h1, t0=q, t1=q + m * h1,
                                  inversion_lapse=m,
                                  slope=climate_lapse_rate)
        return OrographyLapse(valid=True, inversion_significant=True,
                              h0=h0, h1=h1, t0=int_v[0], t1=t1,
                              inversion_lapse=0.0,
                              slope=climate_lapse_rate)

    # --- check inversion significance (interpolation.cpp:575-658) ---
    q1, m1, r2_values = _linreg(z1, v1)
    if len(iv1) > 2:
        _, _, r2_intervals = _linreg(ih1, iv1)
    else:
        r2_intervals = 0.0

    if r2_values < sig_r2_inv and r2_intervals < sig_r2_inv:
        # inversion not significant with data nor with intervals
        q, m, r2 = _linreg(z, v)
        if r2 >= 0.5:
            return OrographyLapse(valid=True, t0=q, slope=min(m, 0.0),
                                  r2=r2)
        # case 1: analysis only above inversion, flat lapse below
        if len(v2) >= MIN_REGRESSION_POINTS:
            q2, m2, r2a = _linreg(z2, v2)
            if r2a >= sig_r2:
                slope = min(m2, 0.0)
                t0 = q2 + h1 * slope
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=h1, t0=t0, t1=t0,
                                      inversion_lapse=0.0, slope=slope,
                                      r2=r2a)
            q2, m2, r2a = _linreg(ih2, iv2)
            if r2a >= sig_r2:
                slope = min(m2, 0.0)
                t0 = q2 + h1 * slope
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=h1, t0=t0, t1=t0,
                                      inversion_lapse=0.0, slope=slope,
                                      r2=r2a)
        # case 2: regression with all data
        if r2 >= sig_r2:
            return OrographyLapse(valid=True, t0=q, slope=min(m, 0.0),
                                  r2=r2)
        return OrographyLapse(valid=True, t0=int_v[0],
                              slope=0.0 if m > 0 else climate_lapse_rate)

    # --- significance analysis (interpolation.cpp:660-788) ---
    q1, m1, r21 = _linreg(z1, v1)
    q2, m2, r22 = _linreg(z2, v2)
    if m1 <= 0:
        r21 = 0.0

    def clamp_inv(h1_, t1_, t0_, lapse_, slope_):
        """max-inversion-height clamp (interpolation.cpp:682-687)."""
        if h1_ > max_inv:
            t1_ = t1_ - (h1_ - max_inv) * slope_
            h1_ = max_inv
            lapse_ = (t1_ - t0_) / (h1_ - h0)
        return h1_, t1_, lapse_

    if r21 >= sig_r2_inv and r22 >= sig_r2:
        if len(z2) < MIN_REGRESSION_POINTS and m2 > 0.0:
            m2, q2 = 0.0, t1
        cross = _intersect(q1, m1, q2, m2)
        if cross is not None:
            x, y = cross
            h1_, t1_, lapse_ = clamp_inv(x, y, q1, m1, m2)
            return OrographyLapse(valid=True, inversion_significant=True,
                                  h0=h0, h1=h1_, t0=q1, t1=t1_,
                                  inversion_lapse=lapse_, slope=m2, r2=r22)
    elif r21 < sig_r2_inv and r22 >= sig_r2:
        if len(z2) < MIN_REGRESSION_POINTS and m2 > 0.0:
            m2, q2 = 0.0, t1
        q, m, r2i = _linreg(ih1, iv1)
        if r2i >= sig_r2_inv:
            cross = _intersect(q, m, q2, m2)
            if cross is not None and cross[0] > 40.0:
                x, y = cross
                h1_, t1_, lapse_ = clamp_inv(x, y, q, m, m2)
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=h1_, t0=q, t1=t1_,
                                      inversion_lapse=lapse_, slope=m2,
                                      r2=r22)
        else:
            t1_ = q2 + m2 * h1
            return OrographyLapse(valid=True, inversion_significant=True,
                                  h0=h0, h1=h1, t0=t1_, t1=t1_,
                                  inversion_lapse=0.0, slope=m2, r2=r22)
    elif r21 >= sig_r2_inv and r22 < sig_r2:
        q, m, r2i = _linreg(ih2, iv2)
        if r2i >= sig_r2:
            slope = min(m, 0.0)
            cross = _intersect(q1, m1, q, slope)
            if cross is not None:
                x, y = cross
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=x, t0=q1, t1=y,
                                      inversion_lapse=m1, slope=slope,
                                      r2=r22)
        else:
            slope = climate_lapse_rate
            cross = _intersect(q1, m1, t1 - slope * h1, slope)
            if cross is not None:
                x, y = cross
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=x, t0=q1, t1=y,
                                      inversion_lapse=m1, slope=slope,
                                      r2=r22)
    else:
        q, m, r2i = _linreg(ih1, iv1)
        if r2i >= sig_r2_inv:
            t0_, lapse_, t1_ = q, m, q + m * h1
        else:
            t0_, lapse_, t1_ = int_v[0], 0.0, int_v[0]
        q, m, r2i2 = _linreg(ih2, iv2)
        if r2i2 >= sig_r2:
            slope = min(m, 0.0)
            cross = _intersect(t0_, lapse_, q, slope)
            if cross is not None and cross[0] > 40.0:
                x, y = cross
                return OrographyLapse(valid=True,
                                      inversion_significant=True,
                                      h0=h0, h1=x, t0=t0_, t1=y,
                                      inversion_lapse=lapse_, slope=slope,
                                      r2=r22)
        else:
            return OrographyLapse(valid=True, inversion_significant=True,
                                  h0=h0, h1=h1, t0=t0_, t1=t1_,
                                  inversion_lapse=lapse_,
                                  slope=climate_lapse_rate, r2=r22)

    # fall-through: plain regression on everything
    # (interpolation.cpp:790-796)
    return generic()


def orography_trend(lapse: OrographyLapse, z):
    """Detrend/retrend value of the piecewise lapse at height z
    (detrendPoints height branch, interpolation.cpp:1255-1274; retrend
    :1330-1343). A tensor gives a tensor, anything else numpy, as the JAX
    function picks jnp or numpy by its argument's type."""
    if not isinstance(z, torch.Tensor):
        z = np.asarray(z)
        if not lapse.valid:
            return np.zeros_like(z)
        if lapse.inversion_significant:
            below = np.maximum(z - lapse.h0, 0.0) * lapse.inversion_lapse
            above = (lapse.h1 - lapse.h0) * lapse.inversion_lapse \
                + (z - lapse.h1) * lapse.slope
            return np.where(z <= lapse.h1, below, above)
        return np.maximum(z, 0.0) * lapse.slope
    h0, h1 = float(lapse.h0), float(lapse.h1)
    inv, slope = float(lapse.inversion_lapse), float(lapse.slope)
    if not lapse.valid:
        return torch.zeros_like(z)
    if lapse.inversion_significant:
        below = torch.clamp_min(z - h0, 0.0) * inv
        above = (h1 - h0) * inv + (z - h1) * slope
        return torch.where(z <= h1, below, above)
    return torch.clamp_min(z, 0.0) * slope


def _host_values(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def idw_map(station_x, station_y, station_value, grid_x, grid_y,
            active=None):
    """IDW of station values onto (R, C) coordinate maps, on their device.

    Weight = 1 / (d / 10 km)^3 (inverseDistanceWeighted,
    interpolation.cpp:1040-1046); a station within EPSILON of a cell centre
    dominates via the distance floor. The stations are added one whole map
    at a time in station order, the JAX scan's order; a station the mask
    leaves out adds nothing, as its zero weight adds nothing in JAX.
    """
    gx = as_f64(grid_x)
    gy = as_f64(grid_y, gx.device)
    sx = _host_values(station_x).astype(np.float64)
    sy = _host_values(station_y).astype(np.float64)
    sv = _host_values(station_value).astype(np.float64)
    ok = sv != NODATA
    if active is not None:
        ok = ok & _host_values(active).astype(bool)

    s_sum, w_sum = torch.zeros_like(gx), torch.zeros_like(gx)
    for x, y, v, valid in zip(sx.tolist(), sy.tolist(), sv.tolist(), ok.tolist()):
        if not valid:
            continue
        dist = torch.sqrt(sq(gx - x) + sq(gy - y))
        dist = torch.clamp_min(dist, EPSILON)
        d_km = div(dist, 10000.0)
        w = rdiv(1.0, d_km * d_km * d_km)
        s_sum = s_sum + v * w
        w_sum = w_sum + w
    return where(w_sum > 0, s_sum / torch.clamp_min(w_sum, 1e-30), NODATA)


@dataclasses.dataclass(frozen=True)
class ProxyResult:
    """The elevation proxy's fit: 0-d tensors on the stations' device."""

    slope: torch.Tensor
    intercept: torch.Tensor
    r2: torch.Tensor
    significant: torch.Tensor


def detrended_idw(station_x, station_y, station_z, station_value,
                  grid_x, grid_y, grid_z, *,
                  kind: VariableKind = VariableKind.GENERIC,
                  min_regression_r2: float = 0.1,
                  rainfall_threshold: float = 0.2,
                  extra_station_proxies=(), extra_grid_proxies=(),
                  elevation_lapse: OrographyLapse | None = None,
                  active=None):
    """Detrended IDW of one variable onto the DEM.

    1. regress station values against elevation (+ optional extra proxies);
    2. subtract the significant trends from station values (detrendPoints,
       interpolation.cpp:1236-1280);
    3. IDW the residuals;
    4. add the trends back at the grid cells (retrend);
    5. variable-specific clamping.

    ``elevation_lapse`` (an :class:`OrographyLapse` from
    :func:`regression_orography_t`) replaces the simple linear elevation
    regression with the thermal-inversion piecewise lapse — the
    useThermalInversion path of the reference (retrend,
    interpolation.cpp:1330-1343).

    The station side runs on the stations' device (the CPU for arrays),
    the maps on the grid's; a significance test is a host decision there.
    Returns ``(map, ProxyResult for elevation)``.
    """
    gz = as_f64(grid_z)
    sv = _station(station_value)
    sz = _station(station_z, sv.device)
    ok = sv != NODATA
    if active is not None:
        ok = ok & _station_bool(active, sv.device)

    # precipitation all-zero shortcut (interpolate, interpolation.cpp:2506)
    all_zero = False
    if kind == VariableKind.PRECIPITATION:
        all_zero = bool(torch.sum(torch.where(ok, torch.abs(sv), 0.0)) <= 0.0)

    proxies = [(sz, gz)]
    for sp, gp in zip(extra_station_proxies, extra_grid_proxies):
        proxies.append((_station(sp, sv.device), as_f64(gp, gz.device)))

    residual = sv
    trend_grid = torch.zeros_like(gz)
    elev_result = None
    detrendable = kind in _DETRENDABLE
    for i, (sp, gp) in enumerate(proxies):
        if i == 0 and elevation_lapse is not None and detrendable:
            # thermal-inversion piecewise lapse for the elevation proxy
            trend_st = orography_trend(elevation_lapse, sp)
            residual = where(ok, residual - trend_st, NODATA)
            trend_grid = trend_grid + orography_trend(elevation_lapse, gp)
            elev_result = ProxyResult(
                as_f64(float(elevation_lapse.slope), sv.device),
                as_f64(0.0, sv.device),
                as_f64(float(elevation_lapse.r2), sv.device),
                torch.tensor(bool(elevation_lapse.valid), device=sv.device))
            continue
        slope, intercept, r2 = simple_regression(residual, sp, ok)
        significant = bool(r2 >= min_regression_r2) and detrendable
        if significant:
            residual = torch.where(ok, residual - (intercept + slope * sp),
                                   residual)
        residual = where(ok, residual, NODATA)
        if significant:
            trend_grid = trend_grid + (float(intercept) + float(slope) * gp)
        if i == 0:
            elev_result = ProxyResult(slope, intercept, r2,
                                      torch.tensor(significant, device=sv.device))

    result = idw_map(station_x, station_y, residual, grid_x, grid_y, active=ok)
    result = where(result != NODATA, result + trend_grid, NODATA)

    # post-processing (interpolation.cpp:2540-2560)
    if kind == VariableKind.PRECIPITATION:
        result = where(result < rainfall_threshold, 0.0, result)
        if all_zero:
            result = torch.zeros_like(result)
    elif kind == VariableKind.RELATIVE_HUMIDITY:
        result = torch.clamp(result, 0.0, 100.0)
    elif kind == VariableKind.NON_NEGATIVE:
        result = torch.clamp_min(result, 0.0)

    return result, elev_result


SHEPARD_MIN_NRPOINTS = 5    # interpolationConstants.h:7-9
SHEPARD_AVG_NRPOINTS = 8
SHEPARD_MAX_NRPOINTS = 10
# cells per batch of shepard_idw_map: its (cells, k, k) direction tensor
# stays under ~100 MB at k = 10
_SHEPARD_CHUNK = 131072


def _shepard_initial_radius(bbox_area, n_points, avg_points):
    """computeShepardInitialRadius (interpolation.cpp:800-804)."""
    return math.sqrt((avg_points * bbox_area) / (math.pi * n_points))


def shepard_idw_map(station_x, station_y, station_value, grid_x, grid_y,
                    *, active=None, modified: bool = False):
    """Shepard (1968) interpolation with direction factors, batched over
    the grid's cells on the grid's device.

    Mirrors shepardIdw / modifiedShepardIdw (interpolation.cpp:871-1029):
    per cell, the neighbourhood is the stations within the density-derived
    initial radius, clamped to [5, 10] nearest (shepardSearchNeighbour,
    :806-869); distance kernel S_i is 1/d inside r/3 and the (27/4r)
    quadratic taper outside (classic) or (r-d)/(r d) (modified); weights are
    S_i^2 (1 + t_i) with the directional isolation factor t_i.

    The JAX function's per-cell ``lax.top_k(-d, k)`` is a stable ascending
    sort of each cell's distances, cut to k: both put the lower station
    index first among equal distances.
    """
    gx0 = as_f64(grid_x)
    dev = gx0.device
    sx = _station(_host_values(station_x), dev)
    sy = _station(_host_values(station_y), dev)
    sv = _station(_host_values(station_value), dev)
    ok_host = _host_values(station_value).astype(np.float64) != NODATA
    if active is not None:
        ok_host = ok_host & _host_values(active).astype(bool)
    ok = torch.as_tensor(ok_host, device=dev)
    n_st = sv.shape[0]
    k = min(n_st, SHEPARD_MAX_NRPOINTS)

    # the initial radius from the stations' bounding box: host floats
    hx = _host_values(station_x).astype(np.float64)
    hy = _host_values(station_y).astype(np.float64)
    n_ok = max(int(ok_host.sum()), 1)
    bbox_area = ((np.max(np.where(ok_host, hx, -np.inf))
                  - np.min(np.where(ok_host, hx, np.inf)))
                 * (np.max(np.where(ok_host, hy, -np.inf))
                    - np.min(np.where(ok_host, hy, np.inf))))
    r0 = _shepard_initial_radius(max(float(bbox_area), 1.0), n_ok,
                                 SHEPARD_AVG_NRPOINTS)

    gshape = gx0.shape
    gx = gx0.reshape(-1)
    gy = as_f64(grid_y, dev).reshape(-1)
    rank = torch.arange(k, device=dev)
    off_diag = ~torch.eye(k, dtype=torch.bool, device=dev)
    kmin = min(SHEPARD_MIN_NRPOINTS, k) - 1
    out = torch.empty_like(gx)
    for c0 in range(0, gx.numel(), _SHEPARD_CHUNK):
        cx = gx[c0:c0 + _SHEPARD_CHUNK, None]
        cy = gy[c0:c0 + _SHEPARD_CHUNK, None]
        d = torch.sqrt(sq(sx[None, :] - cx) + sq(sy[None, :] - cy))
        d = torch.where(ok[None, :] & (d > 0), d, math.inf)
        nd, idx = torch.sort(d, dim=1, stable=True)
        nd, idx = nd[:, :k], idx[:, :k]
        n_inside = torch.sum(nd <= r0, dim=1, keepdim=True)
        # < 5 inside: take the 5 nearest; > 10 inside: the 10 nearest;
        # else: all inside the initial radius (shepardSearchNeighbour)
        few = n_inside < SHEPARD_MIN_NRPOINTS
        many = n_inside > SHEPARD_MAX_NRPOINTS
        radius = torch.where(few, nd[:, kmin:kmin + 1] + EPSILON,
                             where(many, nd[:, k - 1:k] + EPSILON, r0))
        sel = torch.where(few, rank[None, :] < SHEPARD_MIN_NRPOINTS,
                          torch.where(many, rank[None, :] < k, nd <= r0))
        sel = sel & torch.isfinite(nd)

        if modified:
            s = where(sel & (nd <= radius),
                      (radius - nd) / (radius * torch.clamp_min(nd, EPSILON)),
                      0.0)
        else:
            r3 = div(radius, 3.0)
            taper = rdiv(6.75, radius) * sq((nd / radius) - 1.0)
            s = where(sel,
                      torch.where(nd <= r3, rdiv(1.0, torch.clamp_min(nd, EPSILON)),
                                  where(nd <= radius, taper, 0.0)),
                      0.0)
        s_sum = torch.sum(s, dim=1, keepdim=True)

        # directional isolation factor t_i (interpolation.cpp:911-927)
        px = sx[idx]
        py = sy[idx]
        ddx, ddy = cx - px, cy - py
        cos_ij = ((ddx[:, :, None] * ddx[:, None, :]
                   + ddy[:, :, None] * ddy[:, None, :])
                  / torch.clamp_min(nd[:, :, None] * nd[:, None, :], EPSILON))
        t = torch.sum(where(off_diag[None], s[:, None, :] * (1.0 - cos_ij), 0.0),
                      dim=2) / torch.clamp_min(s_sum, 1e-30)
        wgt = s * s * (1.0 + t)
        w_sum = torch.sum(wgt, dim=1)
        est = torch.sum(wgt * sv[idx], dim=1) / torch.clamp_min(w_sum, 1e-30)
        out[c0:c0 + _SHEPARD_CHUNK] = where(w_sum > 0, est, NODATA)
    return out.reshape(gshape)


def quality_range_check(value, vmin, vmax):
    """Gross-range quality control (Crit3DQuality, quality.h:41-94):
    NODATA outside the plausible physical range."""
    v = as_f64(value)
    ok = (v >= vmin) & (v <= vmax) & (v != NODATA)
    return where(ok, v, NODATA), ok


def spatial_quality_control(station_x, station_y, station_z, station_value,
                            *, kind: VariableKind = VariableKind.TEMPERATURE,
                            n_neighbours: int = 10, n_std_dev: float = 2.0,
                            min_regression_r2: float = 0.1):
    """Leave-one-out spatial consistency check, on the stations' device.

    Mirrors spatialQualityControl (spatialControl.cpp:336-430): each station
    is re-estimated from the others (detrended IDW at its own location); the
    residual is compared against a variable-specific threshold built from
    the neighbourhood standard deviation, elevation difference and distance
    (getSpatialThresholdVar, spatialControl.cpp:14-60). Returns a bool mask
    of accepted stations. The nearest neighbours come from a stable sort,
    as from ``jnp.argsort``: on a station lattice with tied distances the
    lower index comes first.
    """
    sv = _station(station_value)
    dev = sv.device
    sx, sy, sz = (_station(a, dev) for a in (station_x, station_y, station_z))
    n = sv.shape[0]
    valid = sv != NODATA
    inf = math.inf

    # pairwise distances with self-distance masked out
    dx = sx[:, None] - sx[None, :]
    dy = sy[:, None] - sy[None, :]
    dist = torch.sqrt(sq(dx) + sq(dy))
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    other = (~eye) & valid[None, :]

    # leave-one-out detrended estimate at each station
    slope, intercept, r2 = simple_regression(sv, sz, valid)
    significant = (r2 >= min_regression_r2) & (kind in _DETRENDABLE)
    resid = torch.where(significant, sv - (intercept + slope * sz), sv)

    d_km = div(where(other, torch.clamp_min(dist, EPSILON), inf), 10000.0)
    w = rdiv(1.0, ipow(d_km, 3))
    est_resid = torch.sum(where(other, w * resid[None, :], 0.0), dim=1) \
        / torch.clamp_min(torch.sum(where(other, w, 0.0), dim=1), 1e-30)
    est = torch.where(significant, est_resid + intercept + slope * sz, est_resid)
    residual = sv - est

    # neighbourhood statistics over the nearest n_neighbours stations
    big = where(other, dist, inf)
    order = torch.argsort(big, dim=1, stable=True)[:, :n_neighbours]
    nb_vals = sv[order]
    nb_z = sz[order]
    nb_dist = torch.gather(big, 1, order)
    nb_ok = torch.isfinite(nb_dist)
    cnt = torch.clamp_min(torch.sum(nb_ok, dim=1), 1).to(torch.float64)
    mean = torch.sum(where(nb_ok, nb_vals, 0.0), dim=1) / cnt
    var = torch.sum(where(nb_ok, sq(nb_vals - mean[:, None]), 0.0), dim=1) / cnt
    std_dev = torch.sqrt(var)
    avg_dz = torch.sum(where(nb_ok, torch.abs(nb_z - sz[:, None]), 0.0),
                       dim=1) / cnt
    min_dist = torch.min(where(nb_ok, nb_dist, inf), dim=1).values

    std_dev = torch.maximum(std_dev, div(torch.abs(sv), 100.0))
    if kind == VariableKind.TEMPERATURE:
        thr = torch.clamp_max(
            torch.clamp_max(div(min_dist, 1000.0) + 1.0 + div(avg_dz, 100.0), 12.0)
            + std_dev * n_std_dev, 15.0)
    elif kind == VariableKind.RELATIVE_HUMIDITY:
        thr = 20.0 + div(avg_dz, 10.0) + div(min_dist, 1000.0) + std_dev * n_std_dev
    elif kind == VariableKind.PRECIPITATION:
        dist_w = torch.clamp_min(div(min_dist, 2000.0), 1.0)
        thr = where(sv <= 0.2,
                    torch.clamp_min(dist_w + std_dev * (n_std_dev + 1), 5.0),
                    1000.0)
    else:
        thr = 10.0 + std_dev * n_std_dev

    return valid & (torch.abs(residual) <= thr)
