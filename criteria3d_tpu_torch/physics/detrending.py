"""Multiple / local / glocal proxy detrending, topographic distance and
cross-validation for meteorological interpolation.

PyTorch counterpart of ``criteria3d_tpu/physics/detrending.py`` (the
reference's advanced detrending stack, agrolib/interpolation/interpolation.cpp):

- **multiple detrending** (multipleDetrendingMain, :1832-1859): the elevation
  proxy is fitted with a piecewise lapse-rate function by multi-start
  Levenberg-Marquardt (weighted, every start in one batch,
  ``physics/fitting.py``); the remaining proxies with a summed linear fit,
  solved in closed form.
- **local detrending** (interpolationDemLocalDetrending, project.cpp:3158-3263;
  localSelection, interpolation.cpp:1087-1171): the whole per-cell pipeline
  — neighbour selection, distance weights, weighted elevation fit, residual
  interpolation, retrend — runs batched over the cells of a chunk
  (``_LOCAL_CHUNK`` cells at a time, so the peak memory stays bounded;
  cells are independent, so chunking changes no value), in the profiler
  range ``c3d.detrending``. The k nearest stations are a stable ascending
  sort of each cell's distances cut to k: ``lax.top_k(-d, k)`` keeps the
  lower station index first among equal distances, and so does the sort.
- **glocal detrending** (glocalDetrendingFitting, interpolation.cpp:2236-2292;
  interpolationDemGlocalDetrending, project.cpp:3267-3388): per-macro-area
  fits blended by per-cell area-weight maps, the window counts of
  writeGlocalWeightsMaps (project.cpp:2437-2521) as one-hot zone masks
  convolved with a disc (``conv2d``).
- **topographic distance** (gis.cpp:1595-1646): the maximum DEM rise above
  the lower endpoint along each station pair's segment, every pair and step
  at once; the multiplier Kh is found by golden-section search on the
  leave-one-out error (goldenSectionSearch / topographicDistanceOptimize,
  interpolation.cpp:2297-2392), a host loop.
- **cross-validation** (computeResiduals / computeErrorCrossValidation,
  spatialControl.cpp:102-334): leave-one-out residuals for every station at
  once.

Functions of arrays compute on ``device`` (the card when None; tensors stay
where they are, :func:`~criteria3d_tpu_torch.device.input_device`). Every
float expression keeps the JAX form (``ops.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from criteria3d_tpu_torch.constants import EPSILON, NODATA
from criteria3d_tpu_torch.device import host_array, host_read, input_device
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where
from criteria3d_tpu_torch.physics import fitting
from criteria3d_tpu_torch.physics.fitting import (ELEVATION_FUNCTIONS,
                                                  best_fitting_marquardt,
                                                  weighted_multilinear)
from criteria3d_tpu_torch.physics.interpolation import _station_bool, idw_map

__all__ = [
    "DetrendingOptions", "TrendModel", "multiple_detrending", "retrend_map",
    "local_detrending_map", "glocal_weight_maps", "glocal_detrending_map",
    "topographic_distance", "topographic_distance_matrix",
    "optimize_topo_kh", "loo_residuals", "cross_validation_error",
    "DETRENDING_RANGE",
]

MIN_PROXY_POINTS = 5  # proxyValidity MIN_NR (interpolation.cpp:1461)
# the torch.profiler range of local_detrending_map
DETRENDING_RANGE = "c3d.detrending"
# cells per batch of local_detrending_map: at k = 24 stations and 16 starts
# a batch's (cells x starts, k, 4) float64 Jacobian is ~400 MB
_LOCAL_CHUNK = 32768


@dataclasses.dataclass(frozen=True)
class DetrendingOptions:
    """Knobs of Crit3DInterpolationSettings relevant to detrending."""

    elevation_function: str = "double_piecewise"   # TFittingFunction names
    elevation_std_threshold: float = 100.0         # [m] proxy stddev gate
    proxy_std_threshold: float = 0.01              # other proxies
    min_points_local: int = 20                     # getMinPointsLocalDetrending
    n_lm_iterations: int = 60
    # parameter box for the elevation fit, relative to data ranges
    # (setFittingParameters_elevation + setMultipleDetrendingHeightTemperatureRange)
    t_margin_low: float = 2.0
    t_margin_high: float = 6.0


@dataclasses.dataclass(frozen=True)
class TrendModel:
    """Fitted detrending model: elevation lapse curve + linear proxies
    (tensors on one device)."""

    elevation_params: torch.Tensor        # (n_par,) piecewise parameters
    elevation_significant: torch.Tensor   # 0-d bool
    elevation_r2: torch.Tensor            # 0-d
    linear_slopes: torch.Tensor           # (n_other,)
    linear_intercept: torch.Tensor        # 0-d
    linear_significant: torch.Tensor      # (n_other,) bool
    elevation_function: str = "double_piecewise"

    def elevation_trend(self, z):
        func, _ = ELEVATION_FUNCTIONS[self.elevation_function]
        z = as_f64(z, self.elevation_params.device)
        p = self.elevation_params.to(z.device)
        t = func(z, p)
        return torch.where(self.elevation_significant.to(z.device), t, 0.0)

    def proxy_trend(self, proxy_values):
        """proxy_values: (..., n_other) stacked on the last axis."""
        pv = as_f64(proxy_values, self.linear_slopes.device)
        sig = self.linear_significant.to(pv.device)
        sl = torch.where(sig, self.linear_slopes.to(pv.device), 0.0)
        return torch.where(torch.any(sig),
                           pv @ sl + self.linear_intercept.to(pv.device), 0.0)


def _proxy_validity(values, mask, threshold):
    """proxyValidity (interpolation.cpp:1455-1496): >= 5 valid points and
    sample stddev above the threshold (over the last axis)."""
    n = torch.sum(mask, dim=-1)
    w = mask.to(values.dtype)
    avg = torch.sum(w * values, dim=-1) / torch.clamp_min(n, 1)
    var = (torch.sum(w * sq(values - avg[..., None]), dim=-1)
           / torch.clamp_min(n - 1, 1))
    return (n >= MIN_PROXY_POINTS) & (torch.sqrt(var) > threshold)


def _elevation_bounds(z, values, mask, options: DetrendingOptions):
    """Parameter box ``(..., n_par)`` for the piecewise elevation fit.

    Knee heights span the data elevation range; level spans the observed
    value range with the reference's -2/+6 margins
    (setMultipleDetrendingHeightTemperatureRange, interpolation.cpp:1506-1553);
    slopes within ±0.05 (unit per metre) as in the default proxy ranges.
    """
    big = 1e30
    zmin = torch.amin(torch.where(mask, z, big), dim=-1)
    zmax = torch.amax(torch.where(mask, z, -big), dim=-1)
    vmin = torch.amin(torch.where(mask, values, big), dim=-1) - options.t_margin_low
    vmax = torch.amax(torch.where(mask, values, -big), dim=-1) + options.t_margin_high
    n_par = ELEVATION_FUNCTIONS[options.elevation_function][1]

    def c(v):
        return torch.full_like(zmin, v)

    slope_lo, slope_hi = c(-0.05), c(0.05)
    if n_par == 4:      # x0, y0, s1, s2
        pmin = [zmin, vmin, slope_lo, slope_lo]
        pmax = [zmax, vmax, slope_hi, slope_hi]
    elif n_par == 5:    # x0, y0, dx, s_mid, s_outer
        pmin = [zmin, vmin, c(10.0), slope_lo, slope_lo]
        pmax = [zmax, vmax, zmax - zmin, slope_hi, slope_hi]
    else:               # x0, y0, dx, s_mid, s_lo, s_hi
        pmin = [zmin, vmin, c(10.0), slope_lo, slope_lo, slope_lo]
        pmax = [zmax, vmax, zmax - zmin, slope_hi, slope_hi, slope_hi]
    return torch.stack(pmin, -1), torch.stack(pmax, -1)


def multiple_detrending(station_value, station_z, other_proxies=(), *,
                        weights=None, active=None,
                        options: DetrendingOptions = DetrendingOptions(),
                        device=None):
    """Fit elevation + linear proxy trends; return (detrended values, model).

    Mirrors multipleDetrendingMain (interpolation.cpp:1832-1859): elevation
    first (weighted piecewise fit, significance-gated by proxy variability),
    then the other proxies on the elevation-detrended values (closed-form
    weighted multilinear).

    ``other_proxies``: sequence of per-station arrays. Stations with missing
    (NODATA) proxies are masked, as the reference erases them.
    """
    dev = input_device(device, station_value, station_z)
    v = as_f64(station_value, dev)
    z = as_f64(station_z, dev)
    ok = (v != NODATA) & (z != NODATA)
    if active is not None:
        ok = ok & _station_bool(active, dev)
    w = torch.ones_like(v) if weights is None else as_f64(weights, dev)
    w = torch.where(ok, torch.clamp_min(w, EPSILON), 0.0)

    func, n_par = ELEVATION_FUNCTIONS[options.elevation_function]
    elev_valid = _proxy_validity(z, ok, options.elevation_std_threshold)
    pmin, pmax = _elevation_bounds(z, v, ok, options)
    params, r2 = best_fitting_marquardt(func, pmin, pmax, z, v, w,
                                        n_iter=options.n_lm_iterations)
    elev_sig = elev_valid & (r2 > 0)
    detrended = torch.where(elev_sig & ok, v - func(z, params), v)

    n_other = len(other_proxies)
    if n_other:
        P = torch.stack([as_f64(p, dev) for p in other_proxies], dim=1)
        p_ok = torch.all(P != NODATA, dim=1) & ok
        sig = torch.stack([
            _proxy_validity(P[:, i], p_ok, options.proxy_std_threshold)
            for i in range(n_other)])
        wp = torch.where(p_ok, w, 0.0)
        Pm = torch.where(sig[None, :], P, 0.0)
        slopes, intercept = weighted_multilinear(Pm, detrended, wp)
        slopes = torch.where(sig, slopes, 0.0)
        any_sig = torch.any(sig)
        intercept = torch.where(any_sig, intercept, 0.0)
        trend = Pm @ slopes + intercept
        detrended = torch.where(p_ok & any_sig, detrended - trend, detrended)
        # points with incomplete proxies are dropped by the reference
        # (multipleDetrendingOtherProxiesFitting, interpolation.cpp:2034-2063)
        detrended = where(torch.where(any_sig, p_ok, ok), detrended, NODATA)
    else:
        sig = torch.zeros((0,), dtype=torch.bool, device=dev)
        slopes = torch.zeros((0,), dtype=torch.float64, device=dev)
        intercept = torch.zeros((), dtype=torch.float64, device=dev)
        detrended = where(ok, detrended, NODATA)

    model = TrendModel(elevation_params=params,
                       elevation_significant=elev_sig,
                       elevation_r2=r2,
                       linear_slopes=slopes,
                       linear_intercept=intercept,
                       linear_significant=sig,
                       elevation_function=options.elevation_function)
    return detrended, model


def retrend_map(model: TrendModel, grid_z, grid_other_proxies=(), *,
                device=None):
    """Trend surface at grid cells (retrend, interpolation.cpp:1294-1378),
    on the grid's device."""
    dev = input_device(device, grid_z)
    t = model.elevation_trend(as_f64(grid_z, dev))
    if len(grid_other_proxies):
        P = torch.stack([as_f64(p, dev) for p in grid_other_proxies], dim=-1)
        t = t + model.proxy_trend(where(P == NODATA, 0.0, P))
    return t


# ---------------------------------------------------------------------------
# local detrending — one batched per-cell pipeline
# ---------------------------------------------------------------------------

def _local_cells(sx, sy, sz, sv, ok, cx, cy, cz, k, func, options):
    """The local-detrending estimate at a batch of cells (1-D tensors)."""
    d = torch.sqrt(sq(sx[None, :] - cx[:, None]) + sq(sy[None, :] - cy[:, None]))
    d = torch.where(ok[None, :], d, math.inf)
    nd, idx = torch.sort(d, dim=1, stable=True)
    nd, idx = nd[:, :k], idx[:, :k]                      # ascending distances
    valid = torch.isfinite(nd)
    d_max = torch.amax(torch.where(valid, nd, 0.0), dim=1)
    w = where(valid,
              torch.clamp_min(1.0 - nd / torch.clamp_min(d_max, EPSILON)[:, None],
                              EPSILON), 0.0)
    vz = sz[idx]
    vv = sv[idx]

    elev_valid = _proxy_validity(vz, valid, options.elevation_std_threshold)
    pmin, pmax = _elevation_bounds(vz, vv, valid, options)
    params, r2 = best_fitting_marquardt(
        func, pmin, pmax, vz, vv, w,
        first_guesses=fitting.first_guess_grid(pmin, pmax, steps_per_param=2),
        n_iter=options.n_lm_iterations)
    sig = elev_valid & (r2 > 0)
    resid = torch.where(sig[:, None], vv - func(vz, params[:, None, :]), vv)

    # modified-Shepard residual interpolation within the local radius
    # (modifiedShepardIdw, interpolation.cpp:948-1029)
    radius = (d_max + EPSILON)[:, None]
    s = where(valid & (nd > 0),
              (radius - nd) / (radius * torch.clamp_min(nd, EPSILON)), 0.0)
    exact = valid & (nd <= EPSILON)
    s2 = s * s
    est = (torch.sum(s2 * resid, dim=1)
           / torch.clamp_min(torch.sum(s2, dim=1), 1e-30))
    est = torch.where(torch.any(exact, dim=1),
                      torch.sum(torch.where(exact, resid, 0.0), dim=1)
                      / torch.clamp_min(torch.sum(exact, dim=1), 1), est)
    trend = torch.where(sig, func(cz, params), 0.0)
    return est + trend


def local_detrending_map(station_x, station_y, station_z, station_value,
                         grid_x, grid_y, grid_z, *,
                         options: DetrendingOptions = DetrendingOptions(),
                         n_first_guesses: int = 16, active=None,
                         device=None):
    """Per-cell neighbourhood detrended interpolation, on the grid's device.

    For every target cell: select the ``ceil(1.2 * min_points)`` nearest
    stations (the fixed-size expression of localSelection's expanding rings,
    interpolation.cpp:1087-1171), weight them ``max(1 - d/d_max, eps)``
    (:1160), fit the piecewise elevation curve with those weights (2 first
    guesses a parameter), then interpolate the residuals with the
    modified-Shepard kernel inside the local radius and retrend with the
    cell's own elevation.

    The reference runs this per DEM cell under OpenMP; here the cells of
    each chunk of ``_LOCAL_CHUNK`` are one batch, in the profiler range
    ``c3d.detrending``.
    """
    dev = input_device(device, grid_x, grid_y, grid_z)
    sx = as_f64(station_x, dev)
    sy = as_f64(station_y, dev)
    sz = as_f64(station_z, dev)
    sv = as_f64(station_value, dev)
    ok = (sv != NODATA) & (sz != NODATA)
    if active is not None:
        ok = ok & _station_bool(active, dev)
    n_st = sv.shape[0]
    k = min(n_st, int(math.ceil(options.min_points_local * 1.2)))

    gx0 = as_f64(grid_x, dev)
    gx = gx0.reshape(-1)
    gy = as_f64(grid_y, dev).reshape(-1)
    gz = as_f64(grid_z, dev).reshape(-1)
    func, _ = ELEVATION_FUNCTIONS[options.elevation_function]
    out = torch.empty_like(gx)
    with torch.profiler.record_function(DETRENDING_RANGE):
        for c0 in range(0, gx.numel(), _LOCAL_CHUNK):
            sl = slice(c0, c0 + _LOCAL_CHUNK)
            out[sl] = _local_cells(sx, sy, sz, sv, ok, gx[sl], gy[sl], gz[sl],
                                   k, func, options)
    return out.reshape(gx0.shape)


# ---------------------------------------------------------------------------
# glocal detrending — macro areas blended by convolved weight maps
# ---------------------------------------------------------------------------

def glocal_weight_maps(zone_map, window_width: float, cellsize: float, *,
                       device=None):
    """Per-zone blending weights: fraction of cells of each zone within a
    disc window around every cell.

    The reference computes this with a per-cell window scan
    (writeGlocalWeightsMaps, project.cpp:2437-2521). Convolving each
    one-hot zone mask with the disc kernel gives the identical counts.
    The float32 sums of 0/1 terms are integers; they are rounded back to
    the integers they are, so no convolution algorithm the card picks can
    move a count. ``zone_map``: (R, C) int zone ids starting at 1,
    <=0 / NODATA outside. Returns (n_zones, R, C) float32 weights summing
    to 1 on valid cells.
    """
    dev = input_device(device, zone_map)
    zm = (zone_map.to(dev) if isinstance(zone_map, torch.Tensor)
          else torch.as_tensor(np.asarray(zone_map), device=dev))
    n_zones = int(host_read(torch.amax(zm)))
    cell_nr = int(round(window_width / cellsize))
    r = torch.arange(-cell_nr, cell_nr + 1, device=dev)
    disc = (r[:, None] ** 2 + r[None, :] ** 2) <= cell_nr ** 2
    kernel = disc.to(torch.float32)[None, None]

    valid = zm > 0
    onehot = torch.stack([(zm == z + 1) & valid for z in range(n_zones)])
    x = onehot.to(torch.float32)[:, None]                # (Z, 1, R, C)
    counts = torch.round(torch.nn.functional.conv2d(x, kernel, padding=cell_nr))[:, 0]
    total = torch.round(torch.nn.functional.conv2d(
        valid.to(torch.float32)[None, None], kernel, padding=cell_nr))[0, 0]
    return torch.where(valid[None] & (total > 0),
                       counts / torch.clamp_min(total, 1), 0.0)


def glocal_detrending_map(station_x, station_y, station_z, station_value,
                          grid_x, grid_y, grid_z, *,
                          area_stations: Sequence[np.ndarray],
                          area_weights, active=None,
                          options: DetrendingOptions = DetrendingOptions(),
                          device=None):
    """Macro-area detrended interpolation blended by per-cell area weights,
    on the grid's device.

    Per area: unweighted multiple detrending on the area's station subset
    (glocalDetrendingFitting, interpolation.cpp:2236-2292; isWeighted=false),
    residual IDW over the whole grid (``physics/interpolation.idw_map``),
    retrend — then the per-area maps are combined with ``area_weights``
    (n_areas, R, C) as one weighted sum of dense maps.

    ``area_stations[i]``: integer indices of the stations belonging to area i
    (the glocal stations CSV, Project::loadGlocalStationsAndCells).
    """
    dev = input_device(device, grid_x, grid_y, grid_z)
    sv = as_f64(station_value, dev)
    ok = sv != NODATA
    if active is not None:
        ok = ok & _station_bool(active, dev)
    sz = as_f64(station_z, dev)
    gx = as_f64(grid_x, dev)
    gy = as_f64(grid_y, dev)
    gz = as_f64(grid_z, dev)

    aw = as_f64(area_weights, dev)
    out = torch.zeros_like(gz)
    wsum = torch.zeros_like(out)
    for i, idx in enumerate(area_stations):
        idx = np.asarray(idx, np.int64)
        if idx.size == 0:
            continue
        member = np.zeros(sv.shape[0], bool)
        member[idx] = True
        m_ok = ok & torch.as_tensor(member, device=dev)
        detr, model = multiple_detrending(
            where(m_ok, sv, NODATA), sz, active=m_ok, options=options)
        # the station side on the host: idw_map adds one station map at a
        # time, in station order
        resid_map = idw_map(station_x, station_y, host_array(detr), gx, gy,
                            active=host_array(m_ok))
        area_map = torch.where(resid_map != NODATA,
                               resid_map + retrend_map(model, gz), 0.0)
        out = out + aw[i] * area_map
        wsum = wsum + torch.where(resid_map != NODATA, aw[i], 0.0)
    return where(wsum > 0, out / torch.clamp_min(wsum, 1e-30), NODATA)


# ---------------------------------------------------------------------------
# topographic distance
# ---------------------------------------------------------------------------

def _topo_march(dem, header_x0, header_y0, cellsize, nrows,
                x1, y1, z1, x2, y2, z2, distance, max_steps: int):
    """gis::topographicDistance over broadcast endpoint tensors: the march's
    step axis is the last."""
    lower_first = z1 < z2
    xi = torch.where(lower_first, x1, x2)[..., None]
    yi = torch.where(lower_first, y1, y2)[..., None]
    zi = torch.where(lower_first, z1, z2)[..., None]
    xf = torch.where(lower_first, x2, x1)[..., None]
    yf = torch.where(lower_first, y2, y1)[..., None]

    nr_step = torch.floor(div(distance, cellsize)).to(torch.int32)[..., None]
    i = torch.arange(1, max_steps + 1, device=dem.device)
    frac = i.to(torch.float64) / torch.clamp_min(nr_step, 1)
    px = xi + frac * (xf - xi)
    py = yi + frac * (yf - yi)
    col = torch.clamp(torch.round(div(px - header_x0, cellsize) - 0.5).to(torch.int32),
                      0, dem.shape[1] - 1)
    row = torch.clamp(torch.round(nrows - div(py - header_y0, cellsize) - 0.5)
                      .to(torch.int32), 0, dem.shape[0] - 1)
    v = dem[row.long(), col.long()]
    in_march = (i <= nr_step) & (v != NODATA)
    rise = torch.where(in_march & (v > zi), v - zi, 0.0)
    return torch.where(distance < cellsize, 0.0, torch.amax(rise, dim=-1))


def topographic_distance(dem, header_x0, header_y0, cellsize, nrows,
                         x1, y1, z1, x2, y2, z2, distance, max_steps: int, *,
                         device=None):
    """Maximum DEM rise above the lower endpoint along the segment
    (gis::topographicDistance, gis.cpp:1595-1646).

    Marches from the lower of the two points in ``nrStep = distance/cellsize``
    steps, sampling the DEM by nearest cell; fixed ``max_steps`` with
    masking. Returns a 0-d tensor.
    """
    dev = input_device(device, dem)
    dem = as_f64(dem, dev)
    args = [as_f64(a, dev) for a in (x1, y1, z1, x2, y2, z2, distance)]
    return _topo_march(dem, header_x0, header_y0, cellsize, nrows, *args,
                       max_steps)


def topographic_distance_matrix(dem, header_x0, header_y0, cellsize, nrows,
                                station_x, station_y, station_z,
                                max_steps: int = 256, *, device=None):
    """(n, n) pairwise topographic distances between stations (used by the
    Kh optimization; the per-station maps of writeTopographicDistanceMaps
    are the grid-side analogue), and the (n, n) plane distances."""
    dev = input_device(device, dem, station_x)
    dem = as_f64(dem, dev)
    sx = as_f64(station_x, dev)
    sy = as_f64(station_y, dev)
    sz = as_f64(station_z, dev)
    d = torch.sqrt(sq(sx[:, None] - sx[None, :]) + sq(sy[:, None] - sy[None, :]))
    # row i marches from station i to every station j, over d(j, i)
    dd = torch.sqrt(sq(sx[None, :] - sx[:, None]) + sq(sy[None, :] - sy[:, None]))
    topo = _topo_march(dem, header_x0, header_y0, cellsize, nrows,
                       sx[:, None], sy[:, None], sz[:, None],
                       sx[None, :], sy[None, :], sz[None, :], dd, max_steps)
    return topo, d


def loo_residuals(station_x, station_y, station_z, station_value, *,
                  kh: float = 0.0, topo_dist=None, active=None,
                  detrend_model: TrendModel | None = None, device=None):
    """Leave-one-out residuals: each station re-estimated from the others by
    (detrended) IDW with optional topographic-distance weighting
    (computeResiduals, spatialControl.cpp:102-160). Vectorized over the
    excluded-station axis."""
    dev = input_device(device, station_value, station_x)
    sx = as_f64(station_x, dev)
    sy = as_f64(station_y, dev)
    sz = as_f64(station_z, dev)
    sv = as_f64(station_value, dev)
    ok = sv != NODATA
    if active is not None:
        ok = ok & _station_bool(active, dev)

    if detrend_model is not None:
        trend = detrend_model.elevation_trend(sz)
        resid = torch.where(ok, sv - trend, sv)
    else:
        resid = sv
        trend = torch.zeros_like(sv)

    n = sv.shape[0]
    d = torch.sqrt(sq(sx[:, None] - sx[None, :]) + sq(sy[:, None] - sy[None, :]))
    if topo_dist is not None:
        d = d + kh * as_f64(topo_dist, dev)
    other = (~torch.eye(n, dtype=torch.bool, device=dev)) & ok[None, :]
    d_km = div(torch.where(other, torch.clamp_min(d, EPSILON), math.inf), 10000.0)
    w = rdiv(1.0, ipow(d_km, 3))
    est = (torch.sum(torch.where(other, w * resid[None, :], 0.0), dim=1)
           / torch.clamp_min(torch.sum(torch.where(other, w, 0.0), dim=1), 1e-30))
    residual = sv - (est + trend)
    return where(ok, residual, NODATA)


def cross_validation_error(station_x, station_y, station_z, station_value,
                           **kw):
    """Mean absolute LOO error (computeErrorCrossValidation,
    spatialControl.cpp:310-333), a 0-d tensor."""
    r = loo_residuals(station_x, station_y, station_z, station_value, **kw)
    ok = r != NODATA
    return (torch.sum(torch.where(ok, torch.abs(r), 0.0))
            / torch.clamp_min(torch.sum(ok), 1))


GOLDEN_SECTION = (1.0 + math.sqrt(5.0)) / 2.0


def optimize_topo_kh(station_x, station_y, station_z, station_value, *,
                     topo_dist, max_kh: float = 256.0,
                     detrend_model: TrendModel | None = None,
                     active=None, device=None):
    """Golden-section search of the topographic-distance multiplier Kh
    minimising the LOO cross-validation MAE (goldenSectionSearch +
    topographicDistanceOptimize, interpolation.cpp:2297-2392). Kh is
    truncated to int inside the objective, as in the reference. A host
    loop: each evaluation reads the error back (one counted host read)."""
    dev = input_device(device, topo_dist, station_value)

    def f(kh_float):
        return host_read(cross_validation_error(
            station_x, station_y, station_z, station_value,
            kh=float(int(kh_float)), topo_dist=topo_dist,
            detrend_model=detrend_model, active=active, device=dev))

    a, b = 0.0, float(max_kh)
    x1 = b - (b - a) / GOLDEN_SECTION
    x2 = a + (b - a) / GOLDEN_SECTION
    for _ in range(100):
        if abs(b - a) <= 1.0:
            break
        if f(x1) < f(x2):
            b, x2 = x2, x1
            x1 = b - (b - a) / GOLDEN_SECTION
        else:
            a, x1 = x1, x2
            x2 = a + (b - a) / GOLDEN_SECTION
    return int((a + b) / 2)
