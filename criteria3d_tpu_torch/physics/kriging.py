"""Ordinary kriging with variogram estimation.

PyTorch counterpart of ``criteria3d_tpu/physics/kriging.py`` (the reference
kriging library, agrolib/interpolation/kriging.cpp, Chao-yi Lang 1995): the
reference builds the (n+1) ordinary-kriging system with a hand-rolled
Gauss-Jordan inversion and solves the weights **per target point**
(krigingSetWeight, kriging.cpp:205-265). Here the system is factorized once
and the weights for *all* grid cells come from one solve with one
right-hand side per cell.

Variogram models exactly as kriging.cpp:160-192 (spherical / exponential
with -3h/r / gaussian with -4(h/r)^2 / linear). The empirical-variogram
estimation that the reference declares but never implements
(krigingEstimateVariogram, interpolation.h:72) is provided: binned
semivariance + weighted least-squares model fit, best-of-four selection.
Each bin's sums are masked reductions, the same on every device (no
atomic scatter), and the model fit reads each mode's SSEs back to the host
for its argmin, as JAX does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.device import host_array, host_read, input_device
from criteria3d_tpu_torch.ops import as_f64, div, ipow, linspace, sq, where
from criteria3d_tpu_torch.physics.interpolation import _station_bool

__all__ = ["VariogramModel", "variogram", "empirical_variogram",
           "fit_variogram", "ordinary_kriging"]

SPHERICAL, EXPONENTIAL, GAUSSIAN, LINEAR = 1, 2, 3, 4
_MODE_NAMES = {SPHERICAL: "spherical", EXPONENTIAL: "exponential",
               GAUSSIAN: "gaussian", LINEAR: "linear"}


@dataclasses.dataclass(frozen=True)
class VariogramModel:
    mode: int            # TkrigingMode (interpolationConstants.h:51-55)
    nugget: float
    sill: float
    range_: float
    slope: float = 0.0

    @property
    def name(self):
        return _MODE_NAMES[self.mode]


def variogram(h, model: VariogramModel, *, device=None):
    """gamma(h) for each model (kriging.cpp:160-192)."""
    h = as_f64(h, input_device(device, h))
    t = div(h, model.range_)
    sn = model.sill - model.nugget
    if model.mode == SPHERICAL:
        g = torch.where(h < model.range_,
                        model.nugget + sn * (1.5 * t - 0.5 * ipow(t, 3)),
                        model.nugget + sn)
    elif model.mode == EXPONENTIAL:
        g = model.nugget + sn * (1.0 - torch.exp(-3.0 * t))
    elif model.mode == GAUSSIAN:
        g = model.nugget + sn * (1.0 - torch.exp(-4.0 * t * t))
    else:
        g = model.nugget + model.slope * h
    return g


def _stations(dev, station_x, station_y, station_value, active):
    sx = as_f64(station_x, dev)
    sy = as_f64(station_y, dev)
    sv = as_f64(station_value, dev)
    ok = sv != NODATA
    if active is not None:
        ok = ok & _station_bool(active, dev)
    d = torch.sqrt(sq(sx[:, None] - sx[None, :]) + sq(sy[:, None] - sy[None, :]))
    return sx, sy, sv, ok, d


def empirical_variogram(station_x, station_y, station_value, *,
                        n_bins: int = 12, max_distance: float | None = None,
                        active=None, device=None):
    """Binned semivariance 0.5 * mean (v_i - v_j)^2 over station pairs.

    Returns (bin_centres, gamma, pair_counts); empty bins carry NODATA.
    """
    dev = input_device(device, station_value, station_x)
    sx, sy, sv, ok, d = _stations(dev, station_x, station_y, station_value, active)
    dv2 = 0.5 * sq(sv[:, None] - sv[None, :])
    pair = ok[:, None] & ok[None, :] & (d > 0)
    if max_distance is None:
        max_distance = host_read(torch.amax(torch.where(pair, d, 0.0))) * 0.75
    width = max_distance / n_bins
    bin_idx = torch.clamp(div(d, width).to(torch.int32), 0, n_bins - 1)
    in_range = pair & (d <= max_distance)

    in_bin = (bin_idx[None] == torch.arange(n_bins, device=dev)[:, None, None]) & in_range
    counts = torch.sum(in_bin, dim=(1, 2)).to(torch.float64)
    sums = torch.sum(torch.where(in_bin, dv2, 0.0), dim=(1, 2))
    gamma = where(counts > 0, sums / torch.clamp_min(counts, 1), NODATA)
    centres = (torch.arange(n_bins, dtype=torch.float64, device=dev) + 0.5) * width
    return centres, gamma, counts / 2.0   # pairs counted twice


def fit_variogram(h, gamma, counts=None, modes=(SPHERICAL, EXPONENTIAL,
                                                GAUSSIAN, LINEAR),
                  n_grid: int = 24, *, device=None) -> VariogramModel:
    """Pick the (mode, nugget, sill, range/slope) minimising the
    count-weighted SSE against the empirical variogram.

    Grid search over range with closed-form (nugget, sill) per candidate —
    the whole candidate sweep of a mode is one batched program; its SSEs,
    nuggets and slopes come back to the host for the argmin (one read a
    mode, and two for the largest lag and the ranges).
    """
    dev = input_device(device, h, gamma)
    h = as_f64(h, dev)
    g = as_f64(gamma, dev)
    ok = g != NODATA
    w = where(ok, 1.0 if counts is None else as_f64(counts, dev), 0.0)
    hmax = host_read(torch.amax(torch.where(ok, h, 0.0)))
    ranges = linspace(as_f64(hmax / n_grid, dev), as_f64(hmax * 1.5, dev), n_grid)
    ranges_host = host_array(ranges)

    def basis(mode, r):
        t = h / r
        if mode == SPHERICAL:
            return torch.where(h < r, 1.5 * t - 0.5 * ipow(t, 3), 1.0)
        if mode == EXPONENTIAL:
            return 1.0 - torch.exp(-3.0 * t)
        if mode == GAUSSIAN:
            return 1.0 - torch.exp(-4.0 * t * t)
        return h.expand_as(t)  # linear: basis is h itself, "range" unused

    best = None
    for mode in modes:
        # every candidate range on the first axis: (n_ranges, n_bins)
        r = ranges[:, None] if mode != LINEAR else as_f64([[1.0]], dev)
        b = basis(mode, r)
        # weighted LSQ of g ~ nugget + c * b  (c = sill - nugget or slope)
        sw = torch.clamp_min(torch.sum(w), 1e-30)
        mb = torch.sum(w * b, dim=-1, keepdim=True) / sw
        mg = torch.sum(w * g * ok) / sw
        sbb = torch.sum(w * sq(b - mb), dim=-1, keepdim=True)
        sbg = torch.sum(w * (b - mb) * (torch.where(ok, g, 0.0) - mg),
                        dim=-1, keepdim=True)
        c = torch.where(sbb > 0, sbg / torch.clamp_min(sbb, 1e-30), 0.0)
        c = torch.clamp_min(c, 0.0)
        nug = torch.clamp_min(mg - c * mb, 0.0)
        res = torch.where(ok, g - (nug + c * b), 0.0)
        sses, nugs, cs = host_array(torch.stack(
            [torch.sum(w * res * res, dim=-1), nug[:, 0], c[:, 0]]))
        if mode == LINEAR:
            cand = (float(sses[0]), VariogramModel(mode, float(nugs[0]), float(nugs[0]),
                                                   1.0, slope=float(cs[0])))
        else:
            i = int(np.argmin(sses))
            cand = (float(sses[i]),
                    VariogramModel(mode, float(nugs[i]), float(nugs[i] + cs[i]),
                                   float(ranges_host[i])))
        if best is None or cand[0] < best[0]:
            best = cand
    return best[1]


def ordinary_kriging(station_x, station_y, station_value, grid_x, grid_y,
                     model: VariogramModel, *, active=None, device=None):
    """Ordinary-kriging map on the grid's device: one LU factorization,
    then its triangular solves with a right-hand side per cell.

    System layout identical to krigingVariogram (kriging.cpp:141-196):
    V[i,j] = gamma(d_ij) with a Lagrange row/col of ones; right-hand sides
    D[:, cell] = gamma(d(station, cell)), 1. Inactive stations are removed
    by collapsing their rows to the identity (zero weight).
    """
    dev = input_device(device, grid_x, grid_y)
    sx, sy, sv, ok, d = _stations(dev, station_x, station_y, station_value, active)
    n = sv.shape[0]

    V = torch.zeros((n + 1, n + 1), dtype=torch.float64, device=dev)
    pair = ok[:, None] & ok[None, :]
    V[:n, :n] = torch.where(pair, variogram(d, model), 0.0)
    V[:n, n] = torch.where(ok, 1.0, 0.0)
    V[n, :n] = torch.where(ok, 1.0, 0.0)
    # inactive stations: identity rows -> weight forced to 0
    diag_fix = torch.cat([~ok, torch.zeros(1, dtype=torch.bool, device=dev)])
    V = V + torch.diag(where(diag_fix, 1.0, 0.0))

    gx0 = as_f64(grid_x, dev)
    gx = gx0.reshape(-1)
    gy = as_f64(grid_y, dev).reshape(-1)
    dg = torch.sqrt(sq(sx[:, None] - gx[None, :]) + sq(sy[:, None] - gy[None, :]))
    D = torch.cat([torch.where(ok[:, None], variogram(dg, model), 0.0),
                   torch.ones((1, gx.numel()), dtype=torch.float64, device=dev)], dim=0)
    lu, piv, _ = torch.linalg.lu_factor_ex(V)
    W = torch.linalg.lu_solve(lu, piv, D)            # (n+1, n_cells)
    est = torch.where(ok, sv, 0.0) @ W[:n]
    return est.reshape(gx0.shape)
