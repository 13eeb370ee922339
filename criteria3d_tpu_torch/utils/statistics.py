"""Statistics substrate: the mathFunctions/statistics + gammaFunction
analogue (SURVEY §2.2).

The port's own copy of ``criteria3d_tpu/utils/statistics.py``, line for line (host
numpy and the standard library).

NODATA-aware vector statistics mirroring agrolib/mathFunctions/statistics.h:
regression, error scores (RMSE/MAE/ME/Nash-Sutcliffe), dispersion,
percentile — plus the (log-)gamma and regularised incomplete gamma used by
the gamma root-profile and drought-index paths (gammaFunction.h:29-34).

Everything is plain numpy (these are host-side elaboration helpers, like the
reference's — the solver's reductions stay in torch).
"""

from __future__ import annotations

import math

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["mean", "variance", "standard_deviation", "covariance",
           "pearson", "linear_regression", "weighed_mean",
           "root_mean_square_error", "mean_error", "mean_absolute_error",
           "nash_sutcliffe_efficiency", "percentile",
           "gamma_ln", "incomplete_gamma", "gamma_cdf",
           "linear_interpolation"]


def _valid(*arrays):
    """Mask rows where every array is finite and not NODATA."""
    ok = np.ones(np.asarray(arrays[0], float).shape, bool)
    out = []
    for a in arrays:
        a = np.asarray(a, dtype=float)
        ok &= np.isfinite(a) & (a != NODATA)
        out.append(a)
    return [a[ok] for a in out]


def mean(values):
    v, = _valid(values)
    return float(v.mean()) if v.size else NODATA


def variance(values):
    """Sample variance (statistics.cpp variance: / (n-1))."""
    v, = _valid(values)
    return float(v.var(ddof=1)) if v.size > 1 else NODATA


def standard_deviation(values):
    var = variance(values)
    return math.sqrt(var) if var != NODATA else NODATA


def covariance(x, y):
    x, y = _valid(x, y)
    if x.size < 2:
        return NODATA
    return float(((x - x.mean()) * (y - y.mean())).sum() / (x.size - 1))


def pearson(x, y):
    x, y = _valid(x, y)
    if x.size < 2:
        return NODATA
    sx, sy = x.std(ddof=1), y.std(ddof=1)
    if sx == 0 or sy == 0:
        return NODATA
    return float(((x - x.mean()) * (y - y.mean())).sum()
                 / ((x.size - 1) * sx * sy))


def linear_regression(x, y, zero_intercept: bool = False):
    """(intercept, slope, r2) — statistics::linearRegression
    (statistics.cpp:44-45 overloads)."""
    x, y = _valid(x, y)
    if x.size < 2:
        return NODATA, NODATA, NODATA
    if zero_intercept:
        sxx = (x * x).sum()
        slope = (x * y).sum() / sxx if sxx > 0 else 0.0
        intercept = 0.0
    else:
        mx, my = x.mean(), y.mean()
        sxx = ((x - mx) ** 2).sum()
        slope = ((x - mx) * (y - my)).sum() / sxx if sxx > 0 else 0.0
        intercept = my - slope * mx
    resid = y - (intercept + slope * x)
    syy = ((y - y.mean()) ** 2).sum()
    r2 = 1.0 - (resid ** 2).sum() / syy if syy > 0 else 0.0
    return float(intercept), float(slope), float(r2)


def weighed_mean(values, weights):
    v, w = _valid(values, weights)
    ws = w.sum()
    return float((v * w).sum() / ws) if ws > 0 else NODATA


def root_mean_square_error(measured, simulated):
    m, s = _valid(measured, simulated)
    return float(np.sqrt(((m - s) ** 2).mean())) if m.size else NODATA


def mean_error(measured, simulated):
    m, s = _valid(measured, simulated)
    return float((s - m).mean()) if m.size else NODATA


def mean_absolute_error(measured, simulated):
    m, s = _valid(measured, simulated)
    return float(np.abs(s - m).mean()) if m.size else NODATA


def nash_sutcliffe_efficiency(measured, simulated):
    m, s = _valid(measured, simulated)
    if m.size < 2:
        return NODATA
    denom = ((m - m.mean()) ** 2).sum()
    return float(1.0 - ((m - s) ** 2).sum() / denom) if denom > 0 else NODATA


def percentile(values, p, sort: bool = True):
    """p-th percentile, nearest-rank flavour like sorting::percentile."""
    v, = _valid(values)
    if not v.size:
        return NODATA
    if sort:
        v = np.sort(v)
    rank = p / 100.0 * (v.size - 1)
    lo = int(np.floor(rank))
    hi = min(lo + 1, v.size - 1)
    frac = rank - lo
    return float(v[lo] * (1 - frac) + v[hi] * frac)


def linear_interpolation(x1, y1, x2, y2, x):
    """statistics::linearInterpolation."""
    if x2 == x1:
        return y1
    return y1 + (y2 - y1) * (x - x1) / (x2 - x1)


# ----------------------------------------------------------------------
# gamma functions (gammaFunction.cpp; Numerical-Recipes style series /
# continued fraction, as the reference's f2c-era implementation)
# ----------------------------------------------------------------------

def gamma_ln(x: float) -> float:
    """ln Γ(x) (gammaNaturalLogarithm)."""
    return math.lgamma(x)


def incomplete_gamma(alpha: float, x: float) -> float:
    """Regularised lower incomplete gamma P(alpha, x)
    (gammaFunction.h:33-34; used by the gamma root distribution,
    root.cpp and grapevine.cpp:1259)."""
    if x <= 0.0 or alpha <= 0.0:
        return 0.0
    if x < alpha + 1.0:
        # series expansion
        ap = alpha
        total = term = 1.0 / alpha
        for _ in range(200):
            ap += 1.0
            term *= x / ap
            total += term
            if abs(term) < abs(total) * 1e-12:
                break
        return total * math.exp(-x + alpha * math.log(x) - math.lgamma(alpha))
    # continued fraction for Q, P = 1 - Q
    b = x + 1.0 - alpha
    c = 1e300
    d = 1.0 / b
    h = d
    for i in range(1, 200):
        an = -i * (i - alpha)
        b += 2.0
        d = an * d + b
        d = 1.0 / d if abs(d) > 1e-300 else 1e300
        c = b + an / c if abs(c) > 1e-300 else 1e300
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-12:
            break
    q = math.exp(-x + alpha * math.log(x) - math.lgamma(alpha)) * h
    return 1.0 - q


def gamma_cdf(x: float, beta: float, gamma_shape: float,
              p_zero: float = 0.0) -> float:
    """Generalised gamma CDF with a point mass at zero
    (generalizedGammaCDF, statistics.h:19-20; the SPI machinery)."""
    if x <= 0:
        return p_zero
    return p_zero + (1.0 - p_zero) * incomplete_gamma(gamma_shape, x / beta)
