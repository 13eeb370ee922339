"""Time-series and scatter charts — meteoWidget / proxyWidget analogue.

The reference plots observed/computed meteo series in qcustomplot charts
(agrolib/meteoWidget/meteoWidget.cpp) and proxy-vs-value scatters with
the fitted detrending line (agrolib/proxyWidget/proxyWidget.cpp).  Same
capability headlessly: numeric or datetime x-axis, "nice" tick steps,
grid, multi-series legend, optional linear-fit line.
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from criteria3d_tpu_torch.viz.canvas import Canvas, text_size

__all__ = ["line_chart", "scatter_chart", "SERIES_COLORS"]

# categorical series palette (distinct at 1-px line width on white)
SERIES_COLORS = [
    (31, 119, 180), (214, 39, 40), (44, 160, 44), (148, 103, 189),
    (255, 127, 14), (140, 86, 75), (23, 190, 207), (127, 127, 127),
]

_MARGIN_L, _MARGIN_R, _MARGIN_T, _MARGIN_B = 58, 14, 30, 34


def _nice_ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    span = hi - lo
    if span <= 0:
        return np.array([lo])
    raw = span / n
    mag = 10.0 ** np.floor(np.log10(raw))
    for m in (1.0, 2.0, 5.0, 10.0):
        if raw <= m * mag:
            step = m * mag
            break
    t0 = np.ceil(lo / step) * step
    return np.arange(t0, hi + step * 0.5, step)


_TIME_STEPS = [3600, 2 * 3600, 3 * 3600, 6 * 3600, 12 * 3600, 86400,
               2 * 86400, 5 * 86400, 10 * 86400, 30 * 86400, 90 * 86400,
               365 * 86400, 2 * 365 * 86400, 5 * 365 * 86400,
               10 * 365 * 86400, 20 * 365 * 86400]


def _time_ticks(lo: float, hi: float, n: int = 6) -> np.ndarray:
    span = max(hi - lo, 1.0)
    step = next((s for s in _TIME_STEPS if span / s <= n), _TIME_STEPS[-1])
    t0 = np.ceil(lo / step) * step
    return np.arange(t0, hi + step * 0.5, step)


def _to_float_x(x):
    """Numeric passthrough; datetimes → epoch seconds + date formatter
    + calendar-aligned tick generator."""
    xs = list(x)
    if xs and isinstance(xs[0], (_dt.datetime, _dt.date)):
        def _epoch(v):
            if isinstance(v, _dt.datetime):
                return v.timestamp()
            return _dt.datetime(v.year, v.month, v.day).timestamp()
        vals = np.array([_epoch(v) for v in xs], np.float64)
        span = vals[-1] - vals[0] if len(vals) > 1 else 0.0
        if span > 300 * 86400:
            fmt = lambda s: _dt.datetime.fromtimestamp(s).strftime("%Y-%m")
        elif span > 5 * 86400:
            fmt = lambda s: _dt.datetime.fromtimestamp(s).strftime("%m-%d")
        else:
            fmt = lambda s: _dt.datetime.fromtimestamp(s).strftime("%d %H:%M")
        return vals, fmt, _time_ticks
    return (np.asarray(xs, np.float64), (lambda v: f"{v:.4g}"),
            lambda lo, hi, n=6: _nice_ticks(lo, hi, n))


class _Axes:
    """Shared frame/ticks/grid for both chart kinds."""

    def __init__(self, width, height, xlo, xhi, ylo, yhi, x_fmt,
                 title, xlabel, ylabel, x_ticks=None):
        self.cv = Canvas(width, height)
        self.x0, self.y0 = _MARGIN_L, _MARGIN_T
        self.x1, self.y1 = width - _MARGIN_R, height - _MARGIN_B
        if xhi <= xlo:
            xhi = xlo + 1.0
        if yhi <= ylo:
            yhi = ylo + 1.0
        self.xlo, self.xhi, self.ylo, self.yhi = xlo, xhi, ylo, yhi
        cv = self.cv
        cv.frame_rect(self.x0, self.y0, self.x1 - self.x0,
                      self.y1 - self.y0, (0, 0, 0))
        for ty in _nice_ticks(ylo, yhi):
            py = self.py(ty)
            if self.y0 < py < self.y1:
                cv.fill_rect(self.x0 + 1, py, self.x1 - self.x0 - 2, 1,
                             (225, 225, 225))
            cv.text(self.x0 - 4, py - 3, f"{ty:.4g}", anchor="ne")
        ticks_x = (x_ticks or (lambda lo, hi, n=6: _nice_ticks(lo, hi, n)))
        for tx in ticks_x(self.xlo, self.xhi, 6):
            px = self.px(tx)
            if self.x0 < px < self.x1:
                cv.fill_rect(px, self.y0 + 1, 1, self.y1 - self.y0 - 2,
                             (235, 235, 235))
            cv.text(px, self.y1 + 5, x_fmt(tx), anchor="n")
        if title:
            cv.text(width // 2, 8, title, scale=2 if width >= 560 else 1,
                    anchor="n")
        if ylabel:
            cv.text(6, 8, ylabel)
        if xlabel:
            cv.text(width // 2, self.y1 + 18, xlabel, anchor="n")

    def px(self, v):
        return int(round(self.x0 + (v - self.xlo) / (self.xhi - self.xlo)
                         * (self.x1 - self.x0)))

    def py(self, v):
        return int(round(self.y1 - (v - self.ylo) / (self.yhi - self.ylo)
                         * (self.y1 - self.y0)))

    def legend(self, names):
        x = self.x0 + 8
        for i, name in enumerate(names):
            c = SERIES_COLORS[i % len(SERIES_COLORS)]
            self.cv.fill_rect(x, self.y0 + 6, 12, 3, c)
            self.cv.text(x + 16, self.y0 + 3, name)
            x += 24 + text_size(name)[0]


def _series_dict(series) -> dict:
    if isinstance(series, dict):
        return series
    return {f"S{i + 1}": s for i, s in enumerate(series)}


def line_chart(series, *, title: str = "", xlabel: str = "",
               ylabel: str = "", width: int = 720, height: int = 360,
               legend: bool = True) -> Canvas:
    """Multi-series line chart.

    ``series`` maps name -> (x, y) with numeric or datetime x (all
    series share the axis range; NaNs break the line).
    """
    series = _series_dict(series)
    xs_all, ys_all, fmt = [], [], (lambda v: f"{v:.4g}")
    ticks = None
    parsed = {}
    x_is_time = None
    for name, (x, y) in series.items():
        xv, s_fmt, s_ticks = _to_float_x(x)
        s_is_time = s_ticks is _time_ticks
        if x_is_time is None:
            # axis formatter/ticks come from the FIRST series; every later
            # series must have the same x type or the axis would silently
            # mislabel (e.g. datetimes rendered on a numeric scale)
            x_is_time, fmt, ticks = s_is_time, s_fmt, s_ticks
        elif s_is_time != x_is_time:
            raise ValueError(
                f"line_chart: series {name!r} has "
                f"{'datetime' if s_is_time else 'numeric'} x but earlier "
                f"series use {'datetime' if x_is_time else 'numeric'} x")
        yv = np.asarray(y, np.float64)
        parsed[name] = (xv, yv)
        xs_all.append(xv)
        ys_all.append(yv[np.isfinite(yv)])
    xcat = np.concatenate(xs_all) if xs_all else np.array([0.0])
    ycat = np.concatenate(ys_all) if ys_all else np.array([0.0])
    ycat = ycat if ycat.size else np.array([0.0])
    ax = _Axes(width, height, float(xcat.min()), float(xcat.max()),
               float(ycat.min()), float(ycat.max()), fmt,
               title, xlabel, ylabel, x_ticks=ticks)
    for i, (name, (xv, yv)) in enumerate(parsed.items()):
        c = SERIES_COLORS[i % len(SERIES_COLORS)]
        finite = np.isfinite(yv)
        run_start = None
        for j in range(len(xv) + 1):
            if j < len(xv) and finite[j]:
                if run_start is None:
                    run_start = j
            elif run_start is not None:
                pts = [(ax.px(xv[k]), ax.py(yv[k]))
                       for k in range(run_start, j)]
                if len(pts) == 1:
                    ax.cv.marker(pts[0][0], pts[0][1], c, size=3)
                else:
                    ax.cv.polyline(pts, c, width=1)
                run_start = None
    if legend and len(parsed) > 1:
        ax.legend(list(parsed))
    return ax.cv


def scatter_chart(x, y, *, fit: bool = True, title: str = "",
                  xlabel: str = "", ylabel: str = "", width: int = 560,
                  height: int = 420, color=(31, 119, 180)) -> Canvas:
    """Scatter with optional least-squares line (proxyWidget's
    proxy-vs-value view with the fitted lapse, proxyWidget.cpp)."""
    xv, fmt, ticks = _to_float_x(x)
    yv = np.asarray(y, np.float64)
    ok = np.isfinite(xv) & np.isfinite(yv)
    xv, yv = xv[ok], yv[ok]
    if xv.size == 0:
        xv = yv = np.array([0.0])
    ax = _Axes(width, height, float(xv.min()), float(xv.max()),
               float(yv.min()), float(yv.max()), fmt, title, xlabel, ylabel,
               x_ticks=ticks)
    for xi, yi in zip(xv, yv):
        ax.cv.marker(ax.px(xi), ax.py(yi), color, size=4)
    if fit and xv.size >= 2 and float(np.ptp(xv)) > 0:
        slope, icpt = np.polyfit(xv, yv, 1)
        xx = np.array([float(xv.min()), float(xv.max())])
        ax.cv.line(ax.px(xx[0]), ax.py(icpt + slope * xx[0]),
                   ax.px(xx[1]), ax.py(icpt + slope * xx[1]),
                   (214, 39, 40), width=2)
        ax.cv.text(ax.x1 - 4, ax.y0 + 4, f"SLOPE {slope:.4g}", anchor="ne",
                   color=(214, 39, 40))
    return ax.cv
