"""Empirical water-table depth estimation from climatic water balance.

The port's own copy of ``criteria3d_tpu/physics/watertable.py``, line for
line (host numpy), re-implementing agrolib/waterTable (Crit3DWaterTable):
depth to the water table is regressed against a time-weighted climatic
water balance (CWB = precipitation - ET0) accumulated over an optimised
antecedent window, calibrated against well observations.

Used as the crop lower boundary condition in CRITERIA-1D/3D
(waterTable.h:20-58). Everything here is small-data (per-well series), so
the implementation is plain numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["WaterTableModel", "weighted_cwb", "Well",
           "load_well_locations_csv", "load_well_depths_csv"]


def weighted_cwb(prec: np.ndarray, et0: np.ndarray, index: int, nr_days: int,
                 avg_daily_cwb: float) -> float:
    """Time-weighted antecedent climatic water balance anomaly [cm].

    Mirrors WaterTable::computeCWB (waterTable.cpp:318-352): daily
    (prec - ET0) weighted by 1 - (shift-1)/nrDays over the nr_days before
    ``index``, minus half the climatological CWB of the window.
    """
    lo = index - nr_days
    shifts = np.arange(1, nr_days + 1)
    idx = index - shifts
    ok = idx >= 0
    if ok.sum() < nr_days * 0.8:
        return NODATA
    cwb = (prec[idx[ok]] - et0[idx[ok]])
    weight = 1.0 - (shifts[ok] - 1) / nr_days
    sum_cwb = float(np.sum(cwb * weight))
    climate = avg_daily_cwb * nr_days * 0.5
    return (sum_cwb - climate) * 0.1     # [mm] -> [cm]


@dataclasses.dataclass
class WaterTableModel:
    """Calibrated water-table estimator for one well."""

    h0: float = NODATA            # [cm] regression intercept
    alpha: float = NODATA         # [-] regression slope
    nr_days: int = NODATA         # optimal antecedent window
    r2: float = 0.0
    avg_daily_cwb: float = 0.0

    def fit(self, prec: np.ndarray, et0: np.ndarray,
            obs_indices: np.ndarray, obs_depths: np.ndarray,
            step_days: int = 5) -> bool:
        """Calibrate (h0, alpha, nr_days) against well observations.

        Mirrors computeCWBCorrelation (waterTable.cpp:258-310): scan
        antecedent windows 90..730 days, keep the best-R2 linear regression
        of observed depth [cm] on the weighted CWB anomaly.
        """
        prec = np.asarray(prec, float)
        et0 = np.asarray(et0, float)
        valid = (prec != NODATA) & (et0 != NODATA)
        self.avg_daily_cwb = float(np.mean(prec[valid] - et0[valid]))

        best = (0.0, NODATA, NODATA, NODATA)
        for nr_days in range(90, 731, step_days):
            xs, ys = [], []
            for i, d in zip(obs_indices, obs_depths):
                x = weighted_cwb(prec, et0, int(i), nr_days, self.avg_daily_cwb)
                if x != NODATA and d != NODATA:
                    xs.append(x)
                    ys.append(d)
            if len(xs) < 3:
                continue
            xs = np.asarray(xs)
            ys = np.asarray(ys)
            sxx = np.sum((xs - xs.mean()) ** 2)
            if sxx <= 0:
                continue
            slope = np.sum((xs - xs.mean()) * (ys - ys.mean())) / sxx
            intercept = ys.mean() - slope * xs.mean()
            pred = intercept + slope * xs
            ss_res = np.sum((ys - pred) ** 2)
            ss_tot = np.sum((ys - ys.mean()) ** 2)
            r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
            if r2 > best[0]:
                best = (r2, intercept, slope, nr_days)

        self.r2, self.h0, self.alpha, self.nr_days = best
        return self.r2 > 0

    def depth(self, prec: np.ndarray, et0: np.ndarray, index: int) -> float:
        """Estimated water-table depth [cm] at day ``index``
        (getWaterTableDaily, waterTable.cpp:423-441)."""
        if self.nr_days == NODATA:
            return NODATA
        d_cwb = weighted_cwb(np.asarray(prec, float), np.asarray(et0, float),
                             index, int(self.nr_days), self.avg_daily_cwb)
        if d_cwb == NODATA:
            return NODATA
        return max(0.0, self.h0 + self.alpha * d_cwb)


# ----------------------------------------------------------------------
# well import + project-level subsystem (agrolib/waterTable/importData.cpp,
# well.h; Project::waterTableImportLocation/Depths project.cpp:5952-5995)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Well:
    """One observation well (well.h:8-60): location + date->depth [cm]."""

    id: str
    utm_x: float = NODATA
    utm_y: float = NODATA
    latitude: float = NODATA
    longitude: float = NODATA
    depths: dict = dataclasses.field(default_factory=dict)  # date -> cm

    @property
    def first_obs_date(self):
        return min(self.depths) if self.depths else None


def load_well_locations_csv(path: str, *, utm_zone: int | None = None,
                            reference_lat: float = 45.0) -> tuple[list, int]:
    """Parse the well-locations CSV: header [ID, utmX, utmY] or
    [ID, lat, lon] (loadWaterTableLocationCsv, importData.cpp:10-127).

    Returns (wells, wrong_lines); repeated ids and non-numeric coordinate
    lines are counted as wrong, exactly like the reference.
    """
    import csv as _csv

    wells: list[Well] = []
    seen: set[str] = set()
    wrong = 0
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        header = next(reader)
        if len(header) != 3:
            raise ValueError(
                "Wrong data! Required [ID, utmX, utmY] or [ID, lat, lon]")
        is_latlon = header[1].strip().upper() == "LAT"
        for line in reader:
            items = [x for x in (s.strip().strip('"') for s in line) if x]
            if len(items) < 3:
                wrong += 1
                continue
            wid = items[0]
            if wid in seen:
                wrong += 1
                continue
            try:
                v1, v2 = float(items[1]), float(items[2])
            except ValueError:
                wrong += 1
                continue
            seen.add(wid)
            w = Well(id=wid)
            if is_latlon:
                w.latitude, w.longitude = v1, v2
                if utm_zone is not None:
                    from criteria3d_tpu_torch.core.geo import latlon_to_utm
                    x, y, _ = latlon_to_utm(v1, v2, utm_zone)
                    w.utm_x, w.utm_y = float(x), float(y)
            else:
                w.utm_x, w.utm_y = v1, v2
                if utm_zone is not None:
                    from criteria3d_tpu_torch.core.geo import utm_to_latlon
                    lat, lon = utm_to_latlon(utm_zone, reference_lat, v1, v2)
                    w.latitude, w.longitude = float(lat), float(lon)
            wells.append(w)
    if not wells:
        raise ValueError(f"Wrong wells location: {path}")
    return wells, wrong


def load_well_depths_csv(path: str, wells: list, *,
                         max_depth_cm: float = 300.0) -> int:
    """Parse the depth-observations CSV [ID, date yyyy-mm-dd, depth cm]
    into the matching wells (loadWaterTableDepthCsv, importData.cpp:130-230).

    Depths outside [0, max_depth_cm] (waterTableMaximumDepth quality
    parameter) and unknown ids count as wrong lines. Returns wrong_lines.
    """
    import csv as _csv
    import datetime as _dt

    by_id = {w.id: w for w in wells}
    wrong = 0
    valid = 0
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        header = next(reader)
        if len(header) != 3:
            raise ValueError("Wrong data! Required [ID, date, depth].")
        for line in reader:
            items = [x for x in (s.strip().strip('"') for s in line) if x]
            if len(items) < 3:
                wrong += 1
                continue
            w = by_id.get(items[0])
            if w is None:
                wrong += 1
                continue
            try:
                date = _dt.date.fromisoformat(items[1])
                value = float(items[2])
            except ValueError:
                wrong += 1
                continue
            if value == NODATA or value < 0 or value > max_depth_cm:
                wrong += 1
                continue
            w.depths[date] = value
            valid += 1
    if valid == 0:
        raise ValueError(
            f"Wrong water table depth: {path}\n"
            "The separator must be a comma; the date format yyyy-mm-dd.")
    return wrong
