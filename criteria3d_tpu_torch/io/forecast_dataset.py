"""Forecast dataset import (the agrolib/importDataset analogue).

The port's own copy of ``criteria3d_tpu/io/forecast_dataset.py``, line for line (host
numpy and the standard library).

Parses the reference's forecast CSV exchange format
(ForecastDataset::importForecastData, importDataset/forecastDataset.cpp:30-78):

    lat, lon, z, var, year, month, day, hour, value

into per-date / per-point / per-variable hourly arrays, reproducing the
hour-0 rollover quirk (an hour-0 record also becomes hour 24 of the previous
day when that day exists). The nested QList structures become a flat dict
keyed by (date, (lat, lon, z)) with {var: np.ndarray[25]} hourly blocks.
"""

from __future__ import annotations

import datetime

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["ForecastDataset"]


class ForecastDataset:
    """In-memory forecast container (importDataset's class triplet
    ForecastDataset / DailyDataset / PointDataset collapsed)."""

    def __init__(self):
        # {date: {(lat, lon, z): {var: np.ndarray[25] (hours 0..24)}}}
        self.days: dict = {}

    # ------------------------------------------------------------------
    def add_value(self, lat: float, lon: float, z: float, var: str,
                  date: datetime.date, hour: int, value: float) -> None:
        """addDatasetValue (forecastDataset.cpp:80+)."""
        point = (round(lat, 6), round(lon, 6), round(z, 2))
        day = self.days.setdefault(date, {})
        series = day.setdefault(point, {})
        arr = series.setdefault(var, np.full(25, NODATA))
        if 0 <= hour <= 24:
            arr[hour] = value

    def import_file(self, path: str) -> int:
        """importForecastData: returns the number of records read."""
        n = 0
        first_date = None
        with open(path) as f:
            for line in f:
                fields = [s.strip() for s in line.split(",")]
                if len(fields) < 9 or not fields[0]:
                    continue
                try:
                    lat, lon, z = (float(fields[0]), float(fields[1]),
                                   float(fields[2]))
                    var = fields[3]
                    date = datetime.date(int(fields[4]), int(fields[5]),
                                         int(fields[6]))
                    hour = int(fields[7])
                    value = float(fields[8])
                except ValueError:
                    continue
                if first_date is None or date < first_date:
                    first_date = first_date or date
                self.add_value(lat, lon, z, var, date, hour, value)
                # hour-0 rollover: also hour 24 of the previous day
                # (forecastDataset.cpp:47-51)
                if hour == 0 and first_date is not None and date > first_date:
                    self.add_value(lat, lon, z, var,
                                   date - datetime.timedelta(days=1), 24,
                                   value)
                n += 1
        return n

    # ------------------------------------------------------------------
    def dates(self) -> list:
        return sorted(self.days)

    def points(self, date: datetime.date) -> list:
        return sorted(self.days.get(date, {}))

    def point_index(self, date: datetime.date, lat: float, lon: float,
                    z: float) -> int:
        """DailyDataset::getPointIndex."""
        pts = self.points(date)
        key = (round(lat, 6), round(lon, 6), round(z, 2))
        return pts.index(key) if key in pts else -1

    def hourly_values(self, date: datetime.date, point: tuple,
                      var: str) -> np.ndarray:
        return self.days.get(date, {}).get(point, {}).get(
            var, np.full(25, NODATA))
