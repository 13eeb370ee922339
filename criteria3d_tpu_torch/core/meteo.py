"""Meteo substrate: variable catalogue, station series container, quality
ranges and climate monthly parameters, pure Python and numpy.

The port's own copy of ``criteria3d_tpu/core/meteo.py``, line for line.
Python analogue of agrolib/meteo:

* :class:`MeteoVariable` — the meteoVariable enum (meteo.h:91-113) restricted
  to the variables the 3-D model consumes, with the hourly/daily DB ids from
  the reference's ``variable_properties`` table (template_meteo.db);
* :class:`MeteoStation` — Crit3DMeteoPoint (meteoPoint.h): station metadata +
  hourly/daily series on a regular time axis;
* :class:`QualityRange` / :data:`QUALITY_RANGES` — Crit3DQuality gross limits
  (quality.cpp:41-66);
* :class:`ClimateParameters` — Crit3DClimateParameters monthly normals +
  lapse rates (meteo.h:315-334), parsed from the [climate] ini group.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["MeteoVariable", "HOURLY_DB_IDS", "DAILY_DB_IDS", "QualityRange",
           "QUALITY_RANGES", "MeteoStation", "ClimateParameters",
           "variable_from_db_id"]


class MeteoVariable(enum.Enum):
    """Model-facing meteo variables (meteoVariable, meteo.h:91-113)."""

    AIR_TEMPERATURE = "airTemperature"
    PRECIPITATION = "precipitation"
    AIR_REL_HUMIDITY = "airRelHumidity"
    AIR_DEW_TEMPERATURE = "airDewTemperature"
    GLOBAL_IRRADIANCE = "globalIrradiance"
    NET_IRRADIANCE = "netIrradiance"
    DIRECT_IRRADIANCE = "directIrradiance"
    DIFFUSE_IRRADIANCE = "diffuseIrradiance"
    REFLECTED_IRRADIANCE = "reflectedIrradiance"
    ATM_TRANSMISSIVITY = "atmTransmissivity"
    ATM_PRESSURE = "atmPressure"
    WIND_SCALAR_INTENSITY = "windScalarIntensity"
    WIND_VECTOR_INTENSITY = "windVectorIntensity"
    WIND_VECTOR_DIRECTION = "windVectorDirection"
    WIND_VECTOR_X = "windVectorX"
    WIND_VECTOR_Y = "windVectorY"
    LEAF_WETNESS = "leafWetness"
    REFERENCE_ET = "referenceEvapotranspiration"
    ACTUAL_EVAPORATION = "actualEvaporation"
    THOM = "thom"
    # daily
    DAILY_TMIN = "dailyAirTemperatureMin"
    DAILY_TMAX = "dailyAirTemperatureMax"
    DAILY_TAVG = "dailyAirTemperatureAvg"
    DAILY_TRANGE = "dailyAirTemperatureRange"
    DAILY_PREC = "dailyPrecipitation"
    DAILY_RHMIN = "dailyAirRelHumidityMin"
    DAILY_RHMAX = "dailyAirRelHumidityMax"
    DAILY_RHAVG = "dailyAirRelHumidityAvg"
    DAILY_RAD = "dailyGlobalRadiation"
    DAILY_DIRECT_RAD = "dailyDirectRadiation"
    DAILY_DIFFUSE_RAD = "dailyDiffuseRadiation"
    DAILY_REFLECTED_RAD = "dailyReflectedRadiation"
    DAILY_WIND_SCALAR_AVG = "dailyWindScalarIntensityAvg"
    DAILY_WIND_SCALAR_MAX = "dailyWindScalarIntensityMax"
    DAILY_WIND_VECTOR_AVG = "dailyWindVectorIntensityAvg"
    DAILY_WIND_VECTOR_MAX = "dailyWindVectorIntensityMax"
    DAILY_WIND_VECTOR_DIR_PREVAILING = "dailyWindVectorDirectionPrevailing"
    DAILY_LEAF_WETNESS = "dailyLeafWetness"
    DAILY_ET0_HS = "dailyReferenceEvapotranspirationHS"
    DAILY_ET0_PM = "dailyReferenceEvapotranspirationPM"
    DAILY_BIC = "dailyBIC"
    DAILY_HEATING_DD = "dailyHeatingDegreeDays"
    DAILY_COOLING_DD = "dailyCoolingDegreeDays"
    DAILY_THOM_MAX = "dailyThomMax"
    DAILY_THOM_AVG = "dailyThomAvg"
    DAILY_THOM_HOURS_ABOVE = "dailyThomHoursAbove"
    DAILY_THOM_DAYTIME = "dailyThomDaytime"
    DAILY_THOM_NIGHTTIME = "dailyThomNighttime"
    DAILY_TEMP_HOURS_ABOVE = "dailyTemperatureHoursAbove"
    DAILY_WATER_TABLE_DEPTH = "dailyWaterTableDepth"
    # monthly (meteo.h:91-103 monthly family)
    MONTHLY_TMIN = "monthlyAirTemperatureMin"
    MONTHLY_TMAX = "monthlyAirTemperatureMax"
    MONTHLY_TAVG = "monthlyAirTemperatureAvg"
    MONTHLY_PREC = "monthlyPrecipitation"
    MONTHLY_RAD = "monthlyGlobalRadiation"
    MONTHLY_ET0_HS = "monthlyReferenceEvapotranspirationHS"
    MONTHLY_BIC = "monthlyBIC"
    # snow / surface energy family (meteo.h:103-105)
    SNOW_WATER_EQUIVALENT = "snowWaterEquivalent"
    SNOW_FALL = "snowFall"
    SNOW_MELT = "snowMelt"
    SNOW_VARIATION = "snowVariation"
    SNOW_SURFACE_TEMPERATURE = "snowSurfaceTemperature"
    SNOW_INTERNAL_ENERGY = "snowInternalEnergy"
    SNOW_SURFACE_ENERGY = "snowSurfaceEnergy"
    SNOW_AGE = "snowAge"
    SNOW_LIQUID_WATER_CONTENT = "snowLiquidWaterContent"
    SENSIBLE_HEAT = "sensibleHeat"
    LATENT_HEAT = "latentHeat"
    LEAF_AREA_INDEX = "leafAreaIndex"


# daily -> monthly variable family (updateMeteoVariable, meteo.cpp monthly
# branch); aggregation rule per computeMonthlyAggregate
# (meteoPoint.cpp:1338-1404): temperatures average, water/energy totals sum
DAILY_TO_MONTHLY = {
    MeteoVariable.DAILY_TMIN: MeteoVariable.MONTHLY_TMIN,
    MeteoVariable.DAILY_TMAX: MeteoVariable.MONTHLY_TMAX,
    MeteoVariable.DAILY_TAVG: MeteoVariable.MONTHLY_TAVG,
    MeteoVariable.DAILY_PREC: MeteoVariable.MONTHLY_PREC,
    MeteoVariable.DAILY_RAD: MeteoVariable.MONTHLY_RAD,
    MeteoVariable.DAILY_ET0_HS: MeteoVariable.MONTHLY_ET0_HS,
    MeteoVariable.DAILY_BIC: MeteoVariable.MONTHLY_BIC,
}
MONTHLY_SUM_VARS = frozenset({
    MeteoVariable.MONTHLY_PREC, MeteoVariable.MONTHLY_RAD,
    MeteoVariable.MONTHLY_ET0_HS, MeteoVariable.MONTHLY_BIC,
})


# DB ids of the reference's variable_properties table (template_meteo.db;
# getIdfromMeteoVar, dbMeteoPointsHandler.cpp:1353).
HOURLY_DB_IDS = {
    MeteoVariable.AIR_TEMPERATURE: 101,
    MeteoVariable.PRECIPITATION: 102,
    MeteoVariable.AIR_REL_HUMIDITY: 103,
    MeteoVariable.GLOBAL_IRRADIANCE: 104,
    MeteoVariable.WIND_SCALAR_INTENSITY: 105,
    MeteoVariable.WIND_VECTOR_DIRECTION: 106,
    MeteoVariable.LEAF_WETNESS: 108,
    MeteoVariable.REFERENCE_ET: 109,
}

DAILY_DB_IDS = {
    MeteoVariable.DAILY_TMIN: 151,
    MeteoVariable.DAILY_TMAX: 152,
    MeteoVariable.DAILY_TAVG: 153,
    MeteoVariable.DAILY_PREC: 154,
    MeteoVariable.DAILY_RHMIN: 155,
    MeteoVariable.DAILY_RHMAX: 156,
    MeteoVariable.DAILY_RHAVG: 157,
    MeteoVariable.DAILY_RAD: 158,
    MeteoVariable.DAILY_WIND_SCALAR_AVG: 159,
    MeteoVariable.DAILY_ET0_HS: 170,
    MeteoVariable.DAILY_ET0_PM: 171,
    MeteoVariable.DAILY_WATER_TABLE_DEPTH: 172,
}

_ID_TO_VAR = {**{v: k for k, v in HOURLY_DB_IDS.items()},
              **{v: k for k, v in DAILY_DB_IDS.items()}}


def variable_from_db_id(id_variable: int) -> MeteoVariable | None:
    return _ID_TO_VAR.get(int(id_variable))


@dataclasses.dataclass(frozen=True)
class QualityRange:
    """Gross physical plausibility range (quality::Range, quality.h:17-38)."""

    vmin: float
    vmax: float

    def check(self, values):
        """NODATA-out values outside the range (syntacticQualitySingleValue,
        quality.cpp:231-268)."""
        v = np.asarray(values, dtype=np.float64)
        ok = (v >= self.vmin) & (v <= self.vmax) & (v != NODATA)
        return np.where(ok, v, NODATA), ok


# Crit3DQuality constructor defaults (quality.cpp:41-66)
QUALITY_RANGES = {
    MeteoVariable.AIR_TEMPERATURE: QualityRange(-60, 60),
    MeteoVariable.AIR_DEW_TEMPERATURE: QualityRange(-60, 50),
    MeteoVariable.PRECIPITATION: QualityRange(0, 300),
    MeteoVariable.AIR_REL_HUMIDITY: QualityRange(1, 104),
    MeteoVariable.WIND_SCALAR_INTENSITY: QualityRange(0, 150),
    MeteoVariable.WIND_VECTOR_DIRECTION: QualityRange(0, 360),
    MeteoVariable.GLOBAL_IRRADIANCE: QualityRange(-20, 1353),
    MeteoVariable.ATM_TRANSMISSIVITY: QualityRange(0, 1),
    MeteoVariable.REFERENCE_ET: QualityRange(0, 5),
    MeteoVariable.LEAF_WETNESS: QualityRange(0, 1),
    MeteoVariable.DAILY_TMIN: QualityRange(-60, 60),
    MeteoVariable.DAILY_TMAX: QualityRange(-60, 60),
    MeteoVariable.DAILY_TAVG: QualityRange(-60, 60),
    MeteoVariable.DAILY_PREC: QualityRange(0, 999),
    MeteoVariable.DAILY_RHMIN: QualityRange(1, 104),
    MeteoVariable.DAILY_RHMAX: QualityRange(1, 104),
    MeteoVariable.DAILY_RHAVG: QualityRange(1, 104),
    MeteoVariable.DAILY_RAD: QualityRange(-20, 120),
    MeteoVariable.DAILY_WIND_SCALAR_AVG: QualityRange(0, 150),
    MeteoVariable.DAILY_WIND_SCALAR_MAX: QualityRange(0, 150),
    MeteoVariable.DAILY_WIND_VECTOR_AVG: QualityRange(0, 150),
    MeteoVariable.DAILY_WIND_VECTOR_MAX: QualityRange(0, 150),
    MeteoVariable.DAILY_WIND_VECTOR_DIR_PREVAILING: QualityRange(0, 360),
    MeteoVariable.DAILY_ET0_HS: QualityRange(0, 20),
    MeteoVariable.DAILY_ET0_PM: QualityRange(0, 20),
    # qualityDailyBIC (quality.cpp:62)
    MeteoVariable.DAILY_BIC: QualityRange(-20, 999),
    # the daily-T family shares the T range (getQualityRange quality.cpp)
    MeteoVariable.DAILY_TRANGE: QualityRange(0, 120),
    MeteoVariable.MONTHLY_TMIN: QualityRange(-60, 60),
    MeteoVariable.MONTHLY_TMAX: QualityRange(-60, 60),
    MeteoVariable.MONTHLY_TAVG: QualityRange(-60, 60),
    MeteoVariable.MONTHLY_PREC: QualityRange(0, 3000),
    MeteoVariable.WIND_VECTOR_INTENSITY: QualityRange(0, 150),
}


@dataclasses.dataclass
class MeteoStation:
    """One observation station with series on regular time axes.

    Mirrors Crit3DMeteoPoint (agrolib/meteo/meteoPoint.h): identity +
    location + an hourly block ``hourly[var]`` aligned to ``hourly_t0``
    (one value per hour) and a daily block aligned to ``daily_d0``.
    """

    id: str
    name: str
    latitude: float
    longitude: float
    utm_x: float
    utm_y: float
    altitude: float
    is_active: bool = True
    lapse_rate_code: str = "primary"
    hourly_t0: datetime.datetime | None = None
    hourly: dict = dataclasses.field(default_factory=dict)   # var -> np[N]
    daily_d0: datetime.date | None = None
    daily: dict = dataclasses.field(default_factory=dict)    # var -> np[N]
    monthly_m0: tuple | None = None          # (year, month) of first entry
    monthly: dict = dataclasses.field(default_factory=dict)  # var -> np[N]

    def hourly_value(self, var: MeteoVariable,
                     when: datetime.datetime) -> float:
        """Observation at an exact hour; NODATA when absent
        (getMeteoPointValueH analogue)."""
        series = self.hourly.get(var)
        if series is None or self.hourly_t0 is None:
            return NODATA
        idx = int((when - self.hourly_t0).total_seconds() // 3600)
        if 0 <= idx < len(series):
            v = float(series[idx])
            return v if np.isfinite(v) else NODATA
        return NODATA

    def daily_value(self, var: MeteoVariable, day: datetime.date) -> float:
        series = self.daily.get(var)
        if series is None or self.daily_d0 is None:
            return NODATA
        idx = (day - self.daily_d0).days
        if 0 <= idx < len(series):
            v = float(series[idx])
            return v if np.isfinite(v) else NODATA
        return NODATA

    def set_hourly(self, var: MeteoVariable, t0: datetime.datetime,
                   values: np.ndarray) -> None:
        if self.hourly_t0 is None:
            self.hourly_t0 = t0
        elif t0 != self.hourly_t0:
            raise ValueError("all hourly series must share one time origin")
        self.hourly[var] = np.asarray(values, dtype=np.float64)

    @property
    def hourly_span(self) -> tuple | None:
        if self.hourly_t0 is None or not self.hourly:
            return None
        n = max(len(v) for v in self.hourly.values())
        return (self.hourly_t0,
                self.hourly_t0 + datetime.timedelta(hours=n - 1))

    # ---- monthly series (obsDataM analogue; meteoPoint.h monthly block)
    def monthly_value(self, var: MeteoVariable, year: int,
                      month: int) -> float:
        series = self.monthly.get(var)
        if series is None or self.monthly_m0 is None:
            return NODATA
        y0, m0 = self.monthly_m0
        idx = (year - y0) * 12 + (month - m0)
        if 0 <= idx < len(series):
            v = float(series[idx])
            return v if np.isfinite(v) else NODATA
        return NODATA

    def compute_monthly_aggregate(self, daily_var: MeteoVariable,
                                  min_percentage: float = 80.0) -> bool:
        """Aggregate a daily series into the monthly family
        (computeMonthlyAggregate, meteoPoint.cpp:1338-1404): temperature
        variables average over the valid days, water/energy totals
        (prec, ET0, radiation, BIC) sum; months below ``min_percentage``
        daily coverage become NODATA."""
        monthly_var = DAILY_TO_MONTHLY.get(daily_var)
        series = self.daily.get(daily_var)
        if monthly_var is None or series is None or self.daily_d0 is None:
            return False
        qr = QUALITY_RANGES.get(daily_var)
        import calendar
        d0 = self.daily_d0
        out = []
        day = d0
        i = 0
        cur = (d0.year, d0.month)
        vals = []
        n_days = calendar.monthrange(*cur)[1]
        ok_any = False
        while i < len(series):
            v = float(series[i])
            good = np.isfinite(v) and v != NODATA
            if good and qr is not None:
                good = qr.vmin <= v <= qr.vmax
            if good:
                vals.append(v)
            nxt = day + datetime.timedelta(days=1)
            if (nxt.year, nxt.month) != cur or i == len(series) - 1:
                if len(vals) / n_days * 100.0 >= min_percentage and vals:
                    ok_any = True
                    if monthly_var in MONTHLY_SUM_VARS:
                        out.append(sum(vals))
                    else:
                        out.append(sum(vals) / len(vals))
                else:
                    out.append(NODATA)
                vals = []
                cur = (nxt.year, nxt.month)
                n_days = calendar.monthrange(*cur)[1]
            day = nxt
            i += 1
        if self.monthly_m0 is None:
            self.monthly_m0 = (d0.year, d0.month)
        self.monthly[monthly_var] = np.asarray(out, dtype=np.float64)
        return ok_any


@dataclasses.dataclass
class ClimateParameters:
    """Monthly climate normals + lapse rates (Crit3DClimateParameters,
    meteo.h:315-334; [climate] group of parameters.ini).

    Each entry is a 12-value list (January..December).
    """

    tmin: list | None = None
    tmax: list | None = None
    tdmin: list | None = None
    tdmax: list | None = None
    tmin_lapserate: list | None = None
    tmax_lapserate: list | None = None
    tdmin_lapserate: list | None = None
    tdmax_lapserate: list | None = None

    @staticmethod
    def from_ini_dict(climate: dict) -> "ClimateParameters":
        get = lambda k: list(climate[k]) if k in climate else None
        return ClimateParameters(
            tmin=get("tmin"), tmax=get("tmax"),
            tdmin=get("tdmin"), tdmax=get("tdmax"),
            tmin_lapserate=get("tmin_lapserate"),
            tmax_lapserate=get("tmax_lapserate"),
            tdmin_lapserate=get("tdmin_lapserate"),
            tdmax_lapserate=get("tdmax_lapserate"))

    def _interp_monthly(self, series: list | None, month: int,
                        day: int = 15) -> float:
        """Mid-month anchored linear interpolation
        (getClimateLapseRate, meteo.cpp; Crit3DTime overload)."""
        if not series:
            return NODATA
        m0 = month - 1
        if day >= 15:
            m1, frac = (m0 + 1) % 12, (day - 15) / 30.0
        else:
            m1, frac = m0, 0.0
            m0, frac = (m0 - 1) % 12, (day + 15) / 30.0
        return float(series[m0] * (1 - frac) + series[m1] * frac)

    def lapse_rate(self, var: MeteoVariable, month: int, day: int = 15,
                   hour: int = 12) -> float:
        """Climate lapse rate [degC m-1] for a temperature-like variable;
        hourly air temperature blends the tmin/tmax rates by time of day
        (getClimateLapseRate, meteo.cpp:120-170)."""
        if var in (MeteoVariable.DAILY_TMIN,):
            return self._interp_monthly(self.tmin_lapserate, month, day)
        if var in (MeteoVariable.DAILY_TMAX,):
            return self._interp_monthly(self.tmax_lapserate, month, day)
        if var in (MeteoVariable.AIR_TEMPERATURE, MeteoVariable.DAILY_TAVG):
            lo = self._interp_monthly(self.tmin_lapserate, month, day)
            hi = self._interp_monthly(self.tmax_lapserate, month, day)
            if lo == NODATA or hi == NODATA:
                return NODATA
            # night hours lean on the tmin rate, afternoon on the tmax rate
            w = max(0.0, min(1.0, 1.0 - abs(hour - 14) / 12.0))
            return lo * (1 - w) + hi * w
        if var == MeteoVariable.AIR_DEW_TEMPERATURE:
            lo = self._interp_monthly(self.tdmin_lapserate, month, day)
            hi = self._interp_monthly(self.tdmax_lapserate, month, day)
            if lo == NODATA or hi == NODATA:
                return NODATA
            return 0.5 * (lo + hi)
        return NODATA

    def climate_var(self, var: MeteoVariable, month: int, height: float,
                    ref_height: float = 300.0) -> float:
        """Monthly climate normal lapse-adjusted to ``height``
        (getClimateVar, meteo.cpp:243-270; DEF_VALUE_REF_HEIGHT 300 m,
        quality.h:13)."""
        series = {MeteoVariable.DAILY_TMIN: self.tmin,
                  MeteoVariable.DAILY_TMAX: self.tmax,
                  MeteoVariable.DAILY_RHMIN: self.tdmin,
                  MeteoVariable.DAILY_RHMAX: self.tdmax}.get(var)
        if not series:
            return NODATA
        value = float(series[month - 1])
        if value != NODATA and height != NODATA:
            rate = {MeteoVariable.DAILY_TMIN: self.tmin_lapserate,
                    MeteoVariable.DAILY_TMAX: self.tmax_lapserate,
                    MeteoVariable.DAILY_RHMIN: self.tdmin_lapserate,
                    MeteoVariable.DAILY_RHMAX: self.tdmax_lapserate}[var]
            if rate:
                value += float(rate[month - 1]) * (height - ref_height)
        return value


# hourly climate-consistency ranges relative to the monthly normals
# (Crit3DQuality ctor, quality.cpp:43-44)
_QUALITY_HOURLY_T = (-60.0, 60.0)
_QUALITY_HOURLY_TD = (-60.0, 50.0)


def check_fast_value_hourly(var: MeteoVariable,
                            climate: "ClimateParameters | None",
                            value: float, month: int, height: float) -> bool:
    """Climate-based plausibility of one hourly value: True = accepted.

    Reference: Crit3DQuality::checkFastValueHourly_SingleValue /
    wrongValueHourly_SingleValue (quality.cpp:272-330): air temperature
    must lie within the hourly consistency range anchored on the monthly
    Tmin/Tmax normals lapse-adjusted to the station height; dew point
    likewise on the Td normals; other variables fall back to the plain
    quality range.
    """
    if value == NODATA:
        return False
    if climate is not None and var == MeteoVariable.AIR_TEMPERATURE:
        tmin_c = climate.climate_var(MeteoVariable.DAILY_TMIN, month, height)
        tmax_c = climate.climate_var(MeteoVariable.DAILY_TMAX, month, height)
        if tmin_c != NODATA and tmax_c != NODATA:
            return (_QUALITY_HOURLY_T[0] + tmin_c <= value
                    <= _QUALITY_HOURLY_T[1] + tmax_c)
    if climate is not None and var == MeteoVariable.AIR_DEW_TEMPERATURE:
        td_min = climate.climate_var(MeteoVariable.DAILY_RHMIN, month, height)
        td_max = climate.climate_var(MeteoVariable.DAILY_RHMAX, month, height)
        if td_min != NODATA and td_max != NODATA:
            return (_QUALITY_HOURLY_TD[0] + td_min <= value
                    <= _QUALITY_HOURLY_TD[1] + td_max)
    rng = QUALITY_RANGES.get(var)
    if rng is not None:
        return rng.vmin <= value <= rng.vmax
    return True
