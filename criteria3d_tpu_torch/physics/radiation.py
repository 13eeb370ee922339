"""Solar radiation on a DEM: sun position, clear/real sky, shadowing.

PyTorch counterpart of ``criteria3d_tpu/physics/radiation.py`` (the
reference's r.sun-style agrolib/solarRadiation): the Michalsky/SOLPOS solar
position (solPos.cpp:423-925), the Linke-turbidity clear sky
(solarRadiation.cpp:340-394), the Erbs-Reindl diffuse/global split
(:638-700), the Muneer inclined-surface conversion (:472-540) and DEM
shadowing (:547-617), as whole-map tensor passes.

As in the JAX package the sun's declination, right ascension and sidereal
time are Python ``math`` on float64 host scalars; only the per-cell maps
are tensors. The shadow march's sun direction and integer offsets are host
numbers too, so the march is a loop of whole-map tensor operations with no
device read; :func:`compute_radiation_dem` reads the three map means the
march needs through ``device.host_read``, as the JAX function reads them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import DEG_TO_RAD, NODATA, RAD_TO_DEG
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where
from criteria3d_tpu_torch.physics.meteo import pressure_from_altitude

__all__ = ["sun_position", "clear_sky_beam_horizontal",
           "clear_sky_diffuse_horizontal", "RadiationOutput",
           "compute_radiation_dem", "separate_transmissivity_erbs_reindl",
           "beam_inclined", "diffuse_inclined_muneer", "reflected_irradiance",
           "transmissivity_samani", "transmissivity_from_measured",
           "shadow_map", "RADIATION_RANGE"]

# torch.profiler range of the radiation maps, shadow march included
# (chip_smoke.py reads it)
RADIATION_RANGE = "c3d.radiation"

SOLAR_CONSTANT = 1367.0     # [W m-2]
TEMPERATURE_DEFAULT = 15.0  # [degC]


# ----------------------------------------------------------------------
# Sun position (Michalsky 1988 via NREL SOLPOS; solPos.cpp:423-925)
# ----------------------------------------------------------------------

def _day_of_year(year, month, day):
    """Day of the year; every fourth year is a leap year (``year % 4``
    only, as the JAX package and the reference count)."""
    month_days = np.array([0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334])
    doy = month_days[month - 1] + day
    leap = (year % 4 == 0) and (month > 2)
    return doy + (1 if leap else 0)


def sun_position(lat_deg, lon_deg, timezone, year, month, day,
                 hour, minute=0, second=0, *, temperature=TEMPERATURE_DEFAULT,
                 pressure_hpa=None, aspect_deg=0.0, slope_deg=0.0):
    """Apparent solar position for maps of (lat, lon[, aspect, slope]).

    Returns a dict of tensors: elevation, elevation_refr, azimuth [deg],
    incidence, cos_incidence (tilted surface), air_mass, air_mass_press,
    etr_normal, etr_horizontal [W m-2], sunrise_s / sunset_s [s from local
    midnight]. ``lat_deg`` is a tensor; time arguments are Python scalars
    (local standard time)."""
    lat = lat_deg.to(torch.float64)
    lon = as_f64(lon_deg, lat.device)
    if pressure_hpa is None:
        pressure_hpa = torch.full_like(lat, 1013.0)

    daynum = _day_of_year(year, month, day)
    dayang = 360.0 * (daynum - 1) / 365.0
    sd_, cd_ = math.sin(math.radians(dayang)), math.cos(math.radians(dayang))
    s2, c2 = math.sin(2 * math.radians(dayang)), math.cos(2 * math.radians(dayang))
    erv = 1.000110 + 0.034221 * cd_ + 0.001280 * sd_ + 0.000719 * c2 + 0.000077 * s2

    utime = (hour * 3600.0 + minute * 60.0 + second) / 3600.0 - timezone
    delta = year - 1949
    leap = int(delta / 4.0)
    julday = 32916.5 + delta * 365.0 + leap + daynum + utime / 24.0
    ectime = julday - 51545.0

    mnlong = (280.460 + 0.9856474 * ectime) % 360.0
    mnanom = math.radians((357.528 + 0.9856003 * ectime) % 360.0)
    eclong = math.radians((mnlong + 1.915 * math.sin(mnanom)
                           + 0.020 * math.sin(2.0 * mnanom)) % 360.0)
    ecobli = math.radians(23.439 - 4.0e-07 * ectime)

    declin = math.asin(math.sin(ecobli) * math.sin(eclong))
    rascen = math.degrees(math.atan2(math.cos(ecobli) * math.sin(eclong),
                                     math.cos(eclong))) % 360.0

    gmst = (6.697375 + 0.0657098242 * ectime + utime) % 24.0
    lmst = torch.remainder(gmst * 15.0 + lon, 360.0)
    hrang = lmst - rascen
    hrang = torch.where(hrang < -180.0, hrang + 360.0,
                        torch.where(hrang > 180.0, hrang - 360.0, hrang))

    # zenith (zen_no_ref)
    sl = torch.sin(lat * DEG_TO_RAD)
    cl = torch.cos(lat * DEG_TO_RAD)
    sd = math.sin(declin)
    cd = math.cos(declin)
    ch = torch.cos(hrang * DEG_TO_RAD)
    cz = torch.clamp(sd * sl + cd * cl * ch, -1.0, 1.0)
    zenetr = torch.clamp_max(torch.arccos(cz) * RAD_TO_DEG, 99.0)
    elevetr = 90.0 - zenetr

    # sunset hour angle + sunrise/sunset (ssha + srss + tst)
    cdcl = cd * cl
    wide = torch.abs(cdcl) >= 0.001
    cssha = where(wide, -sl * sd / where(wide, cdcl, 1.0), 0.0)
    ssha = torch.where(wide,
                       torch.arccos(torch.clamp(cssha, -1.0, 1.0)) * RAD_TO_DEG,
                       where((lat > 0) == (declin >= 0), 180.0, 0.0))
    tst = (180.0 + hrang) * 4.0
    tstfix = tst - hour * 60.0 - minute - second / 60.0
    tstfix = torch.remainder(tstfix + 720.0, 1440.0) - 720.0
    sretr = where(ssha <= 1.0, 2999.0,
                  where(ssha >= 179.0, -2999.0, 720.0 - 4.0 * ssha - tstfix))
    ssetr = where(ssha <= 1.0, -2999.0,
                  where(ssha >= 179.0, 2999.0, 720.0 + 4.0 * ssha - tstfix))

    # azimuth (sazm)
    ce = torch.cos(elevetr * DEG_TO_RAD)
    se = torch.sin(elevetr * DEG_TO_RAD)
    cecl = ce * cl
    wide_e = torch.abs(cecl) >= 0.001
    ca = torch.clamp((se * sl - sd) / where(wide_e, cecl, 1.0), -1.0, 1.0)
    azim = where(wide_e, 180.0 - torch.arccos(ca) * RAD_TO_DEG, 180.0)
    azim = torch.where(wide_e & (hrang > 0), 360.0 - azim, azim)

    # refraction (refrac)
    tanelev = torch.tan(torch.clamp(elevetr, -9.0, 85.0) * DEG_TO_RAD)
    tanelev = where(torch.abs(tanelev) < 1e-9, 1e-9, tanelev)
    refcor_hi = rdiv(58.1, tanelev) - rdiv(0.07, ipow(tanelev, 3)) \
        + rdiv(0.000086, ipow(tanelev, 5))
    refcor_mid = 1735.0 + elevetr * (-518.2 + elevetr * (103.4 + elevetr
                                     * (-12.79 + elevetr * 0.711)))
    refcor_lo = rdiv(-20.774, tanelev)
    refcor = where(elevetr > 85.0, 0.0,
                   torch.where(elevetr >= 5.0, refcor_hi,
                               torch.where(elevetr >= -0.575, refcor_mid,
                                           refcor_lo)))
    if isinstance(temperature, torch.Tensor):
        prestemp = (pressure_hpa * 283.0) / (1013.0 * (273.0 + temperature))
    else:
        prestemp = div(pressure_hpa * 283.0, 1013.0 * (273.0 + temperature))
    elevref = torch.clamp_min(elevetr + div(refcor * prestemp, 3600.0), -9.0)
    zenref = 90.0 - elevref
    coszen = torch.cos(zenref * DEG_TO_RAD)

    # air mass (amass, Kasten & Young 1989)
    amass = where(
        zenref > 93.0, -1.0,
        rdiv(1.0, torch.cos(zenref * DEG_TO_RAD)
             + 0.50572 * power(torch.clamp_min(96.07995 - zenref, 1e-6),
                               -1.6364)))
    ampress = where(zenref > 93.0, -1.0, div(amass * pressure_hpa, 1013.0))

    # extraterrestrial irradiance (etr)
    etrn = where(coszen > 0, SOLAR_CONSTANT * erv, 0.0)
    etr_h = where(coszen > 0, etrn * coszen, 0.0)

    # tilted-surface incidence (tilt): aspect/slope maps
    aspect = as_f64(aspect_deg, lat.device)
    slope = as_f64(slope_deg, lat.device)
    sz = torch.sin(zenref * DEG_TO_RAD)
    cosinc = (coszen * torch.cos(slope * DEG_TO_RAD)
              + sz * torch.sin(slope * DEG_TO_RAD)
              * (torch.cos(azim * DEG_TO_RAD) * torch.cos(aspect * DEG_TO_RAD)
                 + torch.sin(azim * DEG_TO_RAD) * torch.sin(aspect * DEG_TO_RAD)))
    # reference converts to an incidence angle >= 0 (solarRadiation.cpp:1126)
    incidence = torch.clamp_min(
        RAD_TO_DEG * (math.pi / 2.0
                      - torch.arccos(torch.clamp(cosinc, -1, 1))), 0.0)

    return dict(elevation=elevetr, elevation_refr=elevref, azimuth=azim,
                incidence=incidence, cos_incidence=cosinc,
                air_mass=amass, air_mass_press=ampress,
                etr_normal=etrn, etr_horizontal=etr_h,
                sunrise_s=sretr * 60.0, sunset_s=ssetr * 60.0)


# ----------------------------------------------------------------------
# Clear sky (Linke) and transmissivity separation
# ----------------------------------------------------------------------

def clear_sky_beam_horizontal(linke: float, sun):
    """[W m-2] ESRA clear-sky beam (solarRadiation.cpp:340-357); ``linke``
    a Python number."""
    m = torch.clamp_min(sun["air_mass_press"], 0.0)
    rayleigh = torch.where(
        m <= 20,
        rdiv(1.0, 6.6296 + 1.7513 * m - 0.1202 * sq(m) + 0.0065 * ipow(m, 3)
             - 0.00013 * ipow(m, 4)),
        rdiv(1.0, 10.4 + 0.718 * m))
    return (sun["etr_normal"] * torch.sin(sun["elevation_refr"] * DEG_TO_RAD)
            * torch.exp(-0.8662 * linke * m * rayleigh))


def clear_sky_diffuse_horizontal(linke: float, sun):
    """[W m-2] Rigollier 2000 clear-sky diffuse (solarRadiation.cpp:365-391);
    ``linke`` a Python number, so the turbidity coefficients are host
    floats as in the JAX function."""
    trd = max(-0.015843 + linke * (0.030543 + 0.0003797 * linke), 1e-6)
    sin_elev = torch.clamp_min(torch.sin(sun["elevation_refr"] * DEG_TO_RAD), 1e-5)
    a0 = 0.26463 + linke * (-0.061581 + 0.0031408 * linke)
    a0 = 0.002 / trd if a0 * trd < 0.0022 else a0
    a1 = 2.0402 + linke * (0.018945 - 0.011161 * linke)
    a2 = -1.3025 + linke * (0.039231 + 0.0085079 * linke)
    fd = a0 + a1 * sin_elev + a2 * sq(sin_elev)
    return where(sun["elevation_refr"] <= 1e-3, 0.0,
                 sun["etr_normal"] * fd * trd)


def separate_transmissivity_erbs_reindl(clear_sky_trans: float, transmissivity,
                                        sun_elev_deg):
    """(diffuse_trans, global_trans): Erbs 1982 + Reindl 1990 split
    (solarRadiation.cpp:638-700); ``clear_sky_trans`` a Python number."""
    tt = torch.clamp(transmissivity, 1e-6, clear_sky_trans)
    kt = torch.clamp(div(tt, max(clear_sky_trans, 1e-6)), 0.0, 1.2)
    sin_elev = torch.clamp_min(torch.sin(sun_elev_deg * DEG_TO_RAD), 1e-4)
    kd = where(
        kt <= 0.22, 1.0 - 0.09 * kt,
        where(kt <= 0.80,
              0.9511 - 0.1604 * kt + 4.388 * sq(kt) - 16.638 * ipow(kt, 3)
              + 12.336 * ipow(kt, 4),
              0.165))
    kd = torch.where(sun_elev_deg > 0,
                     kd + (0.10 + div(0.12 * sun_elev_deg, 90.0))
                     * (1.0 - torch.exp(rdiv(-1.0, sin_elev))),
                     kd)
    kd = torch.clamp(kd, 0.0, 1.0)
    return tt * kd, tt


def beam_inclined(bh, sun):
    """(solarRadiation.cpp:397-403)"""
    sin_elev = torch.clamp_min(torch.sin(sun["elevation_refr"] * DEG_TO_RAD), 1e-6)
    sin_inc = torch.clamp_min(torch.sin(sun["incidence"] * DEG_TO_RAD), 0.0)
    return bh * sin_inc / sin_elev


def diffuse_inclined_muneer(bh, dh, sun, slope_deg, aspect_deg, shadow):
    """Muneer 1990 anisotropic diffuse on a slope (solarRadiation.cpp:472-521)."""
    slope_rad = slope_deg * DEG_TO_RAD
    elev_rad = sun["elevation_refr"] * DEG_TO_RAD
    sin_elev = torch.clamp_min(torch.sin(elev_rad), 1e-6)
    sin_slope = torch.sin(slope_rad)
    cos_slope = torch.cos(slope_rad)

    kb = torch.clamp(bh / torch.clamp_min(sun["etr_normal"] * sin_elev, 1e-6),
                     0.0, 1.2)
    r_sky = div(1.0 + cos_slope, 2.0)
    fg = sin_slope - slope_rad * cos_slope \
        - math.pi * sq(torch.sin(slope_rad * 0.5))

    shaded = shadow | (sun["incidence"] <= 0.1)
    low_sun = sun["elevation_refr"] < 3.0

    n = 0.00263 - kb * (0.712 + 0.6883 * kb)
    term_beam = torch.sin(sun["incidence"] * DEG_TO_RAD) / sin_elev
    az_diff = torch.remainder(sun["azimuth"] * DEG_TO_RAD - aspect_deg * DEG_TO_RAD
                              + 2 * math.pi, 2 * math.pi)
    denom2 = torch.clamp_min(0.1 - 0.008 * elev_rad, 0.05)
    fx_sunny = torch.where(
        ~low_sun,
        (n * fg + r_sky) * (1.0 - kb) + kb * term_beam,
        (n * fg + r_sky) * (1.0 - kb)
        + kb * sin_slope * torch.cos(az_diff) / denom2)
    fx = torch.where(shaded, r_sky + fg * 0.252271, fx_sunny)
    return where(sun["elevation_refr"] < 1e-6, 0.0, dh * fx)


def reflected_irradiance(bh, dh, albedo: float, slope_deg):
    """Muneer 1997 ground-reflected (solarRadiation.cpp:527-535);
    ``albedo`` a Python number."""
    a = min(max(albedo, 0.0), 1.0)
    return where(slope_deg < 1e-6, 0.0,
                 div(a * (bh + dh) * (1.0 - torch.cos(slope_deg * DEG_TO_RAD)),
                     2.0))


# ----------------------------------------------------------------------
# transmissivity estimation from observations
# ----------------------------------------------------------------------

def transmissivity_samani(t_min, t_max, samani_coeff=0.17):
    """Atmospheric transmissivity from the daily temperature range
    (computePointTransmissivitySamani, transmissivity.cpp:36-46)."""
    return where(t_max >= t_min,
                 samani_coeff * torch.sqrt(torch.clamp_min(t_max - t_min, 0.0)),
                 NODATA)


def transmissivity_from_measured(observed_rad, potential_rad,
                                 clear_sky_transmissivity=0.75):
    """Transmissivity = clearSky x sum(observed) / sum(potential) over a
    moving window (computeTransmissivity, transmissivity.cpp:105-170);
    NODATA gaps in the observations are skipped with their potential
    counterpart."""
    obs = observed_rad.to(torch.float64)
    pot = potential_rad.to(torch.float64)
    ok = obs != NODATA
    sum_obs = torch.sum(torch.where(ok, obs, 0.0))
    sum_pot = torch.sum(torch.where(ok, pot, 0.0))
    enough = torch.sum(ok) >= 0.66 * obs.shape[-1]
    ratio = where(sum_pot > 0, sum_obs / torch.clamp_min(sum_pot, 1e-9), 0.0)
    t = torch.clamp(ratio, 0.0, 1.0) * clear_sky_transmissivity
    return where(enough, t, NODATA)


# ----------------------------------------------------------------------
# DEM shadowing
# ----------------------------------------------------------------------

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _shadow_ray_march(z, sin_az: float, cos_az: float, step_z: float,
                      max_steps: int):
    """Up-sun ray march: for k = 1..max_steps, compare the DEM shifted by
    the integer offset nearest to k x (sun direction) with the local line
    of sight z + k*step_z.

    The offsets floor(k*sin_az + 0.5) and floor(-k*cos_az + 0.5) (round
    half up) are computed on the host in the DEM's dtype, so the loop reads
    nothing from the device. JAX rolls the whole map and fills cells whose
    source lies outside the box with -1e9, which never shades a finite
    cell; here only the overlap of the box with its shifted copy is
    compared, which gives the same map."""
    R, C = z.shape
    ft = _NP_DTYPE[z.dtype]
    s, c, sz, half = ft(sin_az), ft(cos_az), ft(step_z), ft(0.5)
    shadowed = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for k in range(1, max_steps + 1):
        kf = ft(k)
        dc = int(np.floor(kf * s + half))
        dr = int(np.floor(-kf * c + half))
        if (dr == 0 and dc == 0) or abs(dr) >= R or abs(dc) >= C:
            continue
        dst = (slice(max(-dr, 0), R - max(dr, 0)), slice(max(-dc, 0), C - max(dc, 0)))
        src = (slice(max(dr, 0), R - max(-dr, 0)), slice(max(dc, 0), C - max(-dc, 0)))
        los = z[dst] + float(kf * sz)
        shadowed[dst] |= (z[src] - los) > 0.5
    return shadowed


def shadow_map(dem, valid, cell_size, azimuth_deg, elevation_deg,
               max_steps: int = 128):
    """Boolean (R, C) map: True where the cell is shadowed by terrain.

    Whole-map reformulation of the reference's per-point up-sun ray march
    (computeShadow, solarRadiation.cpp:547-617): shaded when the terrain
    exceeds the line of sight by > 0.5 m anywhere along the ray.
    ``azimuth_deg`` / ``elevation_deg`` are map-averaged host numbers."""
    elev = float(elevation_deg) * math.pi / 180.0
    if elev <= 0:
        return valid.clone()

    az = float(azimuth_deg) * math.pi / 180.0
    step_z = cell_size * math.tan(max(elev, 1e-6))
    z = torch.where(valid, dem, -1e9)
    shadowed = _shadow_ray_march(z, math.sin(az), math.cos(az), step_z,
                                 max_steps)
    return shadowed & valid


# ----------------------------------------------------------------------
# Whole-DEM driver
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class RadiationOutput:
    global_irr: torch.Tensor     # [W m-2]
    beam: torch.Tensor
    diffuse: torch.Tensor
    reflected: torch.Tensor
    sun: dict
    shadow: torch.Tensor         # bool (R, C): shadowed by terrain


def compute_radiation_dem(dem, valid, cell_size, lat_deg, lon_deg,
                          slope_deg, aspect_deg, timezone,
                          year, month, day, hour, *,
                          linke=3.5, albedo=0.2,
                          clear_sky_transmissivity=0.75,
                          transmissivity=None,
                          shadowing=True) -> RadiationOutput:
    """Clear/real-sky irradiance maps for one instant on the whole DEM
    (computeRadiationRsun + computeRadiationDEM,
    solarRadiation.cpp:700-830, 1045-1069): the Linke clear sky, scaled by
    Gh = Ghc x T/Tcs with the Erbs-Reindl diffuse fraction when
    ``transmissivity`` maps are given. With ``shadowing`` it reads three
    numbers from the device (the valid-cell count and the map-mean sun
    azimuth and elevation), as the JAX function does."""
    with torch.profiler.record_function(RADIATION_RANGE):
        height = torch.where(valid, dem, 0.0)
        pressure = pressure_from_altitude(height) * 0.01   # [hPa]
        sun = sun_position(lat_deg, lon_deg, timezone, year, month, day, hour,
                           pressure_hpa=pressure,
                           aspect_deg=aspect_deg, slope_deg=slope_deg)

        illuminated = sun["elevation_refr"] > 0.0
        if shadowing:
            # map-mean sun direction (varies < 0.01 deg across a catchment)
            nv = float(host_read(torch.sum(valid)))
            az = host_read(div(torch.sum(torch.where(valid, sun["azimuth"], 0.0)),
                               max(nv, 1.0)))
            elev = host_read(div(torch.sum(torch.where(valid, sun["elevation_refr"],
                                                       0.0)), max(nv, 1.0)))
            shadow = shadow_map(dem, valid, cell_size, az, elev)
        else:
            shadow = torch.zeros_like(valid, dtype=torch.bool)

        bhc = clear_sky_beam_horizontal(linke, sun)
        dhc = clear_sky_diffuse_horizontal(linke, sun)
        ghc = bhc + dhc

        if transmissivity is not None:
            gh = div(ghc * transmissivity, clear_sky_transmissivity)
            td, tt = separate_transmissivity_erbs_reindl(
                clear_sky_transmissivity, transmissivity, sun["elevation_refr"])
            dh = (td / torch.clamp_min(tt, 1e-9)) * gh
        else:
            gh, dh = ghc, dhc

        sunlit = illuminated & ~shadow & (sun["incidence"] > 0.0)
        bh = where(sunlit, gh - dh, 0.0)
        gh = torch.where(sunlit, gh, dh)

        flat = slope_deg < 1e-6
        beam = torch.where(flat, bh, where(sunlit, beam_inclined(bh, sun), 0.0))
        diffuse = torch.where(flat, dh,
                              diffuse_inclined_muneer(bh, dh, sun, slope_deg,
                                                      aspect_deg, shadow))
        reflected = where(flat, 0.0,
                          reflected_irradiance(bh, dh, albedo, slope_deg))
        glob = beam + diffuse + reflected

        off = ~illuminated | ~valid
        zero = torch.zeros_like(beam)
        return RadiationOutput(global_irr=torch.where(off, zero, glob),
                               beam=torch.where(off, zero, beam),
                               diffuse=torch.where(off, zero, diffuse),
                               reflected=torch.where(off, zero, reflected),
                               sun=sun, shadow=shadow)
