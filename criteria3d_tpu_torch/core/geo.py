"""UTM <-> lat/lon (WGS84) conversions, vectorised, pure numpy.

The port's own copy of ``criteria3d_tpu/core/geo.py``, line for line.
Re-implements gis::utmToLatLon / latLonToUtmForceZone
(agrolib/gis/gis.cpp:870-1063) with numpy broadcasting so whole lat/lon maps
for a DEM are produced in one call (the reference loops cell by cell).
"""

from __future__ import annotations

import numpy as np

__all__ = ["utm_to_latlon", "latlon_to_utm", "latlon_maps"]

# WGS84 (Crit3DEllipsoid defaults, gis.h:202)
EQUATORIAL_RADIUS = 6378137.0
ECC_SQUARED = 0.00669438
K0 = 0.9996


def utm_to_latlon(zone_number: int, reference_lat: float,
                  easting, northing):
    """(lat, lon) [deg] from UTM easting/northing [m]. Array-friendly."""
    ae = EQUATORIAL_RADIUS
    ecc = ECC_SQUARED
    e1 = (1.0 - np.sqrt(1.0 - ecc)) / (1.0 + np.sqrt(1.0 - ecc))

    x = np.asarray(easting, np.float64) - 500000.0
    y = np.asarray(northing, np.float64)
    if reference_lat < 0:
        y = y - 10000000.0

    ecc_prime = ecc / (1.0 - ecc)
    m = y / K0
    mu = m / (ae * (1.0 - ecc / 4.0 - 3.0 * ecc ** 2 / 64.0
                    - 5.0 * ecc ** 3 / 256.0))
    phi1 = (mu + (3.0 * e1 / 2.0 - 27.0 * e1 ** 3 / 32.0) * np.sin(2.0 * mu)
            + (21.0 * e1 ** 2 / 16.0 - 55.0 * e1 ** 4 / 32.0) * np.sin(4.0 * mu)
            + (151.0 * e1 ** 3 / 96.0) * np.sin(6.0 * mu))

    sin_phi1 = np.sin(phi1)
    cos_phi1 = np.cos(phi1)
    tan_phi1 = np.tan(phi1)
    n1 = ae / np.sqrt(1.0 - ecc * sin_phi1 ** 2)
    t1 = tan_phi1 ** 2
    c1 = ecc_prime * cos_phi1 ** 2
    r1 = ae * (1.0 - ecc) / (1.0 - ecc * sin_phi1 ** 2) ** 1.5
    d = x / (n1 * K0)

    lat = phi1 - (n1 * tan_phi1 / r1) * (
        d ** 2 / 2.0
        - (5.0 + 3.0 * t1 + 10.0 * c1 - 4.0 * c1 ** 2 - 9.0 * ecc_prime)
        * d ** 4 / 24.0
        + (61.0 + 90.0 * t1 + 298.0 * c1 + 45.0 * t1 ** 2
           - 252.0 * ecc_prime - 3.0 * c1 ** 2) * d ** 6 / 720.0)
    lon = (d - (1.0 + 2.0 * t1 + c1) * d ** 3 / 6.0
           + (5.0 - 2.0 * c1 + 28.0 * t1 - 3.0 * c1 ** 2
              + 8.0 * ecc_prime + 24.0 * t1 ** 2) * d ** 5 / 120.0) / cos_phi1

    long_origin = (zone_number - 1.0) * 6.0 - 180.0 + 3.0
    return np.degrees(lat), np.degrees(lon) + long_origin


def latlon_to_utm(lat, lon, zone_number: int | None = None):
    """(easting, northing, zone) from lat/lon [deg] (gis.cpp:870-1003)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    ae, ecc = EQUATORIAL_RADIUS, ECC_SQUARED
    ecc_prime = ecc / (1.0 - ecc)

    if zone_number is None:
        zone_number = int(np.floor((np.mean(lon) + 180.0) / 6.0) + 1)
    long_origin = np.radians((zone_number - 1.0) * 6.0 - 180.0 + 3.0)

    lat_r = np.radians(lat)
    lon_r = np.radians(lon)
    n = ae / np.sqrt(1.0 - ecc * np.sin(lat_r) ** 2)
    t = np.tan(lat_r) ** 2
    c = ecc_prime * np.cos(lat_r) ** 2
    a = np.cos(lat_r) * (lon_r - long_origin)
    m = ae * ((1.0 - ecc / 4.0 - 3.0 * ecc ** 2 / 64.0 - 5.0 * ecc ** 3 / 256.0) * lat_r
              - (3.0 * ecc / 8.0 + 3.0 * ecc ** 2 / 32.0 + 45.0 * ecc ** 3 / 1024.0)
              * np.sin(2.0 * lat_r)
              + (15.0 * ecc ** 2 / 256.0 + 45.0 * ecc ** 3 / 1024.0)
              * np.sin(4.0 * lat_r)
              - (35.0 * ecc ** 3 / 3072.0) * np.sin(6.0 * lat_r))

    easting = (K0 * n * (a + (1.0 - t + c) * a ** 3 / 6.0
                         + (5.0 - 18.0 * t + t ** 2 + 72.0 * c - 58.0 * ecc_prime)
                         * a ** 5 / 120.0) + 500000.0)
    northing = K0 * (m + n * np.tan(lat_r)
                     * (a ** 2 / 2.0 + (5.0 - t + 9.0 * c + 4.0 * c ** 2) * a ** 4 / 24.0
                        + (61.0 - 58.0 * t + t ** 2 + 600.0 * c - 330.0 * ecc_prime)
                        * a ** 6 / 720.0))
    northing = np.where(lat < 0, northing + 10000000.0, northing)
    return easting, northing, zone_number


def latlon_maps(header, utm_zone: int, reference_lat: float = 45.0):
    """(lat, lon) maps [deg] for every cell of a RasterHeader grid."""
    rows = np.arange(header.nrows)
    cols = np.arange(header.ncols)
    x = header.xllcorner + (cols + 0.5) * header.cellsize
    y = header.yllcorner + (header.nrows - rows - 0.5) * header.cellsize
    xx, yy = np.meshgrid(x, y)
    return utm_to_latlon(utm_zone, reference_lat, xx, yy)
