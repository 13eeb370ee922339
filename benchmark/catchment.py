"""The benchmark's data generator: the catchment's DEM.

A copy of the port's ``problems.synthetic_catchment`` with its shapes
taken from a configuration file: a tilted V valley (``down_valley_slope``
per metre down the rows, ``cross_valley_slope`` across the columns) plus
``n_sines`` smooth seeded sines of ``sine_amplitude_m`` height and
``sine_wavelength_m`` wavelength, inside a disc of ``disc_radius_cells``
valid cells centred in a ``box`` x ``box`` grid of ``cell_m`` cells, the
sines drawn from the configuration's ``dem_seed``.

The run's seed does not change the catchment. The solver's work answers to
rounding-level changes of its input: sines drawn from the run's seed
changed the storm hour's steps and iterations threefold, and even the same
terrain turned to each of its eight orientations (quarter turns, mirrored)
moved the CG iterations by up to 12 % and the heat sweeps by up to 25 %
(PERF.md). A seed that changed the work would spread the runs by that much,
so every seed runs the same catchment: the same work.
"""

from __future__ import annotations

import numpy as np

NODATA = -9999.0


def catchment_dem(config: dict, seed: int) -> np.ndarray:
    """The (box, box) float64 DEM of ``config`` [m], NODATA outside the
    disc: the same for every run's ``seed`` (see the module's text)."""
    del seed
    n, cell = int(config["box"]), float(config["cell_m"])
    rng = np.random.default_rng(int(config["dem_seed"]))
    rows, cols = np.mgrid[0:n, 0:n].astype(np.float64)
    z = (float(config["base_elevation_m"])
         + (n - 1 - rows) * float(config["down_valley_slope"]) * cell
         + np.abs(cols - n // 2) * float(config["cross_valley_slope"]) * cell)
    a_lo, a_hi = config["sine_amplitude_m"]
    wavelength = float(config["sine_wavelength_m"])
    for _ in range(int(config["n_sines"])):
        kr, kc = rng.uniform(-1, 1, 2) * 2 * np.pi / wavelength
        z += rng.uniform(a_lo, a_hi) * np.sin(kr * rows * cell + kc * cols * cell
                                              + rng.uniform(0, 2 * np.pi))
    c0 = (n - 1) / 2.0
    disc = (rows - c0) ** 2 + (cols - c0) ** 2 <= float(config["disc_radius_cells"]) ** 2
    return np.where(disc, z, NODATA)
