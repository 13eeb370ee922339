"""Watershed / basin-extraction utilities (reference: agrolib/gis/watershed.{h,cpp}).

The port's own copy of ``criteria3d_tpu/core/watershed.py``, line for line,
except that scipy is imported inside the two functions that label
connected areas (the port imports torch and numpy only at module level);
without scipy they raise ImportError, as the JAX module does on import.

Re-implements the reference's basin toolchain with vectorized numpy /
scipy.ndimage instead of per-cell BFS queues:

* ``extract_basin`` — iterated single-step extraction from a closure point
  (watershed.cpp:404-424: three rounds of ``extractBasin_singleStep``).
* ``extract_basin_single_step`` — upslope growth within a 7x7 window, add
  terrain depressions, remove other-basin leakage, keep the connected
  component of the closure point, crop the empty frame
  (watershed.cpp:46-132).
* ``add_terrain_depressions`` — interior pits enclosed by the basin are
  included (watershed.cpp:140-244).
* ``remove_disconnected_areas`` — keep only the 8-connected component
  containing the closure cell (watershed.cpp:251-332).
* ``clean_basin_simple`` — drop cells whose steepest-descent path exits the
  basin before reaching the closure neighbourhood (watershed.cpp:339-397).
* ``clean_basin`` — strict D8 watershed: keep only cells draining to the
  closure cell (watershed.cpp:426-594, ``computeFlowDirectionD8`` +
  upstream flood fill).
* ``d8_flow_direction`` / ``flow_accumulation`` — vectorized D8 receivers
  and drainage-area accumulation (the latter has no reference analogue but
  completes the usual watershed toolbox).

These run on the host (numpy) — like the reference they are one-off grid
preprocessing, not part of the hot solver path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from criteria3d_tpu_torch.io.esri import RasterHeader

__all__ = [
    "d8_flow_direction", "flow_accumulation", "extract_basin",
    "extract_basin_single_step", "add_terrain_depressions",
    "remove_disconnected_areas", "clean_basin_simple", "clean_basin",
    "cut_empty_frame",
]

# 8-neighbour offsets, row-major scan order like the reference's (dr, dc)
# tables (watershed.cpp:432-433)
_OFFSETS = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
_EIGHT = np.ones((3, 3), dtype=bool)          # 8-connectivity structure


def _shift(a: np.ndarray, dr: int, dc: int, fill) -> np.ndarray:
    """Value of a at (row+dr, col+dc), `fill` outside the grid."""
    out = np.full_like(a, fill)
    src = a[max(dr, 0) or None: a.shape[0] + min(dr, 0) or None,
            max(dc, 0) or None: a.shape[1] + min(dc, 0) or None]
    out[max(-dr, 0): a.shape[0] + min(-dr, 0) or None,
        max(-dc, 0): a.shape[1] + min(-dc, 0) or None] = src
    return out


def d8_flow_direction(dem: np.ndarray, cellsize: float,
                      nodata: float = -9999.0) -> np.ndarray:
    """Steepest-descent D8 receiver direction per cell.

    Returns an int array: 0..7 = index into the 8-neighbour offset table,
    -1 = no downslope receiver (pit / nodata). Mirrors
    ``computeFlowDirectionD8`` (watershed.cpp:426-473): strictly positive
    slope required, diagonal distance sqrt(2)*cellsize, first-best wins on
    ties (scan order preserved by argmax over the stacked slope planes).
    """
    dem = np.asarray(dem, dtype=np.float64)
    valid = ~np.isclose(dem, nodata)
    center = np.where(valid, dem, np.inf)
    slopes = []
    for (dr, dc) in _OFFSETS:
        neigh = _shift(np.where(valid, dem, np.nan), dr, dc, np.nan)
        dist = cellsize * (np.sqrt(2.0) if dr != 0 and dc != 0 else 1.0)
        s = (center - neigh) / dist
        slopes.append(np.where(np.isnan(neigh), -np.inf, s))
    slopes = np.stack(slopes)                      # [8, R, C]
    best = np.argmax(slopes, axis=0)
    best_slope = np.take_along_axis(slopes, best[None], axis=0)[0]
    direction = np.where(valid & (best_slope > 0.0), best, -1)
    return direction.astype(np.int32)


def flow_accumulation(dem: np.ndarray, cellsize: float,
                      nodata: float = -9999.0,
                      max_iterations: int | None = None) -> np.ndarray:
    """D8 drainage accumulation (number of upstream cells incl. self).

    Iterative relaxation: each sweep pushes every cell's current count to
    its receiver until the counts converge (bounded by the longest flow
    path). Vectorized — one scatter-add per sweep.
    """
    direction = d8_flow_direction(dem, cellsize, nodata)
    valid = direction >= -1
    valid &= ~np.isclose(np.asarray(dem, np.float64), nodata)
    R, C = direction.shape
    rows, cols = np.nonzero(direction >= 0)
    d = direction[rows, cols]
    drc = np.array(_OFFSETS)
    rec_r = rows + drc[d, 0]
    rec_c = cols + drc[d, 1]
    inside = (rec_r >= 0) & (rec_r < R) & (rec_c >= 0) & (rec_c < C)
    rows, cols = rows[inside], cols[inside]
    rec = rec_r[inside] * C + rec_c[inside]
    acc = np.where(valid, 1.0, 0.0).ravel()
    limit = max_iterations or (R + C) * 2
    # topological relaxation: acc = 1 + sum(acc[upstream]); iterate the
    # fixed point (converges in longest-path sweeps)
    for _ in range(limit):
        new = np.where(valid.ravel(), 1.0, 0.0)
        np.add.at(new, rec, acc[rows * C + cols])
        if np.array_equal(new, acc):
            break
        acc = new
    return acc.reshape(R, C)


def cut_empty_frame(grid: np.ndarray, header: RasterHeader,
                    nodata: float | None = None
                    ) -> tuple[np.ndarray, RasterHeader]:
    """Crop the all-nodata frame around the valid area
    (gis::resizeRasterCutEmptyFrame analogue)."""
    nodata = header.nodata if nodata is None else nodata
    valid = ~np.isclose(grid, nodata)
    if not valid.any():
        raise ValueError("raster is entirely nodata")
    rows = np.nonzero(valid.any(axis=1))[0]
    cols = np.nonzero(valid.any(axis=0))[0]
    r0, r1 = rows[0], rows[-1] + 1
    c0, c1 = cols[0], cols[-1] + 1
    new_header = dataclasses.replace(
        header, nrows=int(r1 - r0), ncols=int(c1 - c0),
        xllcorner=header.xllcorner + c0 * header.cellsize,
        yllcorner=header.yllcorner + (header.nrows - r1) * header.cellsize)
    return grid[r0:r1, c0:c1].copy(), new_header


def _row_col(header: RasterHeader, x: float, y: float) -> tuple[int, int]:
    col = int((x - header.xllcorner) / header.cellsize)
    row = header.nrows - 1 - int((y - header.yllcorner) / header.cellsize)
    return row, col


def add_terrain_depressions(dem: np.ndarray, basin: np.ndarray,
                            nodata: float = -9999.0) -> np.ndarray:
    """Fill interior holes of the basin with DEM elevations.

    Empty (nodata) basin cells NOT 8-connected to the grid border are
    enclosed depressions: they join the basin (watershed.cpp:140-244).
    """
    from scipy import ndimage

    empty = np.isclose(basin, nodata)
    labels, n = ndimage.label(empty, structure=_EIGHT)
    if n == 0:
        return basin
    border_labels = np.unique(np.concatenate([
        labels[0, :], labels[-1, :], labels[:, 0], labels[:, -1]]))
    enclosed = empty & ~np.isin(labels, border_labels)
    out = basin.copy()
    out[enclosed] = dem[enclosed]
    return out


def remove_disconnected_areas(basin: np.ndarray, row_closure: int,
                              col_closure: int,
                              nodata: float = -9999.0) -> np.ndarray:
    """Keep only the 8-connected component containing the closure cell
    (watershed.cpp:251-332)."""
    in_basin = ~np.isclose(basin, nodata)
    if not (0 <= row_closure < basin.shape[0]
            and 0 <= col_closure < basin.shape[1]):
        return basin
    if not in_basin[row_closure, col_closure]:
        return basin
    from scipy import ndimage

    labels, _ = ndimage.label(in_basin, structure=_EIGHT)
    keep = labels == labels[row_closure, col_closure]
    out = basin.copy()
    out[~keep] = nodata
    return out


def clean_basin_simple(dem: np.ndarray, basin: np.ndarray,
                       header: RasterHeader, x_closure: float,
                       y_closure: float) -> np.ndarray:
    """Drop basin cells whose steepest-descent path leaves the basin.

    Each cell descends to its lowest strictly-lower neighbour until it is
    within 3 cell sizes of the closure point or reaches a pit; if the path
    steps onto a non-basin cell first, the ORIGIN cell is removed
    (watershed.cpp:339-397). Vectorized with pointer doubling over the
    descent graph instead of the reference's per-cell walk.
    """
    nodata = header.nodata
    R, C = dem.shape
    valid_dem = ~np.isclose(dem, nodata)
    in_basin = ~np.isclose(basin, nodata)

    # next-cell pointer: lowest neighbour strictly below, else self
    dem_masked = np.where(valid_dem, dem, np.inf)
    neigh = np.stack([_shift(dem_masked, dr, dc, np.inf)
                      for (dr, dc) in _OFFSETS])
    k = np.argmin(neigh, axis=0)
    lowest = np.take_along_axis(neigh, k[None], axis=0)[0]
    has_lower = np.isfinite(lowest) & (lowest < dem_masked)

    rows, cols = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    # cells within the closure threshold stop descending (self-loop)
    xs = header.xllcorner + (cols + 0.5) * header.cellsize
    ys = header.yllcorner + (R - rows - 0.5) * header.cellsize
    near = np.hypot(xs - x_closure, ys - y_closure) <= 3.0 * header.cellsize

    drc = np.array(_OFFSETS)
    nr = rows + drc[k, 0]
    nc = cols + drc[k, 1]
    step = has_lower & ~near
    nr = np.where(step, np.clip(nr, 0, R - 1), rows)
    nc = np.where(step, np.clip(nc, 0, C - 1), cols)
    nxt = (nr * C + nc).ravel()

    # a path is "bad" if it visits any non-basin cell (the origin itself
    # excluded, matching the reference which tests the *new* point)
    bad = (~in_basin).ravel()
    reach_bad = bad[nxt]
    ptr = nxt.copy()
    for _ in range(int(np.ceil(np.log2(max(R * C, 2)))) + 1):
        reach_bad = reach_bad | reach_bad[ptr]
        ptr = ptr[ptr]
    out = basin.copy()
    out[in_basin & reach_bad.reshape(R, C)] = nodata
    return out


def extract_basin_single_step(dem: np.ndarray, header: RasterHeader,
                              x_closure: float, y_closure: float
                              ) -> tuple[np.ndarray, RasterHeader]:
    """One extraction round (watershed.cpp:46-132)."""
    nodata = header.nodata
    row_c, col_c = _row_col(header, x_closure, y_closure)
    if not (0 <= row_c < dem.shape[0] and 0 <= col_c < dem.shape[1]):
        raise ValueError("closure point outside the grid")
    if np.isclose(dem[row_c, col_c], nodata):
        raise ValueError("closure point on nodata")

    valid = ~np.isclose(dem, nodata)
    in_basin = np.zeros(dem.shape, dtype=bool)
    in_basin[row_c, col_c] = True

    # step 1: grow upslope — a valid cell joins when some basin cell within
    # the 7x7 window is at lower-or-equal elevation (side=3 window,
    # watershed.cpp:71-110). Iterate the dilation to the fixed point.
    window = [(dr, dc) for dr in range(-3, 4) for dc in range(-3, 4)
              if (dr, dc) != (0, 0)]
    dem_m = np.where(valid, dem, np.nan)
    while True:
        reach = np.zeros(dem.shape, dtype=bool)
        for (dr, dc) in window:
            src_in = _shift(in_basin, dr, dc, False)
            src_z = _shift(dem_m, dr, dc, np.nan)
            with np.errstate(invalid="ignore"):
                reach |= src_in & (dem_m >= src_z)
        new = reach & valid & ~in_basin
        if not new.any():
            break
        in_basin |= new

    basin = np.where(in_basin, dem, nodata)
    basin = add_terrain_depressions(dem, basin, nodata)
    basin = clean_basin_simple(dem, basin, header, x_closure, y_closure)
    basin = remove_disconnected_areas(basin, row_c, col_c, nodata)
    return cut_empty_frame(basin, header, nodata)


def extract_basin(dem: np.ndarray, header: RasterHeader, x_closure: float,
                  y_closure: float, rounds: int = 3
                  ) -> tuple[np.ndarray, RasterHeader]:
    """Extract the basin upstream of (x_closure, y_closure): `rounds`
    applications of the single-step extraction (watershed.cpp:404-424)."""
    grid, hdr = np.asarray(dem, np.float64), header
    for _ in range(rounds):
        grid, hdr = extract_basin_single_step(grid, hdr, x_closure, y_closure)
    return grid, hdr


def clean_basin(dem: np.ndarray, header: RasterHeader, x_closure: float,
                y_closure: float) -> tuple[np.ndarray, RasterHeader]:
    """Strict D8 watershed of the closure cell (watershed.cpp:479-594).

    Keeps only cells whose steepest-descent (D8) path reaches the closure
    cell; crops the empty frame.
    """
    nodata = header.nodata
    dem = np.asarray(dem, np.float64)
    R, C = dem.shape
    row_c, col_c = _row_col(header, x_closure, y_closure)
    if not (0 <= row_c < R and 0 <= col_c < C):
        raise ValueError("closure point outside the grid")

    direction = d8_flow_direction(dem, header.cellsize, nodata)
    keep = np.zeros((R, C), dtype=bool)
    keep[row_c, col_c] = True
    drc = np.array(_OFFSETS)
    # upstream flood fill: a cell joins when its receiver is kept.
    # Each sweep extends every kept path by >=1 cell upstream.
    while True:
        grew = False
        for i, (dr, dc) in enumerate(_OFFSETS):
            # cells flowing in direction i land at (r+dr, c+dc): they join
            # if that receiver is kept
            receiver_kept = _shift(keep, dr, dc, False)
            new = (direction == i) & receiver_kept & ~keep
            if new.any():
                keep |= new
                grew = True
        if not grew:
            break
    basin = np.where(keep, dem, nodata)
    return cut_empty_frame(basin, header, nodata)
