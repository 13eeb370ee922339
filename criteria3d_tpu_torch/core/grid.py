"""Static grid geometry: the dense masked (layer, row, col) node box.

PyTorch counterpart of ``criteria3d_tpu/core/grid.py``. The build-time code
is numpy, copied from the JAX package unchanged (project3D.cpp:941-1103
setCrit3DTopography, setSoilLayers/setLayersDepth, gis.cpp slope/aspect and
boundary-runoff rules); only the last step differs: the fields become torch
tensors on the requested device.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import DEG_TO_RAD, EPSILON, NODATA
from criteria3d_tpu_torch.core.soil import SoilFields
from criteria3d_tpu_torch.device import map_tensors, resolve_device

__all__ = ["BoundaryType", "Grid", "LATERAL_OFFSETS", "build_soil_layers",
           "slope_aspect"]

# Lateral neighbour offsets (di, dj): N, S, W, E then diagonals.
LATERAL_OFFSETS = (
    (-1, 0), (1, 0), (0, -1), (0, 1),
    (-1, -1), (-1, 1), (1, -1), (1, 1),
)


class BoundaryType(enum.IntEnum):
    """Mirrors boundaryType_t (reference types.h:98-99)."""

    NONE = 0
    RUNOFF = 1
    FREE_DRAINAGE = 2
    FREE_LATERAL_DRAINAGE = 3
    PRESCRIBED_TOTAL_POTENTIAL = 4
    URBAN = 5
    ROAD = 6
    CULVERT = 7
    HEAT_SURFACE = 8


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """Static geometry + parameters of the 3-D node box.

    Tensor shapes are ``(L, R, C)`` unless noted; the metadata fields are
    Python scalars.
    """

    # --- geometry ---
    mask: torch.Tensor             # bool (L,R,C): node exists
    z: torch.Tensor                # [m] node elevation (layer centre)
    volume: torch.Tensor           # [m3] node volume ([m2] area for surface)
    lat_dist3d: torch.Tensor       # (8,R,C) [m] 3-D distance to lateral nbr
    dz_lat: torch.Tensor           # (8,R,C) [m] z(nbr) - z (layer-independent)
    lat_dist2d: torch.Tensor       # (8,1,1) [m] 2-D (plan) distance
    lat_area: torch.Tensor         # (L,1,1) [m2] lateral interface area (x0.5)
    vert_dist: torch.Tensor        # (L,1,1) [m] distance to layer above
    area: torch.Tensor             # scalar [m2] cell area

    # --- boundary data (boundaryData_t, types.h:219-249) ---
    btype: torch.Tensor            # int8 (L,R,C)
    bslope: torch.Tensor           # (L,R,C) [m/m]
    bsize: torch.Tensor            # (L,R,C) [m2] ([m] for surface runoff)
    prescribed_h: torch.Tensor     # (L,R,C) [m] total potential, Prescribed BC

    # --- per-node material properties ---
    soil: SoilFields               # (L,R,C) dense soil parameters
    roughness: torch.Tensor        # (R,C) [s m-1/3] surface Manning roughness
    pond_max: torch.Tensor         # (R,C) [m] surface pond height

    # --- culvert geometry (culvertData_t, types.h:154-160; zero = none) ---
    culvert_w: torch.Tensor        # (R,C) [m]
    culvert_h: torch.Tensor        # (R,C) [m]
    culvert_rough: torch.Tensor    # (R,C) [s m-1/3]

    # --- static metadata ---
    has_prescribed: bool
    has_culvert: bool
    cell_size: float
    n_layers: int
    n_nodes: int
    n_surface_nodes: int
    layer_depth: tuple
    layer_thickness: tuple

    def __post_init__(self):
        # per-dtype copies made by astype(); a new Grid starts empty
        object.__setattr__(self, "_casts", {})

    @property
    def shape(self):
        return tuple(self.mask.shape)

    @property
    def surface_mask(self):
        return self.mask[0]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def to(self, device) -> "Grid":
        return map_tensors(self, lambda t: t.to(device))

    def astype(self, dtype) -> "Grid":
        """The grid with every floating-point field cast to ``dtype``.

        The copy is made once per dtype and kept with this grid: the f32
        assembly reads these casts on every Picard iteration, and since a
        cast is deterministic, precomputing it changes no result."""
        if dtype not in self._casts:
            self._casts[dtype] = map_tensors(
                self,
                lambda t: t.to(dtype) if t.is_floating_point() else t)
        return self._casts[dtype]

    def set_culvert(self, row: int, col: int, *, roughness: float,
                    slope: float, width: float, height: float) -> "Grid":
        """Mark the surface node (row, col) as a culvert outlet
        (soilFluxes3D::setCulvert, soilFluxes3D.cpp:551-589)."""
        btype, bslope, bsize = (a.clone() for a in
                                (self.btype, self.bslope, self.bsize))
        cw, ch, cr = (a.clone() for a in
                      (self.culvert_w, self.culvert_h, self.culvert_rough))
        btype[0, row, col] = int(BoundaryType.CULVERT)
        bslope[0, row, col] = slope
        bsize[0, row, col] = width * height
        cw[row, col] = width
        ch[row, col] = height
        cr[row, col] = roughness
        return dataclasses.replace(
            self, btype=btype, bslope=bslope, bsize=bsize,
            culvert_w=cw, culvert_h=ch, culvert_rough=cr, has_culvert=True)

    def set_prescribed(self, layer: int, row: int, col: int,
                       total_potential: float,
                       boundary_size: float | None = None) -> "Grid":
        """Mark node (layer, row, col) as a prescribed-total-potential
        boundary; ``boundary_size`` [m2] defaults to the cell area."""
        if boundary_size is None:
            boundary_size = float(self.area)
        btype, bsize, ph = (a.clone() for a in
                            (self.btype, self.bsize, self.prescribed_h))
        btype[layer, row, col] = int(BoundaryType.PRESCRIBED_TOTAL_POTENTIAL)
        bsize[layer, row, col] = boundary_size
        ph[layer, row, col] = total_potential
        return dataclasses.replace(self, btype=btype, bsize=bsize,
                                   prescribed_h=ph, has_prescribed=True)

    # ------------------------------------------------------------------
    @staticmethod
    def build(dem: np.ndarray,
              cell_size: float,
              soil: SoilFields,
              *,
              total_depth: float = 1.0,
              min_thickness: float = 0.02,
              max_thickness: float = 0.1,
              max_thickness_depth: float = 0.4,
              soil_depth_map: np.ndarray | None = None,
              roughness: np.ndarray | float = 0.05,
              pond_max: np.ndarray | float = 0.002,
              land_use: np.ndarray | None = None,
              free_catchment_runoff: bool = True,
              free_bottom_drainage: bool = True,
              free_lateral_drainage: bool = True,
              dtype=torch.float64,
              device=None) -> "Grid":
        """Construct the node box from a DEM (Project3D::initialize3DModel,
        project3D.cpp:456-616). ``soil`` is (L, R, C) or (R, C)-shaped (then
        broadcast over layers). ``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        dem = np.asarray(dem, dtype=np.float64)
        R, C = dem.shape
        valid2d = ~np.isclose(dem, NODATA)

        depths, thicknesses = build_soil_layers(
            total_depth, min_thickness, max_thickness, max_thickness_depth)
        L = len(depths)

        # --- per-layer mask ---
        mask = np.zeros((L, R, C), dtype=bool)
        mask[0] = valid2d
        if soil_depth_map is None:
            soil_depth_map = np.full((R, C), total_depth)
        for l in range(1, L):
            mask[l] = valid2d & (depths[l] <= soil_depth_map + 1e-12)
        if land_use is not None:
            # ROAD has no subsurface (project3D.cpp:795)
            road = land_use == BoundaryType.ROAD
            mask[1:] &= ~road[None]

        # --- geometry ---
        area = cell_size * cell_size
        z = np.where(valid2d, dem, 0.0)[None] - np.asarray(depths)[:, None, None]
        z = np.where(mask, z, 0.0)
        volume = np.empty((L, R, C))
        volume[0] = area
        for l in range(1, L):
            volume[l] = area * thicknesses[l]
        volume = np.where(mask, volume, 0.0)

        lat_area = np.empty((L,))
        lat_area[0] = cell_size * 0.5
        for l in range(1, L):
            lat_area[l] = cell_size * thicknesses[l] * 0.5

        vert_dist = np.zeros((L,))
        for l in range(1, L):
            vert_dist[l] = depths[l] - depths[l - 1]

        lat_dist2d = np.array([cell_size * math.hypot(di, dj)
                               for (di, dj) in LATERAL_OFFSETS])
        lat_dist3d = np.empty((8, R, C))
        dz_lat = np.zeros((8, R, C))
        zdem = np.where(valid2d, dem, 0.0)
        for k, (di, dj) in enumerate(LATERAL_OFFSETS):
            zn = _np_shift(zdem, di, dj)
            dz = zdem - zn
            lat_dist3d[k] = np.sqrt(lat_dist2d[k] ** 2 + dz ** 2)
            vn = _np_shift(valid2d.astype(np.float64), di, dj) > 0
            dz_lat[k] = np.where(valid2d & vn, -dz, 0.0)

        # --- slope / aspect / runoff boundary ---
        slope_deg, aspect_deg = slope_aspect(dem, cell_size)
        bslope2d = np.tan(slope_deg * DEG_TO_RAD)
        runoff_bnd = _boundary_runoff_mask(dem, valid2d, aspect_deg)

        # --- boundary assignment (project3D.cpp:963-1036) ---
        btype = np.zeros((L, R, C), dtype=np.int8)
        bslope = np.zeros((L, R, C))
        bsize = np.zeros((L, R, C))

        if free_catchment_runoff:
            sel = mask[0] & runoff_bnd
            btype[0][sel] = BoundaryType.RUNOFF
            bslope[0][sel] = bslope2d[sel]
            bsize[0][sel] = cell_size

        for l in range(1, L):
            is_last = (l == L - 1)
            below = mask[l + 1] if not is_last else np.zeros((R, C), bool)
            bottom = mask[l] & ~below
            if free_bottom_drainage:
                btype[l][bottom] = BoundaryType.FREE_DRAINAGE
                bsize[l][bottom] = area
            mid = mask[l] & below
            if free_lateral_drainage:
                sel = mid & runoff_bnd
                btype[l][sel] = BoundaryType.FREE_LATERAL_DRAINAGE
                bslope[l][sel] = bslope2d[sel]
                bsize[l][sel] = cell_size * thicknesses[l]
            if land_use is not None and l == 1:
                road = mask[l] & (land_use == BoundaryType.ROAD)
                urban = mask[l] & (land_use == BoundaryType.URBAN)
                btype[l][road] = BoundaryType.ROAD
                btype[l][urban] = BoundaryType.URBAN

        # --- soil broadcast ---
        if soil.vg_alpha.ndim == 2:
            soil = map_tensors(
                soil, lambda a: a.to(dev, dtype).expand(L, R, C).contiguous())
        else:
            soil = soil.to(dev)

        rough2d = np.broadcast_to(np.asarray(roughness, dtype=np.float64), (R, C))
        pond2d = np.broadcast_to(np.asarray(pond_max, dtype=np.float64), (R, C))

        def t(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        return Grid(
            mask=torch.tensor(mask, device=dev),
            z=t(z), volume=t(volume),
            lat_dist3d=t(lat_dist3d),
            dz_lat=t(dz_lat),
            lat_dist2d=t(lat_dist2d).reshape(8, 1, 1),
            lat_area=t(lat_area).reshape(L, 1, 1),
            vert_dist=t(vert_dist).reshape(L, 1, 1),
            area=t(area),
            btype=torch.tensor(btype, device=dev),
            bslope=t(bslope), bsize=t(bsize),
            prescribed_h=t(np.zeros((L, R, C))),
            soil=soil,
            roughness=t(rough2d), pond_max=t(pond2d),
            culvert_w=t(np.zeros((R, C))), culvert_h=t(np.zeros((R, C))),
            culvert_rough=t(np.zeros((R, C))),
            has_prescribed=bool(
                (btype == BoundaryType.PRESCRIBED_TOTAL_POTENTIAL).any()),
            has_culvert=False,
            cell_size=float(cell_size),
            n_layers=L, n_nodes=int(mask.sum()),
            n_surface_nodes=int(mask[0].sum()),
            layer_depth=tuple(depths), layer_thickness=tuple(thicknesses),
        )


# ----------------------------------------------------------------------
# build-time helpers (numpy)
# ----------------------------------------------------------------------

def build_soil_layers(total_depth: float,
                      min_thickness: float = 0.02,
                      max_thickness: float = 0.1,
                      max_thickness_depth: float = 0.4,
                      ) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Layer centre depths and thicknesses with geometric growth
    (Project3D::setSoilLayers + setLayersDepth, project3D.cpp:1568-1661):
    layer 0 is the surface (zero thickness), layer 1 has ``min_thickness``,
    thickness then grows by a fitted factor up to ``max_thickness``; the
    last layer absorbs the remainder."""
    if total_depth <= 0:
        return (0.0,), (0.0,)

    if min_thickness == max_thickness:
        growth = 1.0
    else:
        best_factor, best_err = 1.01, 99.0
        factor = 1.01
        while factor <= 2.0:
            upper, thick = 0.0, min_thickness
            depth = upper + thick * 0.5
            while thick < max_thickness:
                upper += thick
                thick = min(thick * factor, max_thickness)
                depth = upper + thick * 0.5
            err = abs(depth - max_thickness_depth)
            if err < best_err:
                best_err, best_factor = err, factor
            factor += 0.01
        growth = best_factor

    n_layers = 2
    thick, lower = min_thickness, min_thickness
    while (total_depth - lower) > min_thickness:
        n_layers += 1
        thick = min(thick * growth, max_thickness)
        lower += thick

    depths = [0.0] * n_layers
    thicknesses = [0.0] * n_layers
    if n_layers > 1:
        thicknesses[1] = min_thickness
        depths[1] = min_thickness * 0.5
        current = min_thickness
        for i in range(2, n_layers):
            if i == n_layers - 1:
                thicknesses[i] = total_depth - current
            else:
                thicknesses[i] = min(max_thickness, thicknesses[i - 1] * growth)
            depths[i] = current + thicknesses[i] * 0.5
            current += thicknesses[i]
    return tuple(depths), tuple(thicknesses)


def _np_shift(x: np.ndarray, di: int, dj: int, fill=0.0) -> np.ndarray:
    """y[i, j] = x[i+di, j+dj], `fill` outside."""
    y = np.full_like(x, fill)
    src_r = slice(max(di, 0), x.shape[0] + min(di, 0))
    dst_r = slice(max(-di, 0), x.shape[0] + min(-di, 0))
    src_c = slice(max(dj, 0), x.shape[1] + min(dj, 0))
    dst_c = slice(max(-dj, 0), x.shape[1] + min(-dj, 0))
    y[dst_r, dst_c] = x[src_r, src_c]
    return y


def slope_aspect(dem: np.ndarray, cell_size: float) -> tuple[np.ndarray, np.ndarray]:
    """Slope [deg] and aspect [deg, 0=N clockwise] of a DEM with nodata:
    Horn's 3x3 derivatives inside (gis.cpp:1190-1257), the nodata-robust
    masked-difference variant on the rim (gis.cpp:1100-1186)."""
    valid = ~np.isclose(dem, NODATA)
    z = np.where(valid, dem, 0.0)

    def nb(di, dj):
        return (_np_shift(z, di, dj), _np_shift(valid.astype(np.float64), di, dj))

    z1, _ = nb(-1, -1); z2, _ = nb(-1, 0); z3, _ = nb(-1, 1)
    z4, _ = nb(0, -1); z6, _ = nb(0, 1)
    z7, _ = nb(1, -1); z8, _ = nb(1, 0); z9, _ = nb(1, 1)
    dzdx_h = ((z3 + 2 * z6 + z9) - (z1 + 2 * z4 + z7)) / (8.0 * cell_size)
    dzdy_h = ((z7 + 2 * z8 + z9) - (z1 + 2 * z2 + z3)) / (8.0 * cell_size)
    flat_h = (np.abs(dzdx_h) < EPSILON) & (np.abs(dzdy_h) < EPSILON)
    slope_h = np.degrees(np.arctan(np.hypot(dzdx_h, dzdy_h)))
    aspect_h = 90.0 - np.degrees(np.arctan2(dzdy_h, -dzdx_h))
    aspect_h = np.where(aspect_h < 0, aspect_h + 360.0, aspect_h)
    slope_h = np.where(flat_h, 0.0, slope_h)
    aspect_h = np.where(flat_h, 0.0, aspect_h)

    dz_y = np.zeros_like(z); dy = np.zeros_like(z)
    dz_x = np.zeros_like(z); dx = np.zeros_like(z)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == 0 and dj == 0:
                continue
            zn, vn = nb(di, dj)
            if di != 0:
                dz_y += np.where(vn > 0, di * (z - zn), 0.0)
                dy += np.where(vn > 0, cell_size, 0.0)
            if dj != 0:
                dz_x += np.where(vn > 0, dj * (z - zn), 0.0)
                dx += np.where(vn > 0, cell_size, 0.0)
    dzdy_b = dz_y / np.maximum(dy, EPSILON)
    dzdx_b = dz_x / np.maximum(dx, EPSILON)
    slope_b = np.degrees(np.arctan(np.hypot(dzdx_b, dzdy_b)))
    aspect_b = 90.0 - np.degrees(np.arctan2(-dzdy_b, dzdx_b))
    aspect_b = np.where(aspect_b < 0, aspect_b + 360.0, aspect_b)

    n_valid_nb = sum(_np_shift(valid.astype(np.float64), di, dj)
                     for (di, dj) in LATERAL_OFFSETS)
    is_rim = valid & (n_valid_nb < 8)

    slope = np.where(is_rim, slope_b, slope_h)
    aspect = np.where(is_rim, aspect_b, aspect_h)
    slope = np.where(valid, slope, NODATA)
    aspect = np.where(valid, aspect, NODATA)
    return slope, aspect


def _boundary_runoff_mask(dem: np.ndarray, valid: np.ndarray,
                          aspect_deg: np.ndarray) -> np.ndarray:
    """Cells whose downhill (aspect) neighbour leaves the catchment
    (gis::isBoundaryRunoff, gis.cpp:1452-1488)."""
    R, C = dem.shape
    z = np.where(valid, dem, np.inf)

    n_valid_nb = np.zeros((R, C))
    strict_min = np.ones((R, C), dtype=bool)
    for (di, dj) in LATERAL_OFFSETS:
        vn = _np_shift(valid.astype(np.float64), di, dj) > 0
        zn = _np_shift(z, di, dj, fill=np.inf)
        n_valid_nb += vn
        strict_min &= np.where(vn, z < zn, True)
    is_rim = valid & (n_valid_nb < 8)

    a = aspect_deg
    r_off = np.where((a >= 135) & (a <= 225), 1,
                     np.where((a <= 45) | (a >= 315), -1, 0))
    c_off = np.where((a >= 45) & (a <= 135), 1,
                     np.where((a >= 225) & (a <= 315), -1, 0))

    rows, cols = np.mgrid[0:R, 0:C]
    tr = rows + r_off
    tc = cols + c_off
    inside = (tr >= 0) & (tr < R) & (tc >= 0) & (tc < C)
    target_valid = np.zeros((R, C), dtype=bool)
    target_valid[inside] = valid[tr[inside], tc[inside]]
    aspect_ok = ~np.isclose(aspect_deg, NODATA) & ~target_valid

    return is_rim & (strict_min | aspect_ok)
