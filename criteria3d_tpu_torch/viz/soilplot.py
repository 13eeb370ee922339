"""Soil hydraulic-curve plots — the soilWidget analogue.

The reference's soil editor (agrolib/soilWidget/soilWidget.cpp +
tabWaterRetentionCurve.cpp / tabHydraulicConductivityCurve.cpp) plots
each horizon's modified-van-Genuchten water-retention curve over the lab
points and the Mualem conductivity curve, both against log10 |psi|.
Headless: the curves are evaluated through the *solver's own* soil
kernels (core/soil.py, the same code the Richards assembly runs), so the
plot shows exactly what the model integrates. The port evaluates them on
CPU float64 tensors, all 240 potentials in one call (element-wise, so
each value is the one the JAX package's per-potential calls give).
"""

from __future__ import annotations

import numpy as np
import torch

from criteria3d_tpu_torch.core.soil import (SoilFields, WRCModel,
                                            mualem_conductivity, se_from_psi,
                                            theta_from_se)
from criteria3d_tpu_torch.viz.canvas import Canvas
from criteria3d_tpu_torch.viz.charts import SERIES_COLORS, _Axes

__all__ = ["retention_plot", "conductivity_plot"]

# kPa sweep matching the widget's axis (tabWaterRetentionCurve.cpp
# dxMin/dxMax: 10^-3 .. 10^6 kPa, log-spaced)
_PSI_KPA = np.logspace(-3, 6, 240)
_KPA_TO_M = 1.0 / 9.80665  # |psi| m of water per kPa


def _horizon_fields(h: dict) -> SoilFields:
    """Uniform 1-element SoilFields from a horizon parameter dict
    (keys as io/database.py horizon rows: vg_alpha [kPa-1 or m-1...]
    here always [m-1], vg_n, vg_he [m], theta_s, theta_r, k_sat [m/s])."""
    return SoilFields.uniform(
        (1,), vg_alpha=float(h["vg_alpha"]), vg_n=float(h["vg_n"]),
        vg_he=float(h.get("vg_he", 0.0)), theta_s=float(h["theta_s"]),
        theta_r=float(h["theta_r"]), k_sat=float(h.get("k_sat", 1e-5)),
        mualem_l=float(h.get("mualem_l", 0.5)), device="cpu")


def _se_curve(sf: SoilFields, psi_m: np.ndarray, model: WRCModel) -> torch.Tensor:
    return se_from_psi(sf, torch.from_numpy(psi_m), model)


def _log_axes(width, height, ylo, yhi, title, ylabel):
    ax = _Axes(width, height, -3.0, 6.0, ylo, yhi,
               lambda v: f"10^{v:.0f}" if float(v).is_integer()
               else f"{10.0 ** v:.3g}",
               title, "WATER POTENTIAL [KPA] (LOG)", ylabel)
    return ax


def retention_plot(horizons, *, model: WRCModel = WRCModel.MODIFIED_VAN_GENUCHTEN,
                   lab_points=None, title: str = "WATER RETENTION",
                   width: int = 640, height: int = 420) -> Canvas:
    """theta(|psi|) per horizon, log-psi axis; optional lab points
    ``(psi_kpa, theta)`` overlay (the widget's measured dots)."""
    if isinstance(horizons, dict):
        horizons = [horizons]
    theta_max = max(float(h["theta_s"]) for h in horizons)
    ax = _log_axes(width, height, 0.0, theta_max * 1.05, title,
                   "THETA [M3 M-3]")
    psi_m = _PSI_KPA * _KPA_TO_M
    for i, h in enumerate(horizons):
        sf = _horizon_fields(h)
        th = theta_from_se(sf, _se_curve(sf, psi_m, model)).numpy()
        c = SERIES_COLORS[i % len(SERIES_COLORS)]
        pts = [(ax.px(lx), ax.py(t))
               for lx, t in zip(np.log10(_PSI_KPA), th)]
        ax.cv.polyline(pts, c, width=2)
        name = str(h.get("name", f"HORIZON {i + 1}"))
        ax.cv.fill_rect(ax.x0 + 8, ax.y0 + 6 + 12 * i, 12, 3, c)
        ax.cv.text(ax.x0 + 24, ax.y0 + 3 + 12 * i, name)
    if lab_points is not None:
        for p_kpa, th in lab_points:
            ax.cv.marker(ax.px(np.log10(max(p_kpa, 1e-3))), ax.py(th),
                         (0, 0, 0), size=4)
    return ax.cv


def conductivity_plot(horizons, *, model: WRCModel = WRCModel.MODIFIED_VAN_GENUCHTEN,
                      title: str = "HYDRAULIC CONDUCTIVITY",
                      width: int = 640, height: int = 420) -> Canvas:
    """log10 K(|psi|) [cm/d] per horizon (the widget's conductivity tab)."""
    if isinstance(horizons, dict):
        horizons = [horizons]
    psi_m = _PSI_KPA * _KPA_TO_M
    curves = []
    for h in horizons:
        sf = _horizon_fields(h)
        k = mualem_conductivity(sf, _se_curve(sf, psi_m, model), model).numpy()
        curves.append(np.log10(np.maximum(k * 8.64e6, 1e-30)))  # m/s→cm/d
    lo = min(float(c.min()) for c in curves)
    hi = max(float(c.max()) for c in curves)
    ax = _log_axes(width, height, max(lo, hi - 14), hi + 0.5, title,
                   "LOG10 K [CM D-1]")
    for i, (h, cv_vals) in enumerate(zip(horizons, curves)):
        c = SERIES_COLORS[i % len(SERIES_COLORS)]
        pts = [(ax.px(lx), ax.py(max(v, ax.ylo)))
               for lx, v in zip(np.log10(_PSI_KPA), cv_vals)]
        ax.cv.polyline(pts, c, width=2)
        name = str(h.get("name", f"HORIZON {i + 1}"))
        ax.cv.fill_rect(ax.x0 + 8, ax.y0 + 6 + 12 * i, 12, 3, c)
        ax.cv.text(ax.x0 + 24, ax.y0 + 3 + 12 * i, name)
    return ax.cv
