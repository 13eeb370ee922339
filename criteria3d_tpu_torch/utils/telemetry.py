"""Telemetry and profiling: balance reports and torch.profiler traces.

PyTorch counterpart of ``criteria3d_tpu/utils/telemetry.py``. The
reference logs wall-clock progress every 600 simulated seconds and a
per-hour balance report (project3D.cpp:1351-1385) and offers MATLAB .mat
solver dumps as a debugging aid (logFunctions.h). Here:

* :func:`balance_report` — the same runoff/drainage/MBE [m3]/[mm] summary,
  computed on the state's device; every value it reads back to the host
  goes through :func:`~criteria3d_tpu_torch.device.host_read`, so the
  reads are counted;
* :func:`trace` — a context manager around ``torch.profiler`` writing a
  Chrome trace (where JAX wraps ``jax.profiler``);
* :class:`StepLogger` — wall-clock + simulated-time progress lines.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.solver import water as W

__all__ = ["balance_report", "trace", "StepLogger"]


def balance_report(grid: Grid, params: SolverParameters, water: WaterState,
                   initial_storage: float, total_precipitation: float = 0.0,
                   total_evaporation: float = 0.0,
                   total_transpiration: float = 0.0) -> dict:
    """Per-period water balance, matching the reference's log block
    (runWaterFluxes3DModel, project3D.cpp:1365-1385)."""
    def boundary_total(btype):
        return host_read(torch.sum(torch.where(grid.btype == btype,
                                               water.boundary_flow_sum, 0.0)))

    runoff = boundary_total(BoundaryType.RUNOFF)
    free_drainage = boundary_total(BoundaryType.FREE_DRAINAGE)
    lateral = boundary_total(BoundaryType.FREE_LATERAL_DRAINAGE)

    current = host_read(W.total_water_content(grid, params, water.h, water.se))
    forecast = (initial_storage + runoff + free_drainage + lateral
                + total_precipitation - total_evaporation - total_transpiration)
    error_m3 = current - forecast
    surface_area = host_read(grid.area) * grid.n_surface_nodes
    return dict(
        water_content_m3=current,
        runoff_m3=runoff,
        free_drainage_m3=free_drainage,
        lateral_drainage_m3=lateral,
        mass_balance_error_m3=error_m3,
        mass_balance_error_mm=error_m3 / surface_area * 1000.0,
        whole_period_mbr=host_read(water.balance_whole.mbr),
    )


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/criteria3d_trace"):
    """Profile a block with ``torch.profiler`` (the card's kernels when
    CUDA is available) and write its Chrome trace (``trace.json``, for
    chrome://tracing or Perfetto) under ``log_dir``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepLogger:
    """Progress lines like the reference's 600-simulated-seconds cadence
    (project3D.cpp:1351-1358)."""

    def __init__(self, log_fn=print, every_sim_seconds: float = 600.0):
        self.log_fn = log_fn
        self.every = every_sim_seconds
        self._last_logged = 0.0
        self._wall_start = time.time()

    def step(self, sim_seconds: float, **metrics):
        if sim_seconds - self._last_logged >= self.every:
            self._last_logged = sim_seconds
            wall = time.time() - self._wall_start
            extra = " ".join(f"{k}={v:.3g}" for k, v in metrics.items())
            minutes = int(sim_seconds // 60)
            self.log_fn(f"[{wall:8.1f}s wall] simulated {minutes} min {extra}")
