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
  Chrome trace (where JAX wraps ``jax.profiler``), with the state
  machines' unit clock on and its units drawn as a track of their own
  (:func:`add_unit_track`); :func:`unit_track_checks` holds that track
  against the drivers' host ranges;
* :class:`StepLogger` — wall-clock + simulated-time progress lines.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time

import torch

from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import water as W

__all__ = ["balance_report", "trace", "add_unit_track", "unit_track_checks",
           "UNIT_TRACK", "StepLogger"]

# the track of the state machines' units in a trace (add_unit_track)
UNIT_TRACK = "c3d units"
_UNIT_TID = 900_000


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
    chrome://tracing or Perfetto) under ``log_dir``, the state machines'
    unit clock on (``device_loop.unit_clock``) and its periods' launches
    and units added to the trace by :func:`add_unit_track`. Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with device_loop.unit_clock() as clock:
        prof.start()
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            path = os.path.join(log_dir, "trace.json")
            prof.export_chrome_trace(path)
            add_unit_track(path, clock)


def _spans(events, name):
    """The complete events called ``name``, by start, without the
    profiler's copies of host ranges on the card's streams."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("name") == name
                   and e.get("cat") != "gpu_user_annotation"), key=lambda e: e["ts"])


def _inside(e, outer) -> bool:
    return outer["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= outer["ts"] + outer["dur"]


def add_unit_track(path: str, clock) -> list:
    """Add a unit clock's periods (``device_loop.UnitClock``) to the Chrome
    trace at ``path``: on a track called :data:`UNIT_TRACK` beside the
    anchor's (the card's stream, or the host thread of the eager driver),
    each launch (``c3d.launch``) and in it each unit, named as the machine
    names it, with its period, launch and layer. A period is placed by its
    anchor (``device_loop.ANCHOR``): the anchor's start in the trace less
    its reading, to within the anchor's duration. Every ``c3d.period``
    range gets its period's serial number in its args, and so does every
    other ``c3d.*`` range inside it. Returns ``(serial, uncertainty [us])``
    of each period placed, and prints them."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    anchors = _spans(events, device_loop.ANCHOR)
    anchored = [p for p in clock.periods if p.anchor_ns is not None]
    periods = _spans(events, "c3d.period")
    # the serial numbers of the periods' ranges follow from one period
    # whose anchor lies in its range: every period opens one range
    for rec, anchor in zip(anchored, anchors):
        at = next((k for k, sp in enumerate(periods) if _inside(anchor, sp)), None)
        if at is not None:
            for k, sp in enumerate(periods):
                sp.setdefault("args", {})["period"] = rec.serial - at + k
            break
    placed, tracks, added = [], set(), []
    for rec, anchor in zip(anchored, anchors):
        pid = anchor["pid"]
        tracks.add(pid)

        def at_us(ns, anchor=anchor, rec=rec):
            return anchor["ts"] + (ns - rec.anchor_ns) / 1000.0
        for k, (t0, t1) in enumerate(rec.launches):
            launch = rec.n_launches - len(rec.launches) + k
            added.append(dict(ph="X", cat="c3d_launch", name="c3d.launch", pid=pid,
                              tid=_UNIT_TID, ts=at_us(t0), dur=(t1 - t0) / 1000.0,
                              args=dict(period=rec.serial, launch=launch,
                                        driver=rec.driver)))
        for code, t0, t1, launch in rec.events.tolist():
            name = rec.names.get(code, f"phase {code}")
            added.append(dict(ph="X", cat="c3d_unit", name=name, pid=pid, tid=_UNIT_TID,
                              ts=at_us(t0), dur=(t1 - t0) / 1000.0,
                              args=dict(period=rec.serial, launch=launch,
                                        layer=device_loop.layer_of(name))))
        placed.append((rec.serial, anchor.get("dur", 0.0)))
        print(f"# {UNIT_TRACK}: period {rec.serial} ({rec.driver} driver, "
              f"{len(rec.events)} units, {rec.dropped} dropped) placed to within "
              f"{anchor.get('dur', 0.0)} us", flush=True)
    for sp in periods:
        serial = sp.get("args", {}).get("period")
        if serial is None:
            continue
        for e in events:
            if (e.get("ph") == "X" and str(e.get("name", "")).startswith("c3d.driver.")
                    and e.get("cat") != "gpu_user_annotation" and _inside(e, sp)):
                e.setdefault("args", {})["period"] = serial
    for pid in sorted(tracks, key=str):
        added.append(dict(ph="M", name="thread_name", pid=pid, tid=_UNIT_TID,
                          args=dict(name=UNIT_TRACK)))
    events.extend(added)
    with open(path, "w") as f:
        json.dump(doc, f)
    return placed


def _union(spans):
    """The union of ``(start, end)`` spans, merged, by start."""
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def unit_track_checks(path: str, min_gap_us: float = 50.0) -> dict:
    """Hold a trace written by :func:`trace` to the drivers' host ranges.
    For each launch on the :data:`UNIT_TRACK` track: its first unit's start
    less the start of its ``c3d.driver.launch`` range (the k-th of its
    period; >= 0 when the units follow the launch), and its last unit's end
    less the end of the ``c3d.driver.status_read`` range that follows
    (<= 0 when the read waited for them), both [us]. And every gap of at least ``min_gap_us`` in the card's
    activity (its kernels, copies and fills, and the track's launches) with
    the innermost ``c3d.*`` host range that holds it whole (None: none
    does). Returns ``dict(launches=[...], gaps=[...])``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    complete = [e for e in events if e.get("ph") == "X"]
    host = [e for e in complete if str(e.get("name", "")).startswith("c3d.")
            and e.get("cat") not in ("c3d_launch", "gpu_user_annotation")]
    units = [e for e in complete if e.get("cat") == "c3d_unit"]
    launches = [e for e in complete if e.get("cat") == "c3d_launch"]
    out = []
    for ln in sorted(launches, key=lambda e: e["ts"]):
        serial, k = ln["args"]["period"], ln["args"]["launch"]
        mine = [u for u in units if u["args"]["period"] == serial
                and u["args"]["launch"] == k]
        if not mine:
            continue
        of_period = sorted((e for e in host if e.get("args", {}).get("period") == serial),
                           key=lambda e: e["ts"])
        opens = [e["ts"] for e in of_period if e["name"] == "c3d.driver.launch"]
        if k >= len(opens):
            continue
        read = next((e for e in of_period if e["name"] == "c3d.driver.status_read"
                     and e["ts"] + e["dur"] >= opens[k]), None)
        last = max(u["ts"] + u["dur"] for u in mine)
        out.append(dict(period=serial, launch=k, driver=ln["args"].get("driver"),
                        after_launch_us=min(u["ts"] for u in mine) - opens[k],
                        before_read_end_us=(None if read is None
                                            else last - read["ts"] - read["dur"])))
    device = [(e["ts"], e["ts"] + e["dur"]) for e in complete
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device += [(e["ts"], e["ts"] + e["dur"]) for e in launches]
    busy = _union(device)
    gaps = []
    starts = sorted(host, key=lambda e: e["ts"])
    keys = [e["ts"] for e in starts]
    for (_, lo), (hi, _) in zip(busy, busy[1:]):
        if hi - lo < min_gap_us:
            continue
        holders = [e for e in starts[:bisect.bisect_right(keys, lo)]
                   if e["ts"] + e["dur"] >= hi]
        inner = min(holders, key=lambda e: e["dur"], default=None)
        gaps.append(dict(start_us=lo, us=hi - lo,
                         span=None if inner is None else inner["name"]))
    return dict(launches=out, gaps=gaps)


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
