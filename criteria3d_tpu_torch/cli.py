"""Console shell / batch interface.

PyTorch counterpart of ``criteria3d_tpu/cli.py``, the reference's console
shell and batch mode (agrolib/project/shell.h:20-31,
Crit3DProject::criteria3DShell / criteria3DBatch /
executeCriteria3DCommand, bin/CRITERIA3D/criteria3DProject.cpp:3518-3713),
with every command of the JAX package's. The model builds on the CUDA card
(``python -m criteria3d_tpu_torch.cli --device cpu script.txt`` runs it on
the CPU); a command that fails prints ``ERROR: <reason>`` and the shell
goes on, as the reference's does. Every read of the card's state (maps,
totals, MBRs) goes through ``device.host_read`` / ``host_array``, so the
counts are true.

Commands (case-insensitive; shared + CRITERIA3D sets):

    PROJ <path.ini> [meteo_db]   load a full project (DEM, soil map/DB,
                                 land use, meteo points, output points)
    DEM <path.flt>               load a DEM directly (cmdLoadDEM)
    POINT <db>                   load/list a meteo points DB (cmdOpenDbPoint)
    GRID <xml>                   load a meteo grid (cmdLoadMeteoGrid)
    LOG <file>                   tee output to a log file (cmdSetLogFile)
    INITIALIZE                   build the 3-D grid + initial state
    RUN <hours> [YYYY-MM-DDTHH | rain_mmh]
                                 run the model; with a loaded meteo DB the
                                 weather is interpolated from the stations,
                                 else uniform synthetic forcing
    DAILYCSV <point_id> <out.csv>    export a station's daily series
    HOURLYCSV <point_id> <out.csv>   export a station's hourly series
    EXPORTPNG <var> <out.png> [scale]
                                 color-scale quick-look PNG of a raster
                                 (dem | swc | pond; reference color.cpp
                                 scales, headless GUI substitute)
    CHART <point_id> <out.png> [VAR ...]
                                 station time-series chart (meteoWidget
                                 analogue, headless)
    PROXY <out.png> [VAR] [YYYY-MM-DDTHH]
                                 value-vs-elevation scatter + lapse line
                                 (proxyWidget analogue)
    MAP <out.png> [var] [scale]  slope-shaded map composite with station
                                 markers + legend (mapGraphics analogue)
    VIEW3D <out.png> [var] [rot] [tilt]
                                 oblique 3-D terrain render (the OpenGL
                                 viewer analogue, headless)
    REPORT <out.html>            standalone HTML run report (maps, 3-D
                                 view, state tables; data-URI PNGs)
    ANIM <out.png> <hours> [var] [rain_mm_h]
                                 run + animate hourly maps as one APNG
                                 (the GUI's live canvas refresh)
    STATE SAVE <dir> | STATE LOAD <dir>
    INFO                         grid/state summary
    LS                           list project .ini files under cwd
    VERSION                      print version
    QUIT / EXIT                  leave the shell

Batch mode: ``python -m criteria3d_tpu_torch.cli [--device cpu] script.txt``
executes one command per line ('#' comments), like the reference's batch
files. Without a card and without ``--device cpu`` it stops with the
message of ``device.resolve_device``; it never picks the CPU on its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import shlex
import sys

import numpy as np
import torch

import criteria3d_tpu_torch
from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.device import host_read, resolve_device

PROMPT = "criteria3d-tpu> "


class Shell:
    """The command interpreter. ``device`` is where INITIALIZE builds the
    model: None means the CUDA card (raising where there is none)."""

    def __init__(self, device=None):
        self.device = device
        self.config = None
        self.project = None       # Criteria3DProject when PROJ loaded
        self.grid = None
        self.params = None
        self.model = None
        self.dem = None
        self.cell_size = None
        self.raster_header = None
        self.stations = []
        self.meteo_grid = None
        self.fast = False         # mixed-precision production path (FAST)
        self._log_file = None

    def _print(self, msg: str):
        print(msg)
        if self._log_file:
            with open(self._log_file, "a") as f:
                f.write(msg + "\n")

    # ------------------------------------------------------------------
    def execute(self, line: str) -> bool:
        """Run one command line; returns False to quit."""
        parts = shlex.split(line, comments=True)
        if not parts:
            return True
        cmd = parts[0].upper()
        args = parts[1:]
        try:
            if cmd in ("QUIT", "EXIT"):
                return False
            elif cmd == "VERSION":
                self._print(f"criteria3d_tpu_torch {criteria3d_tpu_torch.__version__}")
            elif cmd == "PROJ":
                self._cmd_proj(args)
            elif cmd == "DEM":
                self._cmd_dem(args)
            elif cmd == "POINT":
                self._cmd_point(args)
            elif cmd == "GRID":
                self._cmd_grid(args)
            elif cmd == "LOG":
                self._cmd_log(args)
            elif cmd in ("INITIALIZE", "INIT"):
                self._cmd_initialize()
            elif cmd == "FAST":
                self._cmd_fast(args)
            elif cmd == "RUN":
                self._cmd_run(args)
            elif cmd in ("DAILYCSV", "HOURLYCSV"):
                self._cmd_export_csv(cmd, args)
            elif cmd == "EXPORTPNG":
                self._cmd_export_png(args)
            elif cmd == "MAP":
                self._cmd_map(args)
            elif cmd == "VIEW3D":
                self._cmd_view3d(args)
            elif cmd == "REPORT":
                self._cmd_report(args)
            elif cmd == "CHART":
                self._cmd_chart(args)
            elif cmd == "PROXY":
                self._cmd_proxy(args)
            elif cmd == "ANIM":
                self._cmd_anim(args)
            elif cmd == "STATE":
                self._cmd_state(args)
            elif cmd == "INFO":
                self._cmd_info()
            elif cmd == "LS":
                self._cmd_ls()
            elif cmd == "?":
                self._print(__doc__.split("Commands", 1)[1])
            else:
                self._print(f"Invalid command: {cmd}")
        except Exception as exc:  # shell robustness, like the reference's
            self._print(f"ERROR: {exc}")
        return True

    # ------------------------------------------------------------------
    def _cmd_proj(self, args):
        from criteria3d_tpu_torch.project import Criteria3DProject
        if not args:
            self._print("Usage: PROJ <project.ini> [meteo_db]")
            return
        meteo_db = args[1] if len(args) > 1 else None
        out_dir = os.path.join(os.getcwd(), "OUTPUT")
        self.project = Criteria3DProject.load(args[0],
                                              meteo_db_path=meteo_db,
                                              output_dir=out_dir)
        self.config = self.project.config
        self.dem = np.where(
            np.isclose(self.project.dem, self.project.header.nodata),
            NODATA, self.project.dem)
        self.cell_size = self.project.header.cellsize
        self.raster_header = self.project.header
        self.stations = self.project.stations
        valid = (~np.isclose(self.dem, NODATA)).sum()
        self._print(f"Project: {self.config.name}  DEM {self.dem.shape} "
                    f"({valid} cells)  soils={len(self.project.soils)}  "
                    f"stations={len(self.stations)}")
        for w in getattr(self.project, "warnings", []):
            self._print(f"  warning: {w}")

    def _cmd_dem(self, args):
        from criteria3d_tpu_torch.io.esri import read_raster
        if not args:
            self._print("Usage: DEM <path.flt>")
            return
        self.dem, hdr = read_raster(args[0])
        self.cell_size = hdr.cellsize
        self.raster_header = hdr
        self.project = None
        valid = (~np.isclose(self.dem, hdr.nodata)).sum()
        self._print(f"DEM: {self.dem.shape}, cell {hdr.cellsize} m, "
                    f"{valid} valid cells")

    def _cmd_point(self, args):
        from criteria3d_tpu_torch.io.meteopoints import MeteoPointsDB
        if not args:
            self._print("Usage: POINT <meteo_points.db>")
            return
        with MeteoPointsDB(args[0]) as db:
            self.stations = db.read_stations(load_hourly=True)
        for st in self.stations:
            span = st.hourly_span
            span_s = (f"{span[0]:%Y-%m-%d}..{span[1]:%Y-%m-%d}"
                      if span else "no hourly data")
            self._print(f"  {st.id}: lat={st.latitude:.4f} "
                        f"alt={st.altitude:.0f} m  {span_s}")
        if self.project is not None:
            self.project.stations = self.stations

    def _cmd_grid(self, args):
        from criteria3d_tpu_torch.io.meteogrid import parse_grid_xml
        if not args:
            self._print("Usage: GRID <grid.xml>")
            return
        self.meteo_grid = parse_grid_xml(args[0])
        g = self.meteo_grid
        self._print(f"Meteo grid: {g.nr_rows}x{g.nr_cols} cells")

    def _cmd_log(self, args):
        if not args:
            self._print("Usage: LOG <file>")
            return
        os.makedirs(os.path.dirname(os.path.abspath(args[0])), exist_ok=True)
        self._log_file = args[0]
        self._print(f"Logging to {args[0]}")

    def _cmd_fast(self, args):
        """FAST [ON|OFF]: toggle the mixed-precision f32-sweep production
        path (the reference shell's GPU-solver/SETTHREADNR analogue; takes
        effect at the next INITIALIZE)."""
        if args:
            self.fast = args[0].upper() in ("ON", "1", "TRUE")
        self._print(f"fast mode: {'ON' if self.fast else 'OFF'}"
                    + ("" if self.model is None else "  (re-run INITIALIZE)"))

    def _cmd_initialize(self):
        if self.project is not None:
            self.project.initialize(fast=self.fast, device=self.device)
            self.grid = self.project.grid
            self.params = self.project.params
            self.model = self.project.model
            self._print(f"3D model initialized: {self.grid.n_layers} layers, "
                        f"{self.grid.n_nodes} nodes")
            return
        from criteria3d_tpu_torch import Grid, SoilFields, SolverParameters
        from criteria3d_tpu_torch.model import Criteria3DModel, ModelConfig
        if self.dem is None:
            self._print("Load a DEM first (DEM or PROJ).")
            return
        cfg = self.config
        soil = SoilFields.uniform(self.dem.shape, vg_alpha=1.0, vg_n=1.4,
                                  vg_he=0.02, theta_s=0.43, theta_r=0.05,
                                  k_sat=1e-5, device=self.device)
        grid = Grid.build(self.dem, self.cell_size, soil,
                          total_depth=(cfg.imposed_computation_depth
                                       if cfg else 1.0), device=self.device)
        params = (cfg.solver_parameters(self.cell_size) if cfg
                  else SolverParameters())
        if self.fast:
            # as the JAX shell: float32 sweeps with CG under the default
            # (diagonal) preconditioner, not fast_f32()'s line preconditioner
            params = dataclasses.replace(params, sweep_dtype=torch.float32,
                                         inner_solver="cg")
        mconfig = ModelConfig(
            latitude=cfg.latitude if cfg else 44.5,
            longitude=cfg.longitude if cfg else 11.3)
        psi0 = cfg.initial_water_potential if cfg else -2.0
        self.model = Criteria3DModel.create(grid, params, mconfig,
                                            matric_potential=psi0)
        self.grid, self.params = grid, params
        self._print(f"3D model initialized: {grid.n_layers} layers, "
                    f"{grid.n_nodes} nodes")

    def _uniform_forcing(self, rain: float):
        """RUN's and ANIM's DEM-only forcing: uniform float64 maps on the
        grid's device."""
        from criteria3d_tpu_torch.model import HourlyForcing
        shape = self.grid.shape[1:]

        def f(v):
            return torch.full(shape, v, dtype=torch.float64,
                              device=self.grid.device)
        return HourlyForcing(air_temperature=f(15.0), precipitation=f(rain),
                             rel_humidity=f(70.0), wind_speed=f(2.0))

    def _cmd_run(self, args):
        if self.model is None:
            self._print("INITIALIZE first.")
            return
        if not args:
            self._print("Usage: RUN <hours> [YYYY-MM-DDTHH | rain_mm_h]")
            return
        hours = int(args[0])

        # project + stations: the real interpolated cycle with outputs
        if self.project is not None and self.project.stations and \
                any(st.hourly for st in self.project.stations):
            if len(args) > 1:
                start = datetime.datetime.fromisoformat(args[1])
            else:
                span = next(st.hourly_span for st in self.project.stations
                            if st.hourly_span)
                start = span[0]
            log = self.project.run_period(start, hours)
            for entry in log:
                self._print(f"{entry['time']}: MBR={entry['mbr']:.2e}")
            self._print(f"outputs in {self.project.output_dir}")
            return

        # DEM-only fallback: uniform synthetic forcing
        rain = float(args[1]) if len(args) > 1 else 0.0
        for h in range(hours):
            out = self.model.run_hour(self._uniform_forcing(rain), 2023, 6, 15,
                                      h % 24)
            self._print(f"hour {h}: MBR={host_read(out['mbr']):.2e} "
                        f"courant={host_read(out['courant']):.2f}")

    def _cmd_export_csv(self, cmd, args):
        """cmdExportDailyDataCsv / cmdExportHourlyDataCsv analogues."""
        import csv
        if len(args) < 2:
            self._print(f"Usage: {cmd} <point_id> <out.csv>")
            return
        pid, path = args[0], args[1]
        st = next((s for s in self.stations if s.id == pid), None)
        if st is None:
            self._print(f"Unknown point: {pid} "
                        f"(loaded: {[s.id for s in self.stations]})")
            return
        daily = cmd == "DAILYCSV"
        block = st.daily if daily else st.hourly
        t0 = st.daily_d0 if daily else st.hourly_t0
        if not block or t0 is None:
            self._print("No data loaded for this point.")
            return
        variables = sorted(block, key=lambda v: v.name)
        n = max(len(v) for v in block.values())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["time"] + [v.name for v in variables])
            for i in range(n):
                when = t0 + (datetime.timedelta(days=i) if daily
                             else datetime.timedelta(hours=i))
                row = [when.isoformat()]
                for v in variables:
                    series = block[v]
                    val = series[i] if i < len(series) else NODATA
                    row.append("" if val == NODATA else f"{val:g}")
                w.writerow(row)
        self._print(f"wrote {n} rows to {path}")

    def _raster_for(self, var: str):
        """(data, default_scale) for a renderable variable name, or
        (None, None); the state maps come from the card through
        :func:`criteria3d_tpu_torch.project.state_maps`."""
        if var == "dem" and self.dem is not None:
            return self.dem, "dtm"
        if self.model is not None:
            from criteria3d_tpu_torch.project import state_maps
            if var in ("swc", "water_content"):
                return (state_maps(self.grid, self.params, self.model.water)[0],
                        "surface_water")
            if var in ("pond", "surface_water"):
                return (state_maps(self.grid, self.params, self.model.water)[1],
                        "surface_water")
        return None, None

    def _cmd_export_png(self, args):
        """Headless color-scale quick-look of a raster variable
        (EXPORTPNG <variable> <out.png> [scale] — the GUI-less analogue of
        the reference's map canvas; agrolib/gis/color.cpp scales)."""
        from criteria3d_tpu_torch.io.quicklook import COLOR_SCALES, write_png_raster
        if len(args) < 2:
            self._print("Usage: EXPORTPNG <dem|swc|pond|wt> <out.png> "
                        f"[scale: {'|'.join(sorted(COLOR_SCALES))}]")
            return
        var, path = args[0].lower(), args[1]
        data, default_scale = self._raster_for(var)
        scale = args[2] if len(args) > 2 else default_scale
        if data is None:
            self._print(f"nothing to render for '{var}' "
                        "(load a DEM / initialize a model first)")
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        rng = write_png_raster(path, data, scale or "default")
        self._print(f"wrote {path} [{rng['vmin']:.3g}..{rng['vmax']:.3g}]"
                    f" scale={scale}")

    def _cmd_chart(self, args):
        """CHART <point_id> <out.png> [VAR ...] — time-series chart of a
        station's loaded hourly (or daily) data; the meteoWidget analogue
        (agrolib/meteoWidget/meteoWidget.cpp), headless."""
        from criteria3d_tpu_torch.viz import line_chart
        if len(args) < 2:
            self._print("Usage: CHART <point_id> <out.png> [VAR ...]")
            return
        pid, path = args[0], args[1]
        st = next((s for s in self.stations if s.id == pid), None)
        if st is None:
            self._print(f"Unknown point: {pid} "
                        f"(loaded: {[s.id for s in self.stations]})")
            return
        block, t0, step = st.hourly, st.hourly_t0, datetime.timedelta(hours=1)
        if not block:
            block, t0, step = st.daily, st.daily_d0, datetime.timedelta(days=1)
        if not block or t0 is None:
            self._print("No data loaded for this point.")
            return
        wanted = [a.upper() for a in args[2:]]
        series = {}
        for var, vals in sorted(block.items(), key=lambda kv: kv[0].name):
            if wanted and var.name not in wanted \
                    and var.value.upper() not in wanted:
                continue
            y = np.where(np.isclose(np.asarray(vals, np.float64), NODATA),
                         np.nan, np.asarray(vals, np.float64))
            t = [t0 + i * step for i in range(len(y))]
            series[var.name] = (t, y)
            if len(series) >= 6 and not wanted:
                break
        if not series:
            self._print(f"no matching variables "
                        f"(have: {[v.name for v in block]})")
            return
        cv = line_chart(series, title=f"{st.id} {st.name}".strip())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cv.save(path)
        self._print(f"wrote {path} ({len(series)} series)")

    def _cmd_anim(self, args):
        """ANIM <out.png> <hours> [var] [rain_mm_h] — run the model and
        write an APNG of the hourly variable maps (the GUI's live canvas
        refresh, viz/animate.py). Uses the synthetic uniform forcing of
        RUN's DEM-only mode; range fixed across frames."""
        from criteria3d_tpu_torch.viz import animate_maps
        if len(args) < 2:
            self._print("Usage: ANIM <out.png> <hours> [swc|pond] "
                        "[rain_mm_h]")
            return
        if self.model is None:
            self._print("INITIALIZE first.")
            return
        path, hours = args[0], int(args[1])
        if hours < 1:
            self._print("Usage: ANIM <out.png> <hours> [swc|pond] "
                        "[rain_mm_h] — hours must be >= 1")
            return
        var = args[2].lower() if len(args) > 2 else "pond"
        rain = float(args[3]) if len(args) > 3 else 5.0
        rasters, labels = [], []
        for h in range(hours):
            out = self.model.run_hour(self._uniform_forcing(rain), 2023, 6, 15,
                                      h % 24)
            data, scale = self._raster_for(var)
            if data is None:
                self._print(f"nothing to render for '{var}'")
                return
            rasters.append(np.asarray(data))
            labels.append(f"{var.upper()} H+{h + 1}")
            self._print(f"hour {h}: MBR={host_read(out['mbr']):.2e}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        n = animate_maps(path, self.dem, self.cell_size or 1.0, rasters,
                         labels=labels, overlay_scale=scale,
                         header=self.raster_header)
        self._print(f"wrote {path} ({n} frames)")

    def _cmd_proxy(self, args):
        """PROXY <out.png> [VAR] [YYYY-MM-DDTHH] — station value vs
        elevation scatter with the least-squares lapse line; the
        proxyWidget analogue (agrolib/proxyWidget/proxyWidget.cpp)."""
        from criteria3d_tpu_torch.core.meteo import MeteoVariable
        from criteria3d_tpu_torch.viz import scatter_chart
        if not args:
            self._print("Usage: PROXY <out.png> [VAR] [YYYY-MM-DDTHH]")
            return
        if not self.stations:
            self._print("load a meteo points DB first (POINT/PROJ)")
            return
        path = args[0]
        var = MeteoVariable[args[1].upper()] if len(args) > 1 \
            else MeteoVariable.AIR_TEMPERATURE
        when = (datetime.datetime.fromisoformat(args[2])
                if len(args) > 2 else None)
        xs, ys = [], []
        for st in self.stations:
            series = st.hourly.get(var)
            if series is None or st.hourly_t0 is None:
                continue
            idx = 0 if when is None else int(
                (when - st.hourly_t0).total_seconds() // 3600)
            if not 0 <= idx < len(series):
                continue
            v = float(series[idx])
            if np.isclose(v, NODATA):
                continue
            xs.append(st.altitude)
            ys.append(v)
        if len(xs) < 2:
            self._print(f"need >=2 stations with {var.name} data "
                        f"(got {len(xs)})")
            return
        cv = scatter_chart(xs, ys, xlabel="ELEVATION [M]", ylabel=var.name,
                           title=f"PROXY {var.name}")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cv.save(path)
        self._print(f"wrote {path} ({len(xs)} stations)")

    def _cmd_map(self, args):
        """MAP <out.png> [var] [scale] — slope-shaded map composite
        (hillshade DEM base + variable overlay + station markers + legend;
        the mapGraphics canvas analogue, viz/mapview.py)."""
        from criteria3d_tpu_torch.viz import render_map
        if not args:
            self._print("Usage: MAP <out.png> [dem|swc|pond] [scale]")
            return
        if self.dem is None:
            self._print("load a DEM first (DEM/PROJ)")
            return
        path = args[0]
        var = args[1].lower() if len(args) > 1 else "dem"
        overlay = None
        overlay_scale = "default"
        if var != "dem":
            overlay, overlay_scale = self._raster_for(var)
            if overlay is None:
                self._print(f"nothing to render for '{var}'")
                return
        if len(args) > 2:
            overlay_scale = args[2]
        cv = render_map(self.dem, self.cell_size or 1.0,
                        header=self.raster_header, overlay=overlay,
                        overlay_scale=overlay_scale,
                        points=self.stations or None,
                        title=var.upper())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cv.save(path)
        self._print(f"wrote {path} ({cv.width}x{cv.height})")

    def _cmd_view3d(self, args):
        """VIEW3D <out.png> [var] [rotation_deg] [tilt_deg] — oblique 3-D
        terrain render (the bin/CRITERIA3D OpenGL viewer analogue,
        viz/view3d.py)."""
        from criteria3d_tpu_torch.viz import render_surface3d
        if not args:
            self._print("Usage: VIEW3D <out.png> [dem|swc|pond] "
                        "[rotation_deg] [tilt_deg]")
            return
        if self.dem is None:
            self._print("load a DEM first (DEM/PROJ)")
            return
        path = args[0]
        var = args[1].lower() if len(args) > 1 else "dem"
        overlay = None
        overlay_scale = "default"
        if var != "dem":
            overlay, overlay_scale = self._raster_for(var)
            if overlay is None:
                self._print(f"nothing to render for '{var}'")
                return
        rot = float(args[2]) if len(args) > 2 else 20.0
        tilt = float(args[3]) if len(args) > 3 else 55.0
        cv = render_surface3d(self.dem, self.cell_size or 1.0,
                              overlay=overlay, overlay_scale=overlay_scale,
                              rotation_deg=rot, tilt_deg=tilt,
                              title=var.upper())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        cv.save(path)
        self._print(f"wrote {path} ({cv.width}x{cv.height})")

    def _state_totals(self) -> tuple[float, float]:
        """(total water content [m3], dt_curr [s]) read from the card."""
        from criteria3d_tpu_torch.solver import water as W
        w = self.model.water
        return (host_read(W.total_water_content(self.grid, self.params, w.h, w.se)),
                host_read(w.dt_curr))

    def _cmd_report(self, args):
        """REPORT <out.html> — standalone HTML run report: map + 3-D view
        + state summary tables (viz/report.py)."""
        from criteria3d_tpu_torch.viz import HtmlReport, render_map, render_surface3d
        if not args:
            self._print("Usage: REPORT <out.html>")
            return
        if self.dem is None:
            self._print("load a DEM first (DEM/PROJ)")
            return
        path = args[0]
        name = self.config.name if self.config is not None else "criteria3d"
        rep = HtmlReport(f"{name} — run report")
        rep.section("Terrain")
        rep.figure(render_map(self.dem, self.cell_size or 1.0,
                              header=self.raster_header,
                              points=self.stations or None, title="DEM"),
                   "Slope-shaded DEM with meteo stations")
        rep.figure(render_surface3d(self.dem, self.cell_size or 1.0,
                                    rotation_deg=20.0), "Oblique 3-D view")
        for var, caption in (("swc", "Root-zone water content"),
                             ("pond", "Surface water [mm]")):
            data, sc = self._raster_for(var)
            if data is not None:
                rep.section(caption)
                rep.figure(render_map(self.dem, self.cell_size or 1.0,
                                      header=self.raster_header,
                                      overlay=data, overlay_scale=sc,
                                      title=var.upper()), caption)
        if self.model is not None:
            g = self.grid
            twc, dt = self._state_totals()
            rep.section("State")
            rep.table([["grid", f"{g.shape}"],
                       ["nodes", g.n_nodes],
                       ["total water content [m3]", f"{twc:.2f}"],
                       ["dt_curr [s]", f"{dt:.0f}"]],
                      header=["quantity", "value"])
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        rep.write(path)
        self._print(f"wrote {path}")

    def _cmd_state(self, args):
        from criteria3d_tpu_torch.io.state_io import load_state, save_state
        if len(args) < 2:
            self._print("Usage: STATE SAVE|LOAD <dir>")
            return
        op, path = args[0].upper(), args[1]
        if self.model is None:
            self._print("INITIALIZE first.")
            return
        if op == "SAVE":
            save_state(path, self.grid, self.model.water,
                       snow=self.model.snow, degree_days=self.model.degree_days,
                       lai=self.model.lai)
            self._print(f"State saved to {path}")
        elif op == "LOAD":
            water, snow, extras = load_state(path, self.grid, self.params)
            self.model.water = water
            if snow is not None:
                self.model.snow = snow
            if "degreeDays" in extras:
                self.model.degree_days = extras["degreeDays"]
            if "lai" in extras:
                self.model.lai = extras["lai"]
            self._print(f"State loaded from {path}")

    def _cmd_info(self):
        if self.grid is None:
            self._print("No model loaded.")
            return
        g = self.grid
        self._print(f"grid: {g.shape} ({g.n_nodes} nodes, "
                    f"{g.n_surface_nodes} surface)")
        if self.model is not None:
            twc, dt = self._state_totals()
            self._print(f"total water content: {twc:.2f} m3")
            self._print(f"dt_curr: {dt:.0f} s")

    def _cmd_ls(self):
        """List project ini files below the working directory (cmdList/LS)."""
        for root, dirs, files in os.walk(os.getcwd()):
            dirs[:] = [d for d in dirs if not d.startswith(".")][:50]
            for f in files:
                if f.endswith(".ini"):
                    self._print(os.path.relpath(os.path.join(root, f)))


def main(argv=None):
    """Batch mode with a script, else the interactive shell. The model
    builds on the CUDA card unless ``--device cpu`` is given; without a card
    and without it, the shell stops before its first command with the
    message of ``device.resolve_device`` (exit code 2)."""
    ap = argparse.ArgumentParser(prog="criteria3d-torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="build the model on the CPU instead of the CUDA card")
    ap.add_argument("script", nargs="?", help="batch file, one command a line")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"criteria3d-torch: {exc}", file=sys.stderr)
        return 2
    shell = Shell(device=device)
    if args.script:
        # batch mode
        with open(args.script) as f:
            for line in f:
                print(PROMPT + line.rstrip())
                if not shell.execute(line):
                    break
    else:
        while True:
            try:
                line = input(PROMPT)
            except EOFError:
                break
            if not shell.execute(line):
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
