"""The port's benchmark: wall seconds per simulated hour of the storm on
the catchment, on the CUDA card.

    python -m criteria3d_tpu_torch.bench

Counterpart of the repository's ``bench.py``, with the same legs, the same
environment variables read the same way, the same sampling rule and one
JSON line with every key of ``bench.py``'s:

- the storm leg (the main metric): one simulated hour of a 20 mm/h storm
  from psi -2 m under ``SolverParameters.fast_f32()`` (CG with the
  vertical-line preconditioner; ``BENCH_PALLAS=1`` the CUDA bundle,
  ``BENCH_CG=0`` per-sweep Jacobi, ``BENCH_CG_PRECOND`` the
  preconditioner, ``BENCH_MODE=ref`` the float64 path), on the DEM coarsened
  ``BENCH_COARSEN`` times; the median of up to 5 runs, stopping once the two
  fastest are within 5 % or after a run past 60 s;
- the day leg (``BENCH_DAY``, default on): 24 chained hours at coarsen
  ``BENCH_DAY_COARSEN`` (4), each 6 periods of 600 s, the rain stopped
  from hour 3; a failure prints ``# sim-day leg failed`` and leaves its keys
  out, as in ``bench.py``;
- the coupled leg (``BENCH_HEAT``): the storm hour with soil heat, vapor,
  every valid layer-1 node a HeatSurface, ``heat_frozen_props`` unless
  ``BENCH_HEAT_FROZEN=0``; up to 3 runs;
- the mesh leg (``BENCH_PALLAS_LEG``, skipped when the storm leg already
  runs the bundle): the bundle hour on a (1, 1) mesh, the grid and state
  cut by ``shard_pytree`` and joined by ``gather_pytree``; up to 3 runs.

Each leg's periods run under the graph driver on the card (the water or
coupled period's state machine as CUDA graphs, solver/device_loop.py; the
mesh leg's on the blocks of its one card); before a leg's timed runs a
zero-length period captures the graphs, and the line gives each leg's
driver, the units per launch and the capture seconds. Each run ends in
``torch.cuda.synchronize()`` and the read of its MBR. The
DEM is Ravone's where the C++ reference's data is at ``RAVONE``, else
``problems.synthetic_catchment(0)`` at Ravone's scale; ``vs_baseline`` and
``reference_cpu_wall_s`` divide by the C++ reference's time on Ravone
(``BASELINE_REF.json``), so they are ``null`` on the synthetic catchment.
``compile_s`` is the seconds the CUDA libraries took to build at first use
(near 0 once built): nothing else is compiled. The line adds the card's
name and power limit, the DEM, host reads and bundle launches per hour,
the legs' counts, the day's stats per period and each leg's peak device
memory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import host_read, resolve_device
from criteria3d_tpu_torch.io.esri import read_flt
from criteria3d_tpu_torch.parallel.sharding import (Blocked, gather_pytree,
                                                    make_mesh, shard_pytree)
from criteria3d_tpu_torch.solver import coupled as C
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import heat as H
from criteria3d_tpu_torch.solver import jacobi_bundle as JB
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.step import compute_period_stats, restore_best_step

__all__ = ["RAVONE", "Dem", "reference_wall_s", "load_dem", "coarsen_dem",
           "build_grid", "storm_params", "sync", "sample", "storm_leg", "day_leg",
           "coupled_heat_mbr", "coupled_setup", "coupled_leg", "mesh_leg",
           "card_info", "prepare_driver", "bench", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's DEM: Ravone in the C++ reference's data
RAVONE = os.path.join(os.sep, "root", "reference", "DATA", "DEM", "DEM_Ravone.flt")


class Dem(NamedTuple):
    """A DEM before coarsening: values, nodata, cell size [m], name."""
    values: np.ndarray
    nodata: float
    cell: float
    name: str


def reference_wall_s(coarsen: int) -> float | None:
    """The C++ reference's measured wall [s / simulated hour] on Ravone at
    this coarsen level (``BASELINE_REF.json``), or None."""
    path = os.path.join(REPO, "BASELINE_REF.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        levels = json.load(f).get("levels", {})
    if str(coarsen) in levels:
        return float(levels[str(coarsen)]["ref_wall_s_per_hour"])
    return None


def load_dem() -> Dem:
    """Ravone where ``RAVONE`` exists, else the seed-0 synthetic catchment
    (768 box, 4 m cells, 2,945,852 nodes)."""
    if os.path.exists(RAVONE):
        dem, hdr = read_flt(RAVONE)
        return Dem(dem, hdr.nodata, hdr.cellsize, "ravone")
    return Dem(problems.synthetic_catchment(0), -9999.0, 4.0,
               "synthetic_catchment(seed=0)")


def coarsen_dem(dem: np.ndarray, nodata: float, coarsen: int) -> np.ndarray:
    """``bench.py``'s coarsening: trim to a multiple of ``coarsen``, the mean
    of each block's valid cells, valid where more than half the block is."""
    if coarsen <= 1:
        return dem
    R, C = dem.shape
    dem = dem[:R - R % coarsen, :C - C % coarsen]
    blocks = dem.reshape(dem.shape[0] // coarsen, coarsen,
                         dem.shape[1] // coarsen, coarsen)
    valid = ~np.isclose(blocks, nodata)
    s = np.where(valid, blocks, 0.0).sum(axis=(1, 3))
    n = valid.sum(axis=(1, 3))
    return np.where(n > coarsen * coarsen // 2, s / np.maximum(n, 1), nodata)


def build_grid(coarsen: int = 1, device=None, dem: Dem | None = None) -> Grid:
    """The benchmark's grid on ``dem`` (:func:`load_dem` when None) coarsened
    ``coarsen`` times: clay loam, 0.8 m of soil in layers of 0.04-0.25 m."""
    dem = dem or load_dem()
    return problems.catchment_grid(coarsen_dem(dem.values, dem.nodata, coarsen),
                                   dem.cell * coarsen, resolve_device(device))


def storm_params(env=os.environ) -> SolverParameters:
    """The storm leg's parameters from ``bench.py``'s variables."""
    use_pallas = env.get("BENCH_PALLAS", "0") == "1"
    inner = "jacobi" if (use_pallas or env.get("BENCH_CG", "1") != "1") else "cg"
    if env.get("BENCH_MODE", "fast") == "fast":
        return SolverParameters.fast_f32(
            use_pallas=use_pallas, inner_solver=inner,
            cg_precond=env.get("BENCH_CG_PRECOND", "line"))
    return SolverParameters(inner_solver=inner)


def sync(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev: torch.device) -> None:
    """A leg's start: the graph machine an earlier leg kept is dropped, so
    the leg's peak memory is its own."""
    device_loop.clear()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def sample(run, dev: torch.device, max_runs: int, long_s: float | None = None):
    """``bench.py``'s sampling: ``run()`` up to ``max_runs`` times, stopping
    once the two fastest are within 5 % or, with ``long_s``, after a run
    past ``long_s`` seconds (not the first). Each run is timed on the host
    clock to its end on the device. Returns ``(walls, median, last run's
    result)``."""
    runs, out = [], None
    for attempt in range(max_runs):
        t0 = time.perf_counter()
        out = run()
        sync(dev)
        runs.append(time.perf_counter() - t0)
        if long_s is not None and attempt > 0 and runs[-1] > long_s:
            break
        srt = sorted(runs)
        if len(runs) >= 2 and srt[1] <= srt[0] * 1.05:
            break
    return runs, statistics.median(runs), out


def prepare_driver(grid, params: SolverParameters, state, zero_period=None) -> dict:
    """Ahead of a leg's timed runs: a zero-length period (``zero_period()``,
    else a water period of ``state``), in which the graph or rounds driver
    builds and captures the machine (the eager driver runs no step).
    Returns the leg's driver, why it is eager (or ""), the units per launch
    and the capture seconds."""
    home = grid.mesh.home if isinstance(grid, Blocked) else grid.device
    driver, why = device_loop.driver_for(home, params.mesh)
    before = device_loop.counts()["capture_s"]
    if zero_period is None:
        compute_period_stats(grid, params, state, 0.0)
    else:
        zero_period()
    sync(home)
    return dict(driver=driver, why=why, units_per_launch=device_loop.UNITS_PER_LAUNCH,
                capture_s=device_loop.counts()["capture_s"] - before)


def _reset_counts() -> None:
    """The host-read, launch and restore counts and the drivers' counts set
    to 0, before a leg's run (after it, ``assemble_fast.launches`` and
    ``restore_best_step.count`` are that run's: :func:`_assembly_counts`)."""
    host_read.count = 0
    JB.jacobi_bundle.launches = 0
    W.assemble_fast.launches = 0
    restore_best_step.count = 0
    device_loop.reset_counts()


def _assembly_counts() -> dict:
    """The last run's assembly kernel pairs and restores."""
    return dict(assemble_launches=W.assemble_fast.launches,
                restores=restore_best_step.count)


def _hour(grid, params, state):
    """One hour with the counts set to 0 before it (:func:`_reset_counts`):
    ``(state, stats, host reads, launches, whole-period MBR, the graph
    driver's launches)``; the MBR's read is the fence."""
    _reset_counts()
    out, stats = compute_period_stats(grid, params, state, 3600.0)
    mbr = float(out.balance_whole.mbr)
    return (out, tuple(stats), host_read.count, JB.jacobi_bundle.launches, mbr,
            device_loop.counts()["launches"])


def storm_leg(grid: Grid, params: SolverParameters, max_runs: int = 5) -> dict:
    """The storm hour from the storm's initial state, sampled as ``bench.py``
    samples it (up to ``max_runs`` runs): walls, median, and the last run's
    stats, MBR, host reads, bundle launches, graph launches, assembly
    launches and restores, and final state (``out``), the leg's peak memory
    and driver (:func:`prepare_driver`)."""
    dev = grid.device
    _reset_peak(dev)
    state0 = problems.storm_state(grid, params)
    driver = prepare_driver(grid, params, state0)
    runs, wall, (out, stats, reads, launches, mbr, graph_launches) = sample(
        lambda: _hour(grid, params, state0), dev, max_runs, 60.0)
    return dict(runs_s=runs, wall_s=wall, stats=stats, mbr=mbr, host_reads=reads,
                launches=launches, graph_launches=graph_launches,
                peak_gib=_peak_gib(dev), out=out, **_assembly_counts(), **driver)


def day_leg(grid: Grid, params: SolverParameters, hours: int = 24,
            storm_hours: int = 3) -> dict:
    """``bench.py``'s simulated day: ``hours`` chained hours of 6 periods of
    600 s from the storm's initial state, the rain stopped from hour
    ``storm_hours``, each period synchronised. Each hour's wall, summed
    stats and host reads go to stderr as ``# day hour h``. Returns the
    day's wall, each hour's wall and host reads, every period's stats, the
    closing MBR (the last period's, read after the day) and the final
    state, the leg's peak memory and its driver (:func:`prepare_driver`,
    before the day's clock starts)."""
    dev = grid.device
    _reset_peak(dev)
    state = problems.storm_state(grid, params)
    driver = prepare_driver(grid, params, state)
    walls, stats, reads = [], [], []
    t0 = time.perf_counter()
    for h in range(hours):
        if h == storm_hours:
            state = dataclasses.replace(state,
                                        sink_source=torch.zeros_like(state.sink_source))
        t_h = time.perf_counter()
        host_read.count = 0
        for _ in range(6):
            state, st = compute_period_stats(grid, params, state, 600.0)
            stats.append(tuple(st))
            sync(dev)
        reads.append(host_read.count)
        walls.append(time.perf_counter() - t_h)
        hour_stats = [sum(c) for c in zip(*stats[-6:])]
        print(f"# day hour {h}: {walls[-1]:.2f}s (steps, attempts, approximations, "
              f"inner iterations {hour_stats}; host reads {reads[-1]})",
              file=sys.stderr, flush=True)
    mbr = float(state.balance_whole.mbr)
    return dict(wall_s=time.perf_counter() - t0, hour_walls_s=walls, stats=stats,
                host_reads=reads, mbr=mbr, peak_gib=_peak_gib(dev), out=state, **driver)


def coupled_heat_mbr(grid: Grid, params: SolverParameters, water, heat) -> float:
    """``bench.py``'s whole-period heat balance: (storage at the end - the
    period's initial storage - the accumulated boundary sink) / max(|sink|,
    1)."""
    st_end = H.heat_storage(grid, params, heat, water)
    return float((st_end - heat.storage_whole - heat.sink_whole)
                 / torch.clamp_min(torch.abs(heat.sink_whole), 1.0))


def coupled_setup(grid: Grid, params: SolverParameters, env=os.environ) -> tuple:
    """The coupled storm hour's inputs (``bench.py``'s heat leg): ``params``
    with heat vapor and, unless ``BENCH_HEAT_FROZEN=0``, chunk-frozen
    properties; every valid layer-1 node a HeatSurface. Returns
    ``(hparams, hgrid, water, heat, boundary)``."""
    hparams = dataclasses.replace(
        params, heat_vapor=True,
        heat_frozen_props=env.get("BENCH_HEAT_FROZEN", "1") == "1")
    return (hparams, *problems.coupled_storm(grid, hparams,
                                             problems.storm_state(grid, hparams)))


def coupled_leg(grid: Grid, params: SolverParameters, env=os.environ,
                max_runs: int = 3) -> dict:
    """The coupled storm hour of :func:`coupled_setup` on ``grid``; up to
    ``max_runs`` runs. Returns walls, median, the last run's counts
    (``coupled.counts()``), host reads, bundle launches, the graph driver's
    launches, assembly launches and restores, water and heat MBR and final
    ``(water, heat)``, the inputs
    (``inputs``: hparams, hgrid, water, heat, boundary), the leg's peak
    memory and driver (:func:`prepare_driver`)."""
    dev = grid.device
    _reset_peak(dev)
    inputs = coupled_setup(grid, params, env)
    hparams, hgrid, water0, heat0, boundary = inputs
    sync(dev)
    driver = prepare_driver(hgrid, hparams, water0, lambda: C.compute_period_coupled(
        hgrid, hparams, water0, heat0, boundary, 0.0))

    def run():
        C.reset_counts()
        _reset_counts()
        w, h = C.compute_period_coupled(hgrid, hparams, water0, heat0, boundary, 3600.0)
        heat_mbr = coupled_heat_mbr(hgrid, hparams, w, h)
        return (w, h, C.counts(), host_read.count, JB.jacobi_bundle.launches,
                device_loop.counts()["launches"], float(w.balance_whole.mbr), heat_mbr)

    runs, wall, (w, h, counts, reads, launches, graph_launches, mbr, heat_mbr) = sample(
        run, dev, max_runs)
    return dict(runs_s=runs, wall_s=wall, counts=counts, host_reads=reads,
                launches=launches, graph_launches=graph_launches, mbr=mbr,
                heat_mbr=heat_mbr, out=(w, h), inputs=inputs, peak_gib=_peak_gib(dev),
                **_assembly_counts(), **driver)


def mesh_leg(grid: Grid) -> dict:
    """The bundle hour on a (1, 1) mesh of the grid's device: grid and
    storm state cut by ``shard_pytree``, ``fast_f32(use_pallas=True,
    mesh=)``, the result joined by ``gather_pytree``; up to 3 runs. Returns
    walls, median, the last run's stats, MBR, host reads, bundle launches,
    graph launches and joined final state, the leg's peak memory and driver
    (:func:`prepare_driver`)."""
    dev = grid.device
    _reset_peak(dev)
    mesh = make_mesh(1, devices=[dev])
    params = SolverParameters.fast_f32(use_pallas=True, inner_solver="jacobi")
    grid_m = shard_pytree(grid, mesh)
    state_m = shard_pytree(problems.storm_state(grid, params), mesh)
    pparams = dataclasses.replace(params, mesh=mesh)
    driver = prepare_driver(grid_m, pparams, state_m)
    runs, wall, (out, stats, reads, launches, mbr, graph_launches) = sample(
        lambda: _hour(grid_m, pparams, state_m), dev, 3)
    return dict(runs_s=runs, wall_s=wall, stats=stats, mbr=mbr, host_reads=reads,
                launches=launches, graph_launches=graph_launches, peak_gib=_peak_gib(dev),
                out=gather_pytree(out, dev), mesh=mesh.shape, **driver)


def card_info() -> tuple[str, float]:
    """The card's name and power limit [W], as ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit.split()[0])


def _build_s(dev: torch.device) -> float | None:
    """Seconds of building the CUDA libraries, the bundle kernel and the
    graph machine (near 0 once built); None off the card, where nothing is
    built."""
    if dev.type != "cuda":
        return None
    t0 = time.perf_counter()
    JB.build_library()
    device_loop.build_library()
    return time.perf_counter() - t0


def _driver_keys(result: dict, leg: str, out: dict) -> None:
    """A leg's driver and capture seconds into the line."""
    result.setdefault("driver", {})[leg] = out["driver"]
    result.setdefault("capture_s", {})[leg] = out["capture_s"]
    result["units_per_launch"] = out["units_per_launch"]


def bench(env=os.environ, device=None, dem: Dem | None = None) -> dict:
    """Every leg that ``env`` selects, on ``device`` (the card when None) and
    ``dem`` (:func:`load_dem` when None); the JSON object of the line."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    dem = dem or load_dem()
    coarsen = int(env.get("BENCH_COARSEN", "1"))
    grid = build_grid(coarsen, dev, dem)
    params = storm_params(env)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    compile_s = _build_s(dev)
    storm = storm_leg(grid, params)
    del storm["out"]
    n_steps, n_attempts, n_approx, n_sweeps = storm["stats"]
    wall_s = storm["wall_s"]
    ravone = dem.name == "ravone"
    ref_wall = reference_wall_s(coarsen) if ravone else None
    platform = "gpu" if dev.type == "cuda" else dev.type
    result = {
        "metric": "ravone_wallclock_s_per_sim_hour",
        "value": wall_s,
        "unit": "s",
        "vs_baseline": ref_wall / wall_s if ref_wall else None,
        "reference_cpu_wall_s": ref_wall,
        "n_nodes": grid.n_nodes,
        "coarsen": coarsen,
        "setup_s": setup_s,
        "compile_s": compile_s,
        "whole_period_mbr": storm["mbr"],
        "steps_per_hour": n_steps,
        "step_attempts_per_hour": n_attempts,
        "approximations_per_hour": n_approx,
        "jacobi_sweeps_per_hour": n_sweeps,
        "node_updates_per_s": grid.n_nodes * n_sweeps / wall_s,
        "runs_s": storm["runs_s"],
        "platform": platform,
        "dem": dem.name,
        "host_reads_per_hour": storm["host_reads"],
        "bundle_launches_per_hour": storm["launches"],
        "peak_memory_gib": {"storm": storm["peak_gib"]},
    }
    _driver_keys(result, "storm", storm)
    if dev.type == "cuda":
        result["card"], result["power_limit_w"] = card_info()
    else:
        result["card"], result["power_limit_w"] = None, None

    day_coarsen = int(env.get("BENCH_DAY_COARSEN", "4"))
    if env.get("BENCH_DAY", "1") == "1":
        # non-fatal, as in bench.py: a failing day leaves its keys out
        try:
            day_grid = grid if day_coarsen == coarsen else build_grid(day_coarsen, dev, dem)
            day = day_leg(day_grid, params)
            del day["out"], day_grid
            result.update(sim_day_wall_s=day["wall_s"], sim_day_mbr=day["mbr"],
                          sim_day_coarsen=day_coarsen,
                          sim_day_hour_walls_s=day["hour_walls_s"],
                          sim_day_host_reads=sum(day["host_reads"]),
                          sim_day_host_reads_per_hour=day["host_reads"],
                          sim_day_period_stats=[list(st) for st in day["stats"]])
            result["peak_memory_gib"]["day"] = day["peak_gib"]
            _driver_keys(result, "day", day)
        except Exception as e:                            # noqa: BLE001
            print(f"# sim-day leg failed: {e!r}", file=sys.stderr)

    if env.get("BENCH_HEAT", "1") == "1":
        cp = coupled_leg(grid, params, env)
        del cp["out"], cp["inputs"]
        result.update(
            coupled_heat_wall_s=cp["wall_s"],
            coupled_vs_water_ratio=cp["wall_s"] / wall_s,
            coupled_heat_mbr=cp["heat_mbr"],
            coupled_heat_runs_s=cp["runs_s"],
            # the coupled leg builds nothing: the libraries the storm leg's
            # compile_s already counts
            heat_compile_s=0.0,
            coupled_water_mbr=cp["mbr"],
            coupled_counts=cp["counts"],
            coupled_host_reads=cp["host_reads"])
        result["peak_memory_gib"]["coupled"] = cp["peak_gib"]
        _driver_keys(result, "coupled", cp)

    if env.get("BENCH_PALLAS_LEG", "1") == "1" and not params.use_pallas:
        pallas_compile_s = _build_s(dev)
        ml = mesh_leg(grid)
        result.update(
            pallas_wall_s=ml["wall_s"], pallas_mbr=ml["mbr"],
            pallas_sweeps_per_hour=ml["stats"][3], pallas_runs_s=ml["runs_s"],
            pallas_compile_s=pallas_compile_s, pallas_compiled_on=platform,
            pallas_stats=list(ml["stats"]), pallas_launches_per_hour=ml["launches"],
            pallas_mesh=[ml["mesh"]["row"], ml["mesh"]["col"]])
        result["peak_memory_gib"]["pallas"] = ml["peak_gib"]
        _driver_keys(result, "pallas", ml)
    return result


def main() -> int:
    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(bench(os.environ, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
