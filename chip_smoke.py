#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``criteria3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0]

Phases (any failed check exits non-zero before the last line):

1. card and build: prints the card's name and power limit, builds the CUDA
   libraries from ``criteria3d_tpu_torch/csrc``;
2. kernel against plain version: the CUDA ``jacobi_bundle`` (the tiled
   design) against ``jacobi_bundle_reference`` on seeded float32 inputs, at
   the main-path shape (7, 768, 768), at (5, 37, 45), at a box smaller than
   a tile and at one a cell past two tiles a side (x bit-equal, the norm to
   rel 1e-5), and in its halo mode (``halo=K``, the sharded loop's) at the
   main-path shape; and against the per-sweep design
   ``jacobi_bundle_per_sweep`` at the main-path shape (x and norm
   bit-equal);
2b. the water assembly's kernel pair (``csrc/assemble_fast.cu``, the
   ``assemble_fast`` of every float32 Picard iteration) against its plain
   chain ``assemble_fast_reference`` on the same card tensors, at phase
   3's storm state of the 768 box (``problems.storm_state``, the cells'),
   unchanged and one seeded step on, at approx 0 and 1 with the step given
   as a number and as 0-d tensors on the card: b, c_up, c_down, c_lat,
   diag, the Courant number, the water flow, the rate and k bit-equal, one
   launch a call; then the pair and the chain alone (CUDA events) and the
   bound of the bytes they must move;
3. the main path: one simulated hour of a 20 mm/h storm on a synthetic
   catchment at the scale of the Ravone benchmark (768 x 768 box of 4 m
   cells, a disc of 420,836 valid cells, 7 layers, 2,945,852 nodes) under
   ``SolverParameters.fast_f32(use_pallas=True)``, through the port bench's
   storm leg (``bench.storm_leg``: ``compute_period_stats``, one run),
   graph-driven (the period's state machine
   as CUDA graphs, ``solver/device_loop.py``, captured before the runs),
   with the kernel's launch count read from the last run (at ``--seed 0``
   the stats must be (91, 92, 193, 1640), the per-sweep design's); then
   (3x) once more eager-driven under torch.profiler, for the device-time
   breakdown (a replayed graph shows the profiler its launches, not the
   units' ranges) and as the graph driver's reference: the same stats,
   MBR, launches, heads bit-equal, the graph hour's host reads at most 5 %
   of the eager hour's, its peak memory at most 2 x; then a small
   locked-dt hour on the card against the same hour on the CPU (the plain
   twin);
3b. the production preset ``SolverParameters.fast_f32()`` (CG with the
   vertical-line preconditioner) on the same storm hour through the port
   bench's storm leg (one run, graph-driven): stats ((45, 52, 164, 528) at
   ``--seed 0``), MBR (|MBR| < 2e-3), the wall, host syncs, peak memory;
   no ``jacobi_bundle`` launch, every output on the card; under the unit
   clock, so that the assembly's kernel pairs (counted from 0 just before
   the hour) equal its ``assemble`` units plus restores; then 3x's eager
   profiled hour and checks;
3c. the float64 parity path ``SolverParameters()`` (per-sweep float64
   Jacobi, tolerance 1e-10) on the same storm hour at full size, once
   through the bench's storm leg (graph-driven), then 3x's eager profiled
   hour and checks: stats, MBR (|MBR| < 2e-3), wall, host syncs, the
   breakdown; no ``jacobi_bundle`` launch, float64 heads on the card;
3d. small locked-dt hours on the card (graph-driven) against the port's
   CPU path (eager): the float64 path, ``fast_f32()`` CG line, and
   ``fast_f32()`` CG diag with ``track_link_flow``: the same steps,
   attempts and approximations; heads within 1e-6 m (f64) or 1e-4 m, link
   flows within 1e-3 of their max. ``graph_phases(seed, card)`` runs 3x
   and 3d on their own (``dev="cpu", n=32`` rehearses them on the CPU,
   where both hours are eager);
3e. the coupled water + heat storm hour through the port bench's coupled
   leg (``bench.coupled_leg``, bench.py's: ``fast_f32(heat_vapor=True,
   heat_frozen_props=True)``, every layer-1 node a HeatSurface, one run)
   on the same catchment, graph-driven (the coupled period's state machine
   as CUDA graphs, captured before the run), every count read (water
   steps, attempts, approximations, CG iterations; heat chunks, accepted
   and rejected sub-steps, heat sweeps; host syncs, wall, peak memory,
   water and heat MBR, the graph machine's launches and capture seconds),
   then once more eager-driven and profiled through trace_coupled's
   roll-up, which (3x (iv)) is the graph hour's reference: every count and
   both MBRs equal, h and T bit-equal, the graph hour's host reads at most
   5 % of the eager hour's, its peak at most 2 x; checks every output on
   the card, |water MBR| < 2e-3, a finite heat MBR and heat-node
   temperatures finite within [200, 330] K; its kernel pairs, as 3b's;
3f. small coupled hours of a 6 x 6 heat column on the card against the
   port's CPU path, float64 with vapor and ``fast_f32`` frozen with vapor:
   the same water steps and heat sub-steps, T within 1e-6 K / 1e-3 K,
   heads within 1e-6 m / 1e-4 m; then (3x (v)) a 48-box coupled storm hour
   through the CUDA bundle (``fast_f32(use_pallas=True, heat_vapor=True,
   heat_frozen_props=True)``) graph-driven against eager-driven, held as
   3x (iv) holds 3e's, launches x K = inner iterations; (ii) the float32
   exact-mode coupled period (``fast_f32(heat_vapor=True,
   heat_frozen_props=False)``, the machine's cache-rebuild unit) on the
   12 box of the forced cache-rebuild case and on a 32 box, graph-driven
   and eager-driven: counts, MBRs, h and T equal between the drivers, a
   sub-step rejected (the same periods against the CPU run in
   tests/test_torch_cuda.py);
3g. the hourly model cycle (``Criteria3DModel.run_hour``) at full size on
   the same catchment under ``fast_f32()`` with snow, crop, evaporation,
   interception and cracking, slope and aspect from the DEM: six hours of a
   cold day (2023-03-21, hours 6-11: the sun rising, snow, rain on the
   pack, a dry late morning), each with its wall, host syncs, solver
   stats, MBR and catchment means; checks every output and state on the
   card, |MBR| < 2e-3, radiation finite, 0 before sunrise and within
   [0, 1400] W/m2, SWE >= 0 and a pack after hour 7, ET0 >= 0, no bundle
   launch; then the peak memory and one more hour profiled. If hours 6-8
   take more than 50 s, hours 9-11 run on a 384 box;
3h. one coupled model hour (``compute_heat`` under
   ``fast_f32(heat_vapor=True, heat_frozen_props=True)``, every layer-1
   node a HeatSurface) at full size, hour 10 from a fresh model,
   graph-driven through ``run_hour`` (no change to model.py): water and
   heat counts and MBRs, wall, host syncs, the graph machine's launches,
   heat-node T; 3e's checks, the
   water MBR in its |sink| form (a dry hour's net sink is negative, and the
   coupled period's own signed-sink MBR then divides by 0.001 m3); then
   the same hour eager-driven from the same state: h and T bit-equal, the
   graph-driven hour's peak memory at most 2 x the eager one's;
3i. one model hour (hour 8) under ``fast_f32(use_pallas=True)``: the model
   cycle launches the CUDA kernel (launches x K = sweeps), |MBR| < 2e-3;
3j. ``run_period`` over the whole day on a 32 box on the card and on the
   CPU, under ``SolverParameters()`` and ``fast_f32()``, saving the daily
   state: the daily MBR, dt_curr, heads, degree days, LAI and SWE agree,
   and ``load_state`` of the card's rasters gives its heads to float32
   rounding;
3k. the project stack at full size: ``problems.write_project`` (the same
   catchment at n = 768 with 20 stations, two soils, land units, output
   points and maps), ``Criteria3DProject.load`` and
   ``initialize(fast=True)`` on the card, ``run_period`` over hours 6-7
   with outputs: per hour the wall, host reads, solver stats and MBR;
   the peak memory, the readings spatial QC turned away, the rasters and
   output-DB rows written; checks |MBR| < 2e-3, no bundle launch, every
   raster read back finite on the catchment and one row per point and
   hour; then one more hour profiled, with the device time of the
   ``c3d.interpolation`` and ``c3d.outputs`` ranges;
3l. a 32 box project (float64) on the card and on the CPU: hours 12-23
   of the day (the whole day until the library phases joined the run)
   through ``run_period`` (the forcing maps rel 1e-12, the same
   steps, attempts and approximations, heads 1e-6 m, hourly MBRs 1e-8, the
   23 h daily update's Tmin / Tmax maps, degree days and LAI rel 1e-12,
   rasters within one float32 ulp, output-DB values rel 1e-9), then the
   first coupled hour of the same project with ``compute_heat`` (heat vapor
   and advection): the same counts, T within 1e-6 K, heads within 1e-6 m;
3m. HYDRALL and RothC in the model cycle at full size
   (``problems.build_hydrall_problem``: 3g's catchment under ``fast_f32()``
   with a seeded forest), hours 10-13 of the model day: per hour the wall,
   host reads, solver stats, MBR and the fixed point's iterations; checks
   |MBR| < 2e-3, no bundle launch, HYDRALL's outputs finite, transpiration
   0 outside the forest; the peak memory; hour 14 profiled (the
   ``c3d.hydrall`` range's device time); hour 13's ``hydrall_hour`` on its
   own inputs on the card and on the CPU (rel 1e-12, stop flips counted),
   and on the card graph-driven against eager-driven (the fixed point's
   machine: outputs bit-equal, the stops equal, one launch a call); each
   hour's fixed points graph-driven;
   the Jan-1 annual step and one monthly RothC step on the card;
3n. a 16 box with HYDRALL and RothC under ``SolverParameters()`` on the
   card and on the CPU, ``run_period`` over a dry Dec 31 and Jan 1 (the
   month-end RothC step, the annual step's litter): the same stats every
   hour, daily MBRs 1e-8, heads 1e-6 m, RothC and HYDRALL maps, litter and
   LAI rel 1e-9;
3o. the VINE3D project at full size (``problems.write_vine_project``,
   n = 768, 20 stations), ``Vine3DProject.load`` and
   ``initialize(fast=True)``, the seeded mid-season canopy and the day's
   field book, hours 11-13 and 22-23 of 2023-06-21 and the daily update:
   per hour the wall, host reads, stats, MBR, the mass error over the
   hour's gross exchange (< 2e-3), the fixed point's iterations, irrigated
   cells (field 1's, in the booked last hours), no bundle launch; the peak
   memory; hour 14 eager-driven and graph-driven from the same state (the
   graph-driven peak at most 2 x), then profiled (``c3d.vine``,
   ``c3d.diseases``); hour 12's canopy fluxes on a 64 x 64 window of
   their own inputs on the card and on the CPU (rel 1e-12, stop flips
   counted), and over the whole box graph-driven against eager-driven
   (the fixed points' machines: outputs bit-equal, the stops equal, one
   launch a call); each hour's 4 fixed points graph-driven;
3p. a 16 box VINE3D project's day (float64) through ``run_day`` on the
   card and on the CPU (a 32 box until the shell phases joined the run:
   the script stays near 600 s): the same stats every hour, hourly MBRs 1e-8, heads
   1e-6 m, vine maps rel 1e-9, the powdery risk within 4 float32 ulp of
   the pool, infection flags, downy stages and irrigation equal;
3q. the command shell at full width: 3k's project (n = 768, 20 stations)
   with its DEM rewritten as a GeoTIFF, one batch script through
   ``criteria3d_tpu_torch.cli.main`` in-process (PROJ, FAST ON,
   INITIALIZE, RUN 3 hours from 10 h (06 h until the library phases
   joined the run), INFO, EXPORTPNG, MAP, VIEW3D, CHART, PROXY, HOURLYCSV,
   STATE SAVE / LOAD, ANIM 1 hour, REPORT): each
   command's wall and host reads, each model hour's wall, host reads,
   stats and MBR, the native writer pool's written and errors, the peak
   memory; checks no ``ERROR:`` line, every file written (each PNG with
   its signature), |MBR| < 2e-3 each hour, no bundle launch, every model
   tensor on the card, the pool's rasters those staged with 0 errors;
   then ``python -m criteria3d_tpu_torch.cli`` once in a subprocess
   (VERSION, DEM of the GeoTIFF, INFO);
3r. the meteo grid as the weather source at full width
   (``problems.write_meteo_grid``: a 10 x 10 UTM grid of 500 m cells over
   the box and a 1 km margin, 100 virtual stations): ``load_meteo_grid``,
   ``initialize(fast=True)``, two hours from 10 h with outputs (walls,
   host reads, stats, MBR, forcing finite on the catchment), one more hour
   profiled (the ``c3d.interpolation`` share of busy with 100 stations
   against 3k's 20), that hour's temperature map through
   ``export_hourly_to_grid`` and read back from the DB within 1e-6;
3s. a 32 box on the card and on the CPU: the batch script (no FAST: the
   float64 parameters; RUN from 10 h, where the box has no snow whose
   branches part at 0 internal energy) and two meteo-grid hours: the same
   stats each
   hour, heads 1e-6 m, forcing maps rel 1e-12, the CSV and the DEM- and
   station-derived PNGs byte-equal, the state-derived images (and the
   report's) differing in at most 0.1% of their decoded pixels, the
   report's text equal;
3t. the interpolation library on the card at full width: 3k's DEM with
   100 stations placed by write_meteo_grid's rule (3r's grid of 500 m
   cells), heights from the DEM, the 07 h temperatures:
   ``multiple_detrending`` and ``retrend_map`` over the box,
   ``local_detrending_map`` over all 589,824 cells (24 neighbours, 16
   starts, 60 iterations), ``glocal_weight_maps`` over 4 zones (the
   quadrants) and ``glocal_detrending_map``, the stations'
   ``topographic_distance_matrix`` and ``optimize_topo_kh``,
   ``empirical_variogram``, ``fit_variogram`` (spherical or exponential)
   and ``ordinary_kriging`` of the temperatures over the box: each call's wall, host reads and peak
   memory; the maps finite, the glocal weights summing to 1; the local map
   of a 128-row band (3 chunks) profiled (``c3d.detrending``); then the
   same calls
   on a 48 x 48 window on the card and on the CPU: maps rel 1e-9 with 0
   differing cells, glocal weights and topographic distances bit-equal,
   the same Kh and variogram mode and range, the kriging system's cond(V)
   at most 1e8 and the maps within 64 eps x cond(V);
3u. the host library on full-size products: the strict D8 watershed of
   3k's DEM from its outlet, its outline as a shapefile (rasterized back
   through ``shape_utils`` to the watershed's cells, its mean height as a
   field), reprojected to lat-lon, written and read back (back in UTM
   within 1 cm); 3k's last-hour root-zone water content through NetCDF
   and back (0.0 from its float32 values); ``telemetry.balance_report``
   and ``debug_dump.dump_linear_system`` on the bundle storm hour's state
   on the card (the mass error under 2e-3 of the rain; the dump, loaded,
   equal to the card's arrays);
3v. the device mesh, blocks on the one card
   (``make_mesh(n, devices=[cuda] * n)``): ``halo_exchange`` of a seeded
   (7, 768, 768) and (8, 7, 768, 768) array over 2 x 2 and 2 x 4 blocks,
   bit-equal to the zero-padded windows; the mesh form of
   ``jacobi_solve_loop`` on phase 2's inputs over 2 x 2 blocks, x
   bit-equal to the single-device loop with the same n_it and flag, the
   ms of one bundle (CUDA events) against the single kernel's, the x
   exchange's share, a mesh bundle's bound and the tiled variant of each
   block; the three storm hours of phases 3-3c partitioned over 2 x 2
   blocks (grid and state cut by ``shard_pytree``, the whole water step on
   the blocks), graph-driven (the machine captured by a zero-length period
   first): ``fast_f32(use_pallas=True, mesh=)`` (4 launches a bundle),
   ``fast_f32(mesh=)`` (CG line) and ``SolverParameters(mesh=)`` (f64),
   each with its stats, MBR, wall, host reads, launches, the graph
   machine's launches and capture seconds and the peak memory; |MBR| <
   2e-3, stats and MBR equal to phases 3-3c's graph-driven hours, heads
   bit-equal (f32) or within 1e-9 m (f64), host reads at most 5 % of the
   eager hours'; (iii) the same three hours on the same blocks split into
   4 machines (one a block) and the bundle's also into 2 (rows of
   blocks), run by the rounds driver (each machine on its own stream, the
   rounds enqueued from the host with events between the streams, as over
   several cards) in a process of its own (``--machines-hours``: a
   process that has run torch.profiler makes every CUDA call slower):
   stats, MBR and launches equal to the one machine's, heads bit-equal,
   host reads at most the batches of rounds plus 3, as many batches as the
   rounds run need; in the same process (iv)'s coupled storm hour on the
   same blocks in 4 machines (every count, both MBRs and launches equal to
   (iv)'s one machine, h and T bit-equal, host reads at most the batches
   plus 3) and 3x (v)'s bundle-form coupled hour (its 48 box) on 2 x 2
   blocks in one machine and in 4 and 2 in rounds (every count, both MBRs
   and the bundle launches, 4 a bundle, equal, h and T bit-equal);
   ``scaling_bench``'s line for the 768 box (the float64
   step and the bundle step, each on one device and on 4 blocks); (iv)
   phase 3e's coupled storm hour partitioned over 2 x 2 blocks (grid,
   water, heat and boundary cut by ``shard_pytree``, the whole coupled
   step on the blocks, the result joined by ``gather_pytree``) under
   ``fast_f32(heat_vapor=True, heat_frozen_props=True, mesh=)``,
   graph-driven: water stats, chunks, sub-steps, heat sweeps, host reads,
   wall, launches (0), the graph machine's launches and capture seconds,
   water and heat MBR, the gaps of h and T to 3e's hour; |water MBR| <
   2e-3, every count and the water MBR equal to 3e's, the heat MBR within
   rel 1e-8 (the blocks' partials add in another order), h and T
   bit-equal; (3x (vi)) the frozen coupled half hour on 2 x 2 blocks of a
   32 valley, graph-driven against eager-driven on the same blocks
   (counts, MBRs and launches equal, h and T bit-equal, host reads at most
   5 %, peak at most 2 x), and every unit of an f64 water and a coupled
   machine on the blocks under ``set_sync_debug_mode("error")``; the
   seconds of each part of 3v (the 2 x 4 loop made room for 3w, the water
   forms' eager hours on blocks for (iii));
3w. the port's bench (``python -m criteria3d_tpu_torch.bench``), the legs
   phases 3b and 3e do not run: (i) the day leg at coarsen 4 (chained
   hours of 6 periods of 600 s under ``fast_f32()``), cut to its 3 storm
   hours (the whole day's 21 drainage hours take minutes: ``python -m
   criteria3d_tpu_torch.bench`` runs them): each hour's wall and host
   reads, the closing |MBR| < 2e-3; (ii) the mesh leg, the bundle hour on
   a (1, 1) mesh (one 784 tile with an 8-cell ring) at full size,
   graph-driven, against phase 3's graph-driven hour: the same stats and
   host reads, heads bit-equal, one launch a bundle; (iii) the coupled trace's roll-up of 3e's profiled
   hour: some launch matched a layer's range, each water and heat layer
   holds device time, "other" less than half the busy time, the layers sum
   to the busy time and the activities' durations less their overlaps
   equal it; the seconds of each part;
4. the ``kernels`` line: one JSON object per ported kernel with its
   launches, error, times and bound, and for the tiled bundle its tile, the
   sweeps it keeps on chip, its modelled bytes and rate, the per-sweep
   design's time in the same run, its halo mode's error, its launches
   in the 3i model hour (and 0 in the 3o vineyard, 3q shell and 3r
   meteo-grid hours), in 3v's mesh hour and in 3w's mesh leg, and 3v's ms,
   exchange ms and bound of a 2 x 2 mesh bundle; and the graph machine
   (``csrc/graph_machine.cu``, the loop nests' control: the water and the
   coupled period's and the fixed points'): its launches in phase 3's
   timed hour (counted from 0 just before it), in 3e's coupled hour, 3h's
   coupled model hour, 3x (v)'s bundle-form coupled hour, 3v's
   partitioned hours, their batches and rounds in machines (the coupled
   hours' too), 3w's mesh leg and the fixed points of 3m's and 3o's
   compared calls, its control time per unit against the eager driver's
   host read, the capture seconds; and the water assembly's pair: its
   launches in 3b's and 3e's hours, 2b's error, its ms alone and per unit
   in those hours, the chain's ms, the bound of its bytes;
5. the card's line, then the last line: ``{"ok": true, "device": {...}}``.

The profiled hours split device time by layer: the kernels launched inside
the step's ``c3d.assemble`` and ``c3d.inner_solve`` ranges, the heat
sub-steps' ``c3d.heat_assemble`` and ``c3d.heat_solve`` ranges, the model
cycle's ``c3d.radiation`` (shadow march included), ``c3d.snow``,
``c3d.et0`` and ``c3d.sinks`` ranges, the project's ``c3d.interpolation``
and ``c3d.outputs`` ranges, HYDRALL's ``c3d.hydrall``, the vineyard's
``c3d.vine`` and ``c3d.diseases`` ranges, the library's
``c3d.detrending``, and the rest (``utils/profiling.py``). It imports
nothing of JAX and nothing of the JAX package. ``side_phases(seed, card)``
runs 3m-3p alone, ``shell_phases(seed, card)`` 3q-3s,
``library_phases(seed, card)`` 3t-3u, ``mesh_phases(seed, card)`` 3v,
``bench_phases(seed, card)`` 3w and ``graph_phases(seed, card)`` 3x with
3d; with ``dev="cpu"`` and a small
``n`` they rehearse them on the CPU. ``mesh_cards(seed, card)`` runs 3v's
loop, the partitioned bundle and coupled hours (each card's peak memory
against the one-card hour's; ``mesh_cards_coupled`` the coupled one alone)
and the scaling bench with one block per card on a host with several.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

try:
    from criteria3d_tpu_torch.utils.profiling import (F32_FLOPS, FLOPS_PER_NODE_NORM,
                                                      FLOPS_PER_NODE_SWEEP,
                                                      HBM_BYTES_PER_S, breakdown,
                                                      layer_ranges)
except ImportError as e:
    print(f"chip_smoke: the criteria3d_tpu_torch package is missing ({e}); "
          "run from the repository root", file=sys.stderr)
    sys.exit(2)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def compare_bundle(shape, seed: int, halo: int = 0):
    """Kernel vs plain version on one seeded input (``halo`` > 0: the halo
    mode, whose norm leaves out the cells within ``halo`` of the box's
    edges); returns (max_abs_err, norm_rel_err, inputs). x must be
    bit-equal (the build disables FMA contraction and the kernel adds the
    terms in the plain order); the norm sums in another order and is held
    to rel 1e-5."""
    import torch
    from criteria3d_tpu_torch.bench_jacobi import bundle_inputs
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    inputs = bundle_inputs(shape, seed, "cuda")
    x_k, n_k = JB.jacobi_bundle(*inputs, halo=halo)
    x_p, n_p = JB.jacobi_bundle_reference(*inputs, halo=halo)
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    n_k, n_p = float(n_k), float(n_p)
    rel = abs(n_k - n_p) / max(abs(n_p), 1e-30)
    check(err == 0.0, f"jacobi_bundle x differs from the plain version at {shape} "
                      f"(halo {halo}): max abs err {err}")
    check(rel <= 1e-5, f"jacobi_bundle norm differs at {shape} (halo {halo}): kernel "
                       f"{n_k} plain {n_p} (rel {rel})")
    print(f"# jacobi_bundle vs plain at {shape}, halo {halo} ({JB.tiled_variant(*inputs)} "
          f"kernel): max_abs_err={err} norm_rel={rel}", flush=True)
    return err, rel, inputs


ASSEMBLY_OUTPUTS = ("b", "c_up", "c_down", "c_lat", "diag", "courant", "water_flow",
                    "rate", "k")


def _assembly_fields(result) -> dict:
    system, water_flow, rate, k = result
    return dict(b=system.b, c_up=system.c_up, c_down=system.c_down, c_lat=system.c_lat,
                diag=system.diag, courant=system.courant, water_flow=water_flow, rate=rate,
                k=k)


def compare_assembly(grid, params, seed: int) -> dict:
    """Phase 2b: ``assemble_fast``'s kernel pair against its plain chain
    (``assemble_fast_reference``) on the same card tensors at the storm
    state of ``grid`` (``problems.storm_state``): psi_old the state's psi,
    psi that or one seeded step on (soil and surface moving, so the secant,
    runoff and infiltration branches run), at approx 0 and 1, the step a
    number and 0-d tensors on the card. Every output bit-equal and one
    launch a call; then the pair alone and the chain alone [ms] and the
    bound of the bytes the roofline counts (each input read once, each
    output written once). Returns what it measured."""
    import torch
    from criteria3d_tpu_torch import problems
    from criteria3d_tpu_torch.bench_jacobi import cuda_ms
    from criteria3d_tpu_torch.solver import water as W
    state = problems.storm_state(grid, params)
    sd = params.sweep_dtype
    psi_old = torch.where(grid.mask, state.h - grid.z, 0.0).to(sd)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    moved = psi_old + torch.randn(psi_old.shape, generator=gen, device="cuda",
                                  dtype=sd) * 0.01 * grid.mask
    dt_t = torch.tensor(300.0, dtype=torch.float64, device="cuda")
    err, differing, calls = 0.0, 0, 0
    for psi in (psi_old, moved):
        se = W.compute_se_psi(grid, params, psi)
        for approx, dt in ((0, 300.0), (1, 300.0),
                           (torch.tensor(0, device="cuda"), dt_t),
                           (torch.tensor(1, device="cuda"), dt_t)):
            a = (grid, params, psi, psi_old, se, state.sink_source, state.pond, approx, dt)
            before = W.assemble_fast.launches
            kern = _assembly_fields(W.assemble_fast(*a))
            check(W.assemble_fast.launches == before + 1,
                  "2b: an assemble_fast call did not count one kernel pair")
            chain = _assembly_fields(W.assemble_fast_reference(*a))
            torch.cuda.synchronize()
            for name in ASSEMBLY_OUTPUTS:
                x, y = kern[name], chain[name]
                check(x.dtype == y.dtype and x.shape == y.shape,
                      f"2b: {name} is {x.dtype} {tuple(x.shape)}, the chain's "
                      f"{y.dtype} {tuple(y.shape)}")
                bits = torch.int64 if x.dtype == torch.float64 else torch.int32
                differing += int((x.view(bits) != y.view(bits)).sum())
                err = max(err, float((x.double() - y.double()).abs().max()))
            calls += 1
    check(differing == 0, f"2b: the kernel pair differs from the chain in {differing} "
                          f"values (max abs err {err})")
    se = W.compute_se_psi(grid, params, psi_old)
    a = (grid, params, psi_old, psi_old, se, state.sink_source, state.pond, 0, 300.0)
    ms = cuda_ms(lambda: W.assemble_fast(*a), reps=20)
    plain_ms = cuda_ms(lambda: W.assemble_fast_reference(*a), reps=5, batches=3)
    g32 = grid.astype(sd)
    reads = [psi_old, psi_old, se, state.sink_source, state.pond, g32.volume, g32.bsize,
             g32.bslope, g32.roughness, g32.lat_dist3d, g32.dz_lat, g32.lat_area,
             g32.vert_dist, g32.lat_dist2d, grid.btype, grid.mask, grid.vert_dist]
    reads += [getattr(g32.soil, n) for n in ("vg_alpha", "vg_n", "vg_m", "vg_he", "vg_sc",
                                             "theta_s", "theta_r", "k_sat", "mualem_l",
                                             "mualem_den")]
    writes = [t for n, t in kern.items() if n != "courant"]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    bytes_read, bytes_written = nbytes(reads), nbytes(writes)
    bound_ms = (bytes_read + bytes_written) / HBM_BYTES_PER_S * 1e3
    print(f"# assemble_fast kernel pair vs chain at {tuple(psi_old.shape)}: {calls} calls, "
          f"every output bit-equal (max abs err {err}, Courant "
          f"{float(kern['courant'])}); alone {ms} ms, the chain {plain_ms} ms, bound "
          f"{bound_ms} ms ({bytes_read} B read, {bytes_written} B written)", flush=True)
    return dict(max_abs_err=err, differing=differing, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bytes_read=bytes_read, bytes_written=bytes_written)


def assembly_launches(label, leg: dict, clock) -> dict:
    """The assembly's kernel pairs in a bench leg's one run (counted from
    0 just before it) against the ``assemble`` units the unit clock counted
    and the restores: equal to their sum. Returns the counts and the
    in-hour ms per unit."""
    units, seconds = clock.units().get("assemble", (0, 0.0))
    launches, restores = leg["assemble_launches"], leg["restores"]
    print(f"# {label}: {launches} assemble_fast kernel pairs, {units} assemble units "
          f"({seconds / max(units, 1) * 1e3} ms a unit), {restores} restores", flush=True)
    check(units > 0, f"{label}: the unit clock counted no assemble unit")
    check(launches == units + restores,
          f"{label}: {launches} assembly kernel pairs, not {units} units + {restores} "
          "restores")
    return dict(launches=launches, units=units, restores=restores,
                ms_per_unit=seconds / units * 1e3)


def tensors_of(obj):
    import dataclasses
    import torch
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v
        elif dataclasses.is_dataclass(v):
            yield from tensors_of(v)


# the kernels of one jacobi_bundle call, as the profiler names them
JACOBI_KERNELS = ("tile_live_kernel", "tiled_resident_kernel", "tiled_sweeps_kernel",
                  "plane_sum_kernel", "::sum_kernel(")


def storm_hour(label, grid, params, max_runs: int) -> dict:
    """A storm hour through the port bench's storm leg (``bench.storm_leg``:
    bench.py's sampling, at most ``max_runs`` runs, every count set to 0
    before each): prints the walls, their median and the last run's stats,
    MBR, launches, host syncs and peak memory, and checks the last run
    (:func:`check_hour`). Returns the leg's dict."""
    from criteria3d_tpu_torch import bench
    sl = bench.storm_leg(grid, params, max_runs)
    print(f"# {label} (the bench's storm leg): stats (steps, attempts, approximations, "
          f"inner iterations) = {sl['stats']} whole-period MBR={sl['mbr']} walls "
          f"{sl['runs_s']} s, median {sl['wall_s']}; bundle launches={sl['launches']} "
          f"graph machine launches={sl['graph_launches']} host syncs={sl['host_reads']}; "
          f"peak memory {sl['peak_gib']} GiB",
          flush=True)
    check_hour(label, sl["out"], params, sl["mbr"])
    return sl


def check_hour(label, out, params, mbr) -> None:
    """Every output of a storm hour on the card, heads of the state dtype
    and finite, the whole-period |MBR| < 2e-3."""
    import torch
    for name, t in tensors_of(out):
        check(t.device.type == "cuda", f"{label}: output {name} is on {t.device}")
    check(out.h.dtype == params.dtype, f"{label}: heads are {out.h.dtype}")
    check(bool(torch.isfinite(out.h).all()), f"{label}: non-finite heads")
    check(abs(mbr) < 2e-3, f"{label}: |whole-period MBR| {mbr} >= 2e-3")


def eager_hour(label, grid, params, wall_s) -> dict:
    """The storm hour (the bench's storm leg's: ``problems.storm_state``)
    under the eager driver (``device_loop.forced_eager``),
    the graph driver's reference, profiled on the card for the layer
    breakdown (a graph's replay shows the profiler its launches, not the
    ranges of the units): the kept graph machine dropped first, then the
    hour's stats, MBR, heads, bundle launches, host reads, (profiled) wall,
    peak memory and the breakdown (busy seconds, per kernel, per layer)."""
    import torch
    from criteria3d_tpu_torch.bench import sync
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import storm_state
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    dev = grid.device
    device_loop.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state0 = storm_state(grid, params)
    box = {}

    def run():
        host_read.count = 0
        JB.jacobi_bundle.launches = 0
        t0 = time.time()
        out, stats = compute_period_stats(grid, params, state0, 3600.0)
        sync(dev)
        box.update(wall_s=time.time() - t0, out=out, stats=tuple(stats),
                   host_reads=host_read.count, launches=JB.jacobi_bundle.launches,
                   mbr=float(out.balance_whole.mbr))
    with device_loop.forced_eager():
        if dev.type == "cuda":
            busy, per_name, layers = breakdown(f"{label} (eager-driven, profiled)", run, wall_s)
        else:
            run()
            busy, per_name, layers = 1.0, {}, {}
    box.update(busy_s=busy, per_name=per_name, layers=layers,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None))
    return box


def graph_vs_eager(label, graph: dict, eager: dict, on_card: bool) -> dict:
    """Phase 3x: a storm hour driven as CUDA graphs (``bench.storm_leg``)
    against the same hour under the eager driver (:func:`eager_hour`): the
    same stats, the same MBR, heads bit-equal, the same bundle launches;
    on the card the graph driver ran, its host reads at most 5 % of the
    eager hour's and its peak memory at most 2 x. Prints both drivers'
    walls, reads, peaks, the units per launch and the capture seconds."""
    import torch
    gh, eh = graph["out"].h, eager["out"].h
    same_h = torch.equal(gh, eh)
    dh = float((gh - eh).abs().max())
    ratio = graph["host_reads"] / max(eager["host_reads"], 1)
    print(f"# 3x {label}: graph driver ({graph['driver']}{': ' + graph['why'] if graph['why'] else ''}; "
          f"{graph['units_per_launch']} units per launch, capture {graph['capture_s']} s) "
          f"stats {graph['stats']} MBR {graph['mbr']} walls {graph['runs_s']} s host reads "
          f"{graph['host_reads']} bundle launches {graph['launches']} peak "
          f"{graph['peak_gib']} GiB; eager driver stats {eager['stats']} MBR {eager['mbr']} "
          f"wall {eager['wall_s']} s{' (profiled)' if on_card else ''} host reads {eager['host_reads']} bundle "
          f"launches {eager['launches']} peak {eager['peak_gib']} GiB; reads graph / eager "
          f"{ratio}; heads bit-equal {same_h} (max |dh| {dh} m)", flush=True)
    check(tuple(graph["stats"]) == tuple(eager["stats"]),
          f"3x {label}: graph stats {graph['stats']}, eager {eager['stats']}")
    check(graph["mbr"] == eager["mbr"], f"3x {label}: MBR {graph['mbr']} vs {eager['mbr']}")
    check(same_h, f"3x {label}: the graph-driven heads are {dh} m from the eager ones")
    check(graph["launches"] == eager["launches"],
          f"3x {label}: {graph['launches']} bundle launches, eager {eager['launches']}")
    if on_card:
        check(graph["driver"] == "graph", f"3x {label}: the card ran the {graph['driver']} driver")
        check(ratio <= 0.05, f"3x {label}: graph reads {graph['host_reads']} > 5 % of "
                             f"eager {eager['host_reads']}")
        check(graph["peak_gib"] <= 2.0 * eager["peak_gib"],
              f"3x {label}: graph peak {graph['peak_gib']} GiB > 2 x eager {eager['peak_gib']}")
    return dict(stats=graph["stats"], mbr=graph["mbr"], graph_reads=graph["host_reads"],
                eager_reads=eager["host_reads"], graph_wall_s=graph["wall_s"],
                eager_wall_s=eager["wall_s"], capture_s=graph["capture_s"],
                graph_peak_gib=graph["peak_gib"], eager_peak_gib=eager["peak_gib"],
                launches=graph["launches"], dh_max=dh)


def small_card_vs_cpu(name: str):
    """phase 3d: a small locked-dt hour on the card and on the CPU."""
    from criteria3d_tpu_torch.problems import SMALL_CONFIGS, small_hour
    from criteria3d_tpu_torch.solver import device_loop
    make, h_tol = SMALL_CONFIGS[name]
    params = make()
    device_loop.reset_counts()
    res = {dev: small_hour(params, dev) for dev in ("cuda", "cpu")}
    # the card's hour graph-driven, the CPU's eager
    check(device_loop.counts()["graph_periods"] == 1,
          f"small hour {name}: the card's hour did not run graph-driven "
          f"({device_loop.counts()})")
    (oc, sc), (op, sp) = res["cuda"], res["cpu"]
    dh = float((oc.h.cpu() - op.h).abs().max())
    line = (f"# small locked hour {name}: card {sc} MBR {float(oc.balance_whole.mbr)}; "
            f"cpu {sp} MBR {float(op.balance_whole.mbr)}; max |dh| {dh} m "
            f"(tolerance {h_tol})")
    if params.track_link_flow:
        lf_c, lf_p = oc.link_flow_sum.cpu(), op.link_flow_sum
        scale = float(lf_p.abs().max())
        lf_rel = float((lf_c - lf_p).abs().max()) / scale
        line += f"; link flows max |diff| / max |flow| {lf_rel} (tolerance 1e-3)"
        check(scale > 0 and lf_rel < 1e-3,
              f"small hour {name}: link flows differ by {lf_rel} of their max")
    print(line, flush=True)
    check(sc[:3] == sp[:3], f"small hour {name}: steps/attempts/approximations "
                            f"differ between card {sc} and CPU {sp}")
    check(oc.h.dtype == params.dtype, f"small hour {name}: heads are {oc.h.dtype}")
    check(dh < h_tol, f"small hour {name}: heads differ by {dh} m between card and CPU")
    return sc, sp, dh


def coupled_hour(label, grid, params):
    """Phase 3e: the bench's coupled leg (``bench.coupled_leg``, bench.py's
    heat leg, one run with every count set to 0 before it) on ``grid``
    from ``params`` (heat vapor and frozen properties added). Checks it:
    every output on the card, the water whole-period |MBR| < 2e-3, the heat
    MBR (bench.py's whole-period formula) finite, and every heat-node
    temperature finite and within [200, 330] K. Returns a dict of
    what it measured, with the leg's inputs."""
    from criteria3d_tpu_torch import bench
    cp = bench.coupled_leg(grid, params, {}, max_runs=1)
    w, h = cp.pop("out")
    hparams, hgrid = cp["inputs"][:2]
    heat_mbr, t_min, t_max, cold = heat_outcome(label, hgrid, hparams, w, h)
    counts, syncs, mbr = cp["counts"], cp["host_reads"], cp["mbr"]
    print(f"# {label} ({cp['driver']} driver{': ' + cp['why'] if cp['why'] else ''}; "
          f"capture {cp['capture_s']} s, graph machine launches {cp['graph_launches']}): "
          f"water steps, attempts, approximations, CG iterations = "
          f"({counts['steps']}, {counts['attempts']}, {counts['approximations']}, "
          f"{counts['inner_iterations']}); heat chunks {counts['chunks']}, sub-steps "
          f"accepted {counts['substeps_accepted']} rejected {counts['substeps_rejected']}, "
          f"heat sweeps {counts['heat_sweeps']}; host syncs {syncs}; walls {cp['runs_s']} s "
          f"(median {cp['wall_s']}); peak memory {cp['peak_gib']} GiB; water "
          f"whole-period MBR {mbr}; heat MBR {heat_mbr}; heat-node T {t_min}..{t_max} K, "
          f"share below 273.15 K {cold}; bundle launches {cp['launches']}", flush=True)
    check_coupled(label, list(tensors_of(w)) + list(tensors_of(h)), counts, cp["launches"],
                  mbr, heat_mbr, t_min, t_max)
    return dict(counts=counts, syncs=syncs, wall_s=cp["wall_s"], runs_s=cp["runs_s"],
                peak_gib=cp["peak_gib"], mbr=mbr, heat_mbr=heat_mbr, t_min=t_min,
                t_max=t_max, cold_share=cold, h=w.h.to("cpu"), t=h.t.to("cpu"),
                inputs=cp["inputs"], launches=cp["launches"], driver=cp["driver"],
                why=cp["why"], capture_s=cp["capture_s"],
                graph_launches=cp["graph_launches"],
                assemble_launches=cp["assemble_launches"], restores=cp["restores"])


def eager_coupled(trace: dict, grid, params) -> dict:
    """The eager-driven profiled coupled hour of ``trace_coupled.traced_hour``
    in :func:`coupled_hour`'s terms (its output taken off the trace)."""
    from criteria3d_tpu_torch.bench import coupled_heat_mbr
    w, h = trace.pop("out")
    return dict(counts=trace["counts"], syncs=trace["host_reads"],
                wall_s=trace["profiled_wall_s"], profiled=True, peak_gib=trace["peak_gib"],
                mbr=float(w.balance_whole.mbr),
                heat_mbr=coupled_heat_mbr(grid, params, w, h), h=w.h.to("cpu"),
                t=h.t.to("cpu"))


def coupled_graph_vs_eager(label, graph: dict, eager: dict, on_card: bool) -> dict:
    """Phase 3x (iv): a coupled hour driven as CUDA graphs against the same
    hour under the eager driver (each a :func:`coupled_hour`-like dict):
    every count, the water and heat MBRs equal, h and T bit-equal, the same
    bundle launches where both count them; on the card the graph driver
    ran, its host reads at most 5 % of the eager hour's and its peak memory
    at most 2 x."""
    import torch
    same_h, same_t = torch.equal(graph["h"], eager["h"]), torch.equal(graph["t"], eager["t"])
    dh = float((graph["h"] - eager["h"]).abs().max())
    dT = float((graph["t"] - eager["t"]).abs().max())
    ratio = graph["syncs"] / max(eager["syncs"], 1)
    print(f"# 3x {label}: graph driver ({graph.get('driver')}; capture "
          f"{graph.get('capture_s')} s, {graph.get('graph_launches')} launches) counts "
          f"{graph['counts']} water MBR {graph['mbr']} heat MBR {graph['heat_mbr']} wall "
          f"{graph['wall_s']} s host reads {graph['syncs']} peak {graph['peak_gib']} GiB; "
          f"eager driver counts {eager['counts']} water MBR {eager['mbr']} heat MBR "
          f"{eager['heat_mbr']} wall {eager['wall_s']} s"
          f"{' (profiled)' if on_card and eager.get('profiled') else ''} "
          f"host reads {eager['syncs']} peak {eager['peak_gib']} GiB; reads graph / eager "
          f"{ratio}; h bit-equal {same_h} (max |dh| {dh} m), T bit-equal {same_t} "
          f"(max |dT| {dT} K)", flush=True)
    check(graph["counts"] == eager["counts"],
          f"3x {label}: graph counts {graph['counts']}, eager {eager['counts']}")
    check(graph["mbr"] == eager["mbr"] and graph["heat_mbr"] == eager["heat_mbr"],
          f"3x {label}: MBRs {graph['mbr']} / {graph['heat_mbr']} vs {eager['mbr']} / "
          f"{eager['heat_mbr']}")
    check(same_h and same_t, f"3x {label}: graph-driven h {dh} m and T {dT} K from eager")
    if "launches" in graph and "launches" in eager:
        check(graph["launches"] == eager["launches"],
              f"3x {label}: {graph['launches']} bundle launches, eager {eager['launches']}")
    if on_card:
        check(graph.get("driver", "graph") == "graph",
              f"3x {label}: the card ran the {graph.get('driver')} driver")
        check(ratio <= 0.05, f"3x {label}: graph reads {graph['syncs']} > 5 % of "
                             f"eager {eager['syncs']}")
        check(graph["peak_gib"] <= 2.0 * eager["peak_gib"],
              f"3x {label}: graph peak {graph['peak_gib']} GiB > 2 x eager "
              f"{eager['peak_gib']}")
    return dict(counts=graph["counts"], mbr=graph["mbr"], heat_mbr=graph["heat_mbr"],
                graph_reads=graph["syncs"], eager_reads=eager["syncs"],
                graph_wall_s=graph["wall_s"], eager_wall_s=eager["wall_s"],
                capture_s=graph.get("capture_s"), graph_peak_gib=graph["peak_gib"],
                eager_peak_gib=eager["peak_gib"], launches=graph.get("launches"),
                dh_max=dh, dt_max=dT)


def bundle_coupled_graph_vs_eager(card: str, dev="cuda", n: int = 48) -> dict:
    """Phase 3x (v): a coupled storm hour through the CUDA bundle
    (``fast_f32(use_pallas=True, heat_vapor=True, heat_frozen_props=True)``)
    on an n x n box of the synthetic catchment, graph-driven and
    eager-driven (:func:`coupled_graph_vs_eager`); the bundle launched
    (launches x K = inner iterations), the hour's checks."""
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.bench import sync
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import build_coupled_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    on_card = torch_device_type(dev) == "cuda"
    params = SolverParameters.fast_f32(use_pallas=True, heat_vapor=True,
                                       heat_frozen_props=True)
    inputs = build_coupled_problem(synthetic_catchment(0, n=n, radius=n * 366.0 / 768),
                                   4.0, params, dev)
    runs = {}
    for driver in ("graph", "eager"):
        device_loop.clear()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        CP.reset_counts()
        device_loop.reset_counts()
        host_read.count = 0
        JB.jacobi_bundle.launches = 0
        t0 = time.time()
        if driver == "eager":
            with device_loop.forced_eager():
                w, h = CP.compute_period_coupled(inputs[0], params, *inputs[1:], 3600.0)
        else:
            w, h = CP.compute_period_coupled(inputs[0], params, *inputs[1:], 3600.0)
        sync(inputs[0].device)
        wall = time.time() - t0
        heat_mbr, t_min, t_max, _ = heat_outcome(f"bundle coupled hour ({driver})",
                                                 inputs[0], params, w, h)
        runs[driver] = dict(
            counts=CP.counts(), syncs=host_read.count, wall_s=wall,
            launches=JB.jacobi_bundle.launches, mbr=float(w.balance_whole.mbr),
            heat_mbr=heat_mbr, h=w.h.to("cpu"), t=h.t.to("cpu"),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0,
            driver="graph" if device_loop.counts()["graph_periods"] else "eager",
            capture_s=device_loop.counts()["capture_s"],
            graph_launches=device_loop.counts()["launches"])
        check(200.0 <= t_min and t_max <= 330.0 and math.isfinite(heat_mbr),
              f"bundle coupled hour ({driver}): T {t_min}..{t_max} K, heat MBR {heat_mbr}")
        check(abs(runs[driver]["mbr"]) < 2e-3,
              f"bundle coupled hour ({driver}): |water MBR| {runs[driver]['mbr']}")
    device_loop.clear()
    g = runs["graph"]
    K = JB.SWEEPS_PER_BUNDLE
    if on_card:
        check(g["launches"] > 0 and g["launches"] * K == g["counts"]["inner_iterations"],
              f"bundle coupled hour: {g['launches']} launches for "
              f"{g['counts']['inner_iterations']} sweeps")
    out = coupled_graph_vs_eager(f"bundle coupled hour, {n} box", g, runs["eager"], on_card)
    out["graph_launches"] = g["graph_launches"]
    return out


def heat_outcome(label, grid, params, water, heat):
    """The whole-period heat MBR (bench.py:279-282), the heat nodes' T
    range [K] and their share below 273.15 K."""
    import torch
    from criteria3d_tpu_torch.bench import coupled_heat_mbr
    heat_mbr = coupled_heat_mbr(grid, params, water, heat)
    heat_mask = grid.mask.clone()
    heat_mask[0] = False
    t_nodes = heat.t[heat_mask]
    check(bool(torch.isfinite(t_nodes).all()), f"{label}: non-finite heat-node temperatures")
    return (heat_mbr, float(t_nodes.min()), float(t_nodes.max()),
            float((t_nodes < 273.15).double().mean()))


def check_coupled(label, tensors, counts, launches, mbr, heat_mbr, t_min, t_max):
    """The checks of a coupled hour: every output on the card, no bundle
    launch, a heat sub-step ran, |water MBR| < 2e-3, a finite heat MBR and
    heat-node temperatures within [200, 330] K."""
    for name, t in tensors:
        check(t.device.type == "cuda", f"{label}: output {name} is on {t.device}")
    check(launches == 0, f"{label}: the CG coupled hour launched {launches} bundles")
    check(counts["heat_sweeps"] > 0 and counts["chunks"] > 0, f"{label}: no heat sub-step ran")
    check(abs(mbr) < 2e-3, f"{label}: |water whole-period MBR| {mbr} >= 2e-3")
    check(math.isfinite(heat_mbr), f"{label}: heat MBR {heat_mbr} is not finite")
    check(200.0 <= t_min and t_max <= 330.0,
          f"{label}: heat-node temperatures {t_min}..{t_max} K")


def small_coupled_card_vs_cpu(name: str):
    """phase 3f: a coupled hour of the 6 x 6 heat column on the card and on
    the CPU."""
    from criteria3d_tpu_torch.problems import SMALL_COUPLED_CONFIGS, small_coupled_hour
    make, t_tol, h_tol = SMALL_COUPLED_CONFIGS[name]
    params = make()
    (wc, hc, cc), (wp, hp, cp) = (small_coupled_hour(params, dev) for dev in ("cuda", "cpu"))
    dT = float((hc.t.cpu() - hp.t).abs().max())
    dh = float((wc.h.cpu() - wp.h).abs().max())
    print(f"# small coupled hour {name}: card {cc}; cpu {cp}; max |dT| {dT} K "
          f"(tolerance {t_tol}), max |dh| {dh} m (tolerance {h_tol})", flush=True)
    for key in ("steps", "attempts", "approximations", "chunks",
                "substeps_accepted", "substeps_rejected"):
        check(cc[key] == cp[key], f"small coupled hour {name}: {key} differ "
                                  f"between card {cc[key]} and CPU {cp[key]}")
    check(hc.t.device.type == "cuda" and hc.t.dtype == params.dtype,
          f"small coupled hour {name}: T is {hc.t.dtype} on {hc.t.device}")
    check(dT < t_tol, f"small coupled hour {name}: T differs by {dT} K")
    check(dh < h_tol, f"small coupled hour {name}: heads differ by {dh} m")
    return dT, dh


# 3f (ii): the float32 exact-mode coupled periods (ROADMAP C5): (box, net
# irradiance [W/m2], period [s]): problems.coupled_box's 12 box in
# tests/test_torch_coupled_machine.py's forced cache-rebuild case (every
# rejected sub-step rebuilds the energy cache), and a 32 box
EXACT_F32_CASES = ((12, 80.0, 1200.0), (32, 80.0, 900.0))


def exact_f32_coupled(card: str, dev="cuda") -> list:
    """Phase 3f (ii), ROADMAP C5: ``fast_f32(heat_vapor=True,
    heat_frozen_props=False)`` (exact mode: the coupled machine's
    cache-rebuild unit) over each of EXACT_F32_CASES, graph-driven and
    eager-driven on ``dev``: every count, both MBRs, h and T equal between
    the drivers (bit for bit); a sub-step rejected, so the cache rebuilt;
    |water MBR| < 2e-3; on the card the graph driver ran with at most 5 %
    of the eager run's host reads. (The same periods on the CPU, held to
    the card's within the fast exact periods' bar against JAX, run in
    tests/test_torch_cuda.py, which this script's time left no room for.)
    ``dev="cpu"`` rehearses it (every run eager)."""
    import contextlib
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import coupled_box
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    on_card = torch_device_type(dev) == "cuda"
    params = SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=False)
    out = []
    for n, irradiance, period in EXACT_F32_CASES:
        runs = {}
        for label, eager in (("graph", False), ("eager", True)):
            inputs = coupled_box(params, dev, n, irradiance)
            device_loop.clear()
            device_loop.reset_counts()
            CP.reset_counts()
            host_read.count = 0
            t0 = time.time()
            with device_loop.forced_eager() if eager else contextlib.nullcontext():
                w, h = CP.compute_period_coupled(inputs[0], params, *inputs[1:], period)
            _sync(dev)
            runs[label] = dict(counts=CP.counts(), reads=host_read.count,
                               wall_s=time.time() - t0, h=w.h.cpu(), t=h.t.cpu(),
                               mbrs=(float(w.balance_whole.mbr), float(h.mbr)),
                               drivers=device_loop.counts())
        device_loop.clear()
        g, e = runs["graph"], runs["eager"]
        same = torch.equal(g["h"], e["h"]) and torch.equal(g["t"], e["t"])
        print(f"# 3f exact-mode float32 coupled period, {n} box, {period} s ({card}): graph "
              f"counts {g['counts']} MBRs {g['mbrs']} wall {g['wall_s']} s host reads "
              f"{g['reads']} ({g['drivers']['launches']} launches, capture "
              f"{g['drivers']['capture_s']} s); eager wall {e['wall_s']} s host reads "
              f"{e['reads']}; h and T bit-equal between the drivers {same}", flush=True)
        check(g["counts"] == e["counts"] and g["mbrs"] == e["mbrs"] and same,
              f"3f exact {n} box: graph {g['counts']} {g['mbrs']}, eager {e['counts']} "
              f"{e['mbrs']}, h and T equal {same}")
        check(g["counts"]["substeps_rejected"] > 0,
              f"3f exact {n} box: no sub-step rejected, so no cache rebuild")
        check(abs(g["mbrs"][0]) < 2e-3, f"3f exact {n} box: |water MBR| {g['mbrs'][0]}")
        if on_card:
            check(g["drivers"]["graph_periods"] == 1 and e["drivers"]["eager_periods"] == 1,
                  f"3f exact {n} box: drivers {g['drivers']} / {e['drivers']}")
            check(g["reads"] <= 0.05 * e["reads"],
                  f"3f exact {n} box: graph reads {g['reads']} > 5 % of {e['reads']}")
        out.append(dict(n=n, period=period, counts=g["counts"], mbrs=g["mbrs"],
                        graph_reads=g["reads"], eager_reads=e["reads"],
                        graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"]))
    return out


# the model cycle's day: 2023-03-21 (problems.model_day_forcing)
MODEL_DATE = (2023, 3, 21)
MODEL_MEANS = ("global_radiation", "et0", "swe", "snow_melt", "evaporation",
               "transpiration")


def model_tensors(model):
    """Every tensor of a model's state, by name."""
    yield from (("water." + n, t) for n, t in tensors_of(model.water))
    for part in ("snow", "heat"):
        if getattr(model, part) is not None:
            yield from ((f"{part}.{n}", t) for n, t in tensors_of(getattr(model, part)))
    for name in ("lai", "degree_days", "canopy_storage", "slope_deg", "aspect_deg",
                 "total_evaporation_mm", "total_transpiration_mm",
                 "total_precipitation_m3"):
        yield name, getattr(model, name)


def model_hour(label, model, hour, card):
    """One ``run_hour`` of problems.model_day_forcing with the bundle
    launches and host reads set to 0 just before it and read just after.
    Prints the hour's wall, host syncs, solver stats, MBR, catchment means
    and shadowed share; checks every output and state tensor on the card,
    |MBR| < 2e-3, radiation finite within [0, 1400] W/m2 (0 before
    sunrise), SWE >= 0, ET0 >= 0. Returns a dict of what it measured."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.model import masked_mean
    from criteria3d_tpu_torch.problems import model_day_forcing
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    forcing = model_day_forcing(model.grid, None, hour)
    torch.cuda.synchronize()
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    t0 = time.time()
    out = model.run_hour(forcing, *MODEL_DATE, hour)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches, syncs = JB.jacobi_bundle.launches, host_read.count
    valid = model.grid.mask[0]
    means = {k: float(masked_mean(out[k], valid, device=True)) for k in MODEL_MEANS}
    shaded = float(masked_mean(out["shadow"].double(), valid, device=True))
    mbr = float(out["mbr"])
    glob = out["global_radiation"]
    g_min, g_max = float(glob.min()), float(glob.max())
    print(f"# {label} hour {hour} ({card}): wall {wall_s} s, host syncs {syncs}, "
          f"stats {out.get('solver_stats')}, MBR {mbr}, bundle launches {launches}; "
          "catchment means " + ", ".join(f"{k} {v}" for k, v in means.items())
          + f"; max SWE {float(out['swe'].max())} mm; global radiation "
          f"{g_min}..{g_max} W/m2; shadowed share of valid cells {shaded}", flush=True)
    for name, t in list(model_tensors(model)) + [
            (k, v) for k, v in out.items() if isinstance(v, torch.Tensor)]:
        check(t.device.type == "cuda", f"{label} hour {hour}: {name} is on {t.device}")
    check(abs(mbr) < 2e-3, f"{label} hour {hour}: |MBR| {mbr} >= 2e-3")
    check(bool(torch.isfinite(glob).all()) and g_min >= 0.0 and g_max <= 1400.0,
          f"{label} hour {hour}: global radiation {g_min}..{g_max} W/m2")
    if hour <= 6:
        check(g_max == 0.0, f"{label} hour {hour}: radiation {g_max} before sunrise")
    check(float(out["swe"].min()) >= 0.0, f"{label} hour {hour}: negative SWE")
    check(float(out["et0"].min()) >= 0.0, f"{label} hour {hour}: negative ET0")
    return dict(out=out, wall_s=wall_s, syncs=syncs, launches=launches, mbr=mbr,
                means=means, shaded=shaded)


def model_hours(label, model, hours, card):
    """:func:`model_hour` for each hour in turn; checks a snow pack after
    hour 7 and no bundle launch. Returns the per-hour dicts."""
    runs = []
    for hour in hours:
        r = model_hour(label, model, hour, card)
        check(r["launches"] == 0, f"{label} hour {hour}: {r['launches']} bundle launches")
        if hour == 7:
            check(float(r["out"]["swe"].max()) > 0.0, f"{label}: no snow after hour 7")
        runs.append(r)
    return runs


def model_coupled_hour(label, model, hour, card):
    """One coupled ``run_hour`` (compute_heat) with the coupled step's
    counts, the bundle launches and the host reads set to 0 just before
    it; the checks of :func:`check_coupled`, the water MBR in its |sink|
    form. Returns what it measured."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import model_day_forcing
    from criteria3d_tpu_torch.solver import coupled as C
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    forcing = model_day_forcing(model.grid, None, hour)
    grid, params = model.grid, model.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.reset_counts()
    device_loop.reset_counts()
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    t0 = time.time()
    out = model.run_hour(forcing, *MODEL_DATE, hour)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    counts, syncs, launches = C.counts(), host_read.count, JB.jacobi_bundle.launches
    drivers = device_loop.counts()
    # the model's coupled hour runs graph-driven with no change to model.py
    check(drivers["graph_periods"] == 1 and drivers["eager_periods"] == 0,
          f"{label} hour {hour}: the coupled period did not run graph-driven ({drivers})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    w, h = model.water, model.heat
    # the coupled period's own MBR divides by max(0.001, sink) without abs
    # (the JAX package's coupled.py:269): in a dry hour the net sink is
    # evaporation, negative, and that MBR is mbe / 0.001 m3; the mass gate
    # is held with |sink|, as compute_period_stats closes a water period
    mbr_signed = float(out["mbr"])
    bw = w.balance_whole
    mbr = float(bw.mbe / torch.clamp_min(torch.abs(bw.sink_source), 0.001))
    heat_mbr, t_min, t_max, _ = heat_outcome(label, grid, params, w, h)
    print(f"# {label} hour {hour} ({card}): water steps, attempts, approximations, CG "
          f"iterations = ({counts['steps']}, {counts['attempts']}, "
          f"{counts['approximations']}, {counts['inner_iterations']}); heat chunks "
          f"{counts['chunks']}, sub-steps accepted {counts['substeps_accepted']} "
          f"rejected {counts['substeps_rejected']}, heat sweeps {counts['heat_sweeps']}; "
          f"host syncs {syncs}; wall {wall_s} s; peak memory {peak:.2f} GiB; water "
          f"whole-period MBR {mbr} (|sink| form; the coupled period's signed-sink "
          f"MBR {mbr_signed}, sink {float(bw.sink_source)} m3); heat MBR {heat_mbr}; "
          f"heat-node T {t_min}..{t_max} K; bundle launches {launches}; graph driver: "
          f"{drivers['launches']} launches, capture {drivers['capture_s']} s", flush=True)
    check_coupled(label, list(model_tensors(model)) + [
        (k, v) for k, v in out.items() if isinstance(v, torch.Tensor)],
        counts, launches, mbr, heat_mbr, t_min, t_max)
    return dict(counts=counts, syncs=syncs, wall_s=wall_s, peak_gib=peak, mbr=mbr,
                mbr_signed=mbr_signed, heat_mbr=heat_mbr, t_min=t_min, t_max=t_max,
                graph_launches=drivers["launches"], capture_s=drivers["capture_s"])


# 3j: preset -> tolerances card vs CPU of the daily MBR [-], heads [m] and
# SWE [mm]
DAY_TOLERANCES = {"f64": (1e-8, 1e-6, 1e-6), "fast_f32": (1e-5, 1e-4, 1e-3)}


def model_day_card_vs_cpu(name: str, card: str):
    """phase 3j: ``run_period`` over the whole model day on a 32 box on the
    card and on the CPU, saving the daily state; the card's rasters read
    back by ``load_state``. Returns the card's and the CPU's wall [s]."""
    import datetime
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.io.state_io import load_state, state_dir_name
    from criteria3d_tpu_torch.problems import model_day_forcing, small_model
    mbr_tol, h_tol, swe_tol = DAY_TOLERANCES[name]
    params = SolverParameters() if name == "f64" else SolverParameters.fast_f32()
    first = datetime.date(*MODEL_DATE)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            m = small_model(params, dev)
            t0 = time.time()
            log = m.run_period(first, 1, lambda d, h, g=m.grid: model_day_forcing(g, d, h),
                               state_save_dir=os.path.join(tmp, dev), save_daily_state=True)
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = (m, log, time.time() - t0)
        (mc, lc, wc), (mp, lp, wp) = runs["cuda"], runs["cpu"]
        d_mbr = abs(lc[0]["mbr"] - lp[0]["mbr"])
        dh = float((mc.water.h.cpu() - mp.water.h).abs().max())
        d_swe = float((mc.snow.swe.cpu() - mp.snow.swe).abs().max())
        lai_rel = float(((mc.lai.cpu() - mp.lai).abs() / mp.lai.abs()).max())
        path = os.path.join(tmp, "cuda", state_dir_name(*MODEL_DATE, 23))
        w, _, extras = load_state(path, mc.grid, params)
    soil = mc.grid.mask.clone()
    soil[0] = False
    psi = (mc.water.h - mc.grid.z)[soil]
    d_file = (w.h[soil] - mc.water.h[soil]).abs()
    file_ok = bool((d_file <= psi.abs() * 2.0 ** -24 + 1e-12).all())
    print(f"# model day {name} ({card}): card {wc} s, CPU {wp} s; daily MBR card "
          f"{lc[0]['mbr']} CPU {lp[0]['mbr']} (|diff| {d_mbr}, tolerance {mbr_tol}); "
          f"dt_curr {float(mc.water.dt_curr)} / {float(mp.water.dt_curr)}; max |dh| "
          f"{dh} m (tolerance {h_tol}); max |dSWE| {d_swe} mm (tolerance {swe_tol}); "
          f"LAI rel {lai_rel}; max SWE {float(mp.snow.swe.max())} mm; rasters read back: "
          f"max |dh| {float(d_file.max())} m", flush=True)
    check(d_mbr < mbr_tol, f"model day {name}: daily MBR differs by {d_mbr}")
    check(float(mc.water.dt_curr) == float(mp.water.dt_curr),
          f"model day {name}: dt_curr differs")
    check(dh < h_tol, f"model day {name}: heads differ by {dh} m")
    check(torch.equal(mc.degree_days.cpu(), mp.degree_days),
          f"model day {name}: degree days differ")
    check(lai_rel < 1e-12, f"model day {name}: LAI differs by rel {lai_rel}")
    check(d_swe < swe_tol, f"model day {name}: SWE differs by {d_swe} mm")
    check(file_ok and sorted(extras) == ["degreeDays", "lai"] and w.h.is_cuda,
          f"model day {name}: the saved rasters do not give the heads back")
    return wc, wp


def model_phases(dem, seed: int, card: str) -> dict:
    """Phases 3g-3j on the catchment ``dem``; returns what they measured
    (the per-hour walls and host syncs of 3g, its peak memory, 3h's dict,
    3i's solver stats and bundle launches, 3j's walls)."""
    import copy
    import dataclasses
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.model import ModelConfig
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import (MODEL_CONFIG, build_model_problem,
                                               model_day_forcing, synthetic_catchment)
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    K = JB.SWEEPS_PER_BUNDLE

    # ---- 3g. the hourly model cycle at full size -------------------------
    t_model = time.time()
    p_model = SolverParameters.fast_f32()
    cfg = ModelConfig(**MODEL_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    model = build_model_problem(dem, 4.0, p_model, "cuda", cfg)
    model_box = "768 box (2,945,852 nodes)"
    runs_3g = model_hours("model cycle", model, range(6, 9), card)
    if sum(r["wall_s"] for r in runs_3g) > 50.0:
        # cut to a 384 box, as the time limit requires
        full_s = sum(r["wall_s"] for r in runs_3g)
        del model
        torch.cuda.empty_cache()
        model = build_model_problem(synthetic_catchment(seed, n=384, radius=183.0),
                                    4.0, p_model, "cuda", cfg)
        model_box = (f"384 box ({model.grid.n_nodes} nodes) for hours 9-11: hours 6-8 "
                     f"took {full_s} s on the full box")
        model_hours("model cycle, 384 box", model, range(6, 9), card)
    runs_3g += model_hours("model cycle", model, range(9, 12), card)
    peak_model = torch.cuda.max_memory_allocated() / 2**30
    walls_3g = [r["wall_s"] for r in runs_3g]
    wall_model = statistics.median(walls_3g)
    print(f"# model cycle on the {model_box} ({card}): walls {walls_3g} s (median "
          f"{wall_model}); host syncs {[r['syncs'] for r in runs_3g]}; peak memory "
          f"{peak_model:.2f} GiB", flush=True)
    busy_model, _, layers_model = breakdown(
        "model hour 12", lambda: dataclasses.replace(model).run_hour(
            model_day_forcing(model.grid, None, 12), *MODEL_DATE, 12), wall_model)
    check(busy_model > 0.0, "the profiler saw no device activity in the model hour")
    print(f"# model hour 12 ({card}): device time by layer "
          + "; ".join(f"{k} {layers_model.get(k, 0.0)} s" for k in layer_ranges()
                      + ("other",)), flush=True)
    del model
    torch.cuda.empty_cache()

    # ---- 3h. one coupled model hour at full size --------------------------
    p_mh = SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True)
    model = build_model_problem(dem, 4.0, p_mh, "cuda",
                                ModelConfig(compute_heat=True, **MODEL_CONFIG))
    twin = copy.copy(model)
    mh = model_coupled_hour("coupled model", model, 10, card)
    # the same hour from the same state, eager-driven: h and T bit-equal,
    # the graph-driven hour's peak at most 2 x this one's
    device_loop.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    host_read.count = 0
    t0 = time.time()
    with device_loop.forced_eager():
        twin.run_hour(model_day_forcing(twin.grid, None, 10), *MODEL_DATE, 10)
    torch.cuda.synchronize()
    mh.update(eager_wall_s=time.time() - t0, eager_syncs=host_read.count,
              eager_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    same = torch.equal(model.water.h, twin.water.h) and torch.equal(model.heat.t, twin.heat.t)
    print(f"# coupled model hour 10 eager-driven ({card}): wall {mh['eager_wall_s']} s, host "
          f"syncs {mh['eager_syncs']}, peak {mh['eager_peak_gib']} GiB (graph-driven "
          f"{mh['peak_gib']} GiB); h and T bit-equal to the graph-driven hour {same}",
          flush=True)
    check(same, "3h: the graph-driven coupled model hour differs from the eager one")
    check(mh["peak_gib"] <= 2.0 * mh["eager_peak_gib"],
          f"3h: graph peak {mh['peak_gib']} GiB > 2 x eager {mh['eager_peak_gib']}")
    del model, twin
    torch.cuda.empty_cache()

    # ---- 3i. one model hour through the CUDA bundle ----------------------
    model = build_model_problem(dem, 4.0, SolverParameters.fast_f32(use_pallas=True),
                                "cuda", cfg)
    r_3i = model_hour("model cycle, bundle", model, 8, card)
    launches_model = r_3i["launches"]
    stats_3i = r_3i["out"]["solver_stats"]
    check(launches_model > 0, "the model hour launched no jacobi_bundle kernel")
    check(launches_model * K == stats_3i[3],
          f"model hour: launches {launches_model} x K != sweeps {stats_3i[3]}")
    del model
    torch.cuda.empty_cache()

    # ---- 3j. a whole day on the card against the CPU ---------------------
    walls_3j = {name: model_day_card_vs_cpu(name, card) for name in DAY_TOLERANCES}
    model_s = time.time() - t_model
    print(f"# phases 3g-3j took {model_s} s ({card})", flush=True)
    return dict(box=model_box, walls=walls_3g, syncs=[r["syncs"] for r in runs_3g],
                peak_gib=peak_model, coupled=mh, stats_bundle=stats_3i,
                launches_bundle=launches_model, walls_day=walls_3j, seconds=model_s)


# the project phases: problems.write_project's day, 2023-03-21 (local time)
# (hours 6-11 until the side phases joined the run, 6-9 until the shell
# phases did, whose 3q runs hours 6-8 of the same project; the script stays
# near 600 s)
PROJECT_3K_HOURS = (6, 2)          # first hour, hours
# the coupled hours: the frosty night from 00 h (from a fresh model the
# morning's snow and rain hours take 2,000 heat sub-steps each); hours 0-2
# until the side phases joined the run
PROJECT_3L_HEAT_HOURS = (0, 1)
# the 32 box's float64 hours (first hour, hours), the daily update at 23 h
# (the whole day from 00 h until the library phases joined the run)
PROJECT_3L_HOURS = (12, 12)


def instrument_run_hour(prj, records: list, keep_forcing: bool = False,
                        dev="cuda") -> None:
    """Wrap the project's ``run_hour`` so that each hour appends its wall
    (the device synchronised before and after), host reads, solver stats and
    MBR (a 0-d tensor, read later) to ``records``; with ``keep_forcing``
    also the hour's forcing maps, copied to the host."""
    from criteria3d_tpu_torch.device import host_read
    inner = prj.run_hour

    def run_hour(when, **kw):
        _sync(dev)
        host_read.count = 0
        t0 = time.time()
        out = inner(when, **kw)
        _sync(dev)
        rec = dict(when=when, wall_s=time.time() - t0, syncs=host_read.count,
                   stats=out.get("solver_stats"), mbr=out["mbr"])
        if keep_forcing:
            f = out["forcing"]
            rec["forcing"] = {k: getattr(f, k).cpu() for k in
                              ("air_temperature", "precipitation", "rel_humidity",
                               "wind_speed")}
            rec["transmissivity"] = f.transmissivity
        records.append(rec)
        return out

    prj.run_hour = run_hour


def record_daily_update(model, updates: list) -> None:
    """Wrap the model's ``daily_update`` so that each call appends its date
    and its Tmin / Tmax maps, copied to the host, to ``updates``."""
    inner = model.daily_update

    def daily_update(t_min, t_max, *, date=None):
        updates.append((date, t_min.cpu(), t_max.cpu()))
        return inner(t_min, t_max, date=date)

    model.daily_update = daily_update


def project_files(prj):
    """The project's output rasters (path -> array read back) and
    output-point tables (name -> rows)."""
    import sqlite3
    from criteria3d_tpu_torch.io.esri import read_flt
    rasters = {}
    root = os.path.join(prj.output_dir, "rasters")
    for day in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, day))):
            if f.endswith(".flt"):
                rasters[f"{day}/{f}"] = read_flt(os.path.join(root, day, f))
    con = sqlite3.connect(prj.config.output_db_path)
    tables = {t: con.execute(f'SELECT * FROM "{t}" ORDER BY time').fetchall()
              for (t,) in con.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    con.close()
    return rasters, tables


def project_full_size(seed: int, card: str, tmp: str) -> dict:
    """phase 3k: problems.write_project at n = 768 with 20 stations, then
    Criteria3DProject.load, initialize(fast=True) on the card and
    run_period over hours 6-7 with outputs; one more hour profiled."""
    import datetime
    import numpy as np
    import torch
    from criteria3d_tpu_torch.outputs import OUTPUTS_RANGE
    from criteria3d_tpu_torch.problems import PROJECT_DATE, write_project
    from criteria3d_tpu_torch.project import (INTERPOLATION_RANGE, Criteria3DProject,
                                              state_maps)
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    t0 = time.time()
    ini = write_project(os.path.join(tmp, "p768"), n=768, seed=seed, n_stations=20)
    write_s = time.time() - t0
    t0 = time.time()
    prj = Criteria3DProject.load(ini, output_dir=os.path.join(tmp, "out768"))
    load_s = time.time() - t0
    t0 = time.time()
    prj.initialize(fast=True)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    g = prj.grid
    check(g.device.type == "cuda" and prj.model.water.h.is_cuda,
          "3k: the project did not build on the card")
    check(prj.params.inner_solver == "cg" and prj.params.cg_precond == "line",
          f"3k: initialize(fast=True) gave {prj.params}")
    print(f"# project 768 ({card}): wrote the project in {write_s:.1f} s, loaded in "
          f"{load_s:.1f} s (stations {len(prj.stations)}), initialized in {init_s:.1f} s; "
          f"grid {g.shape} nodes {g.n_nodes} surface {g.n_surface_nodes}; forest cells "
          f"{int(prj.model.forest_mask.sum())}", flush=True)

    first, n_hours = PROJECT_3K_HOURS
    start = datetime.datetime(*PROJECT_DATE, first)
    records = []
    instrument_run_hour(prj, records)
    torch.cuda.reset_peak_memory_stats()
    JB.jacobi_bundle.launches = 0
    t0 = time.time()
    log = prj.run_period(start, n_hours)
    period_s = time.time() - t0
    launches = JB.jacobi_bundle.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for rec, e in zip(records, log):
        print(f"# project 768 hour {rec['when'].hour} ({card}): wall {rec['wall_s']} s, "
              f"host reads {rec['syncs']}, stats {rec['stats']}, MBR {e['mbr']}", flush=True)
        check(abs(e["mbr"]) < 2e-3, f"3k hour {rec['when'].hour}: |MBR| {e['mbr']} >= 2e-3")
    check(launches == 0, f"3k: the project hours launched {launches} jacobi_bundle kernels")
    rasters, tables = project_files(prj)
    n_vars = sum(len(d) for d in prj.output_variables().values())
    check(len(rasters) == n_hours * n_vars,
          f"3k: {len(rasters)} rasters written, expected {n_hours * n_vars}")
    valid = prj.grid.mask[0].cpu().numpy()
    for name, (data, hdr) in rasters.items():
        check(data.shape == (768, 768) and hdr.cellsize == 4.0, f"3k: {name} reads back {data.shape}")
        inside = data[valid & (data != -9999.0)]
        check(inside.size > 0 and bool(np.isfinite(inside).all()),
              f"3k: {name} has no finite values on the catchment")
    rows = sum(len(r) for r in tables.values())
    check(len(tables) == len(prj.output_points.ids) and rows == n_hours * len(tables),
          f"3k: output DB has {len(tables)} tables and {rows} rows")
    walls = [r["wall_s"] for r in records]
    print(f"# project 768 ({card}): run_period {period_s} s for {n_hours} hours (walls {walls}); "
          f"peak memory {peak:.2f} GiB; spatial QC turned away {prj.qc_rejected} "
          f"station readings; {len(rasters)} rasters ({2 * len(rasters)} files) and "
          f"{rows} output-DB rows in {len(tables)} tables written; bundle launches "
          f"{launches}", flush=True)

    # one more hour profiled, its outputs staged and flushed
    when = start + datetime.timedelta(hours=n_hours)
    ranges = layer_ranges() + (INTERPOLATION_RANGE, OUTPUTS_RANGE)
    busy, _, layers = breakdown(
        f"project hour {when.hour}", lambda: (prj.run_hour(when), prj.flush_outputs()),
        statistics.median(walls), ranges=ranges)
    check(busy > 0.0, "the profiler saw no device activity in the project hour")
    interp_s, out_s = layers.get(INTERPOLATION_RANGE, 0.0), layers.get(OUTPUTS_RANGE, 0.0)
    check(interp_s > 0.0 and out_s > 0.0,
          f"3k: no device time in the interpolation ({interp_s}) or outputs ({out_s}) range")
    print(f"# project hour {when.hour} ({card}): device time by layer "
          + "; ".join(f"{k} {layers.get(k, 0.0)} s" for k in ranges + ("other",)), flush=True)
    # the last hour's root-zone water content, for 3u's NetCDF export
    swc, _ = state_maps(g, prj.params, prj.model.water)
    return dict(walls=walls, syncs=[r["syncs"] for r in records],
                stats=[r["stats"] for r in records], mbrs=[e["mbr"] for e in log],
                peak_gib=peak, launches=launches, qc_rejected=prj.qc_rejected,
                rasters=len(rasters), rows=rows, busy_s=busy, interpolation_s=interp_s,
                outputs_s=out_s, nodes=g.n_nodes, swc_map=swc)


def project_day_card_vs_cpu(seed: int, card: str, tmp: str) -> dict:
    """phase 3l: a 32 box project under its float64 parameters on the card
    and on the CPU, PROJECT_3L_HOURS of the day (the daily update at 23 h),
    then the first coupled hour of the same project with compute_heat
    (heat vapor and advection on)."""
    import datetime
    import numpy as np
    import torch
    from criteria3d_tpu_torch.problems import PROJECT_DATE, write_project
    from criteria3d_tpu_torch.project import Criteria3DProject
    from criteria3d_tpu_torch.solver import coupled as C
    day = datetime.datetime(*PROJECT_DATE)
    ini = write_project(os.path.join(tmp, "p32"), n=32, seed=seed, n_stations=6)
    runs = {}
    for dev in ("cuda", "cpu"):
        prj = Criteria3DProject.load(ini, output_dir=os.path.join(tmp, f"out32_{dev}"))
        prj.initialize(device=dev)
        records, updates = [], []
        instrument_run_hour(prj, records, keep_forcing=True)
        record_daily_update(prj.model, updates)
        t0 = time.time()
        log = prj.run_period(day + datetime.timedelta(hours=PROJECT_3L_HOURS[0]),
                             PROJECT_3L_HOURS[1])
        runs[dev] = (prj, records, log, time.time() - t0)
        check(len(updates) == 1 and updates[0][0] == day.date(),
              f"3l: daily_update ran {len(updates)} times ({dev})")
        runs[dev] += (updates[0],)
    (pc, rc, lc, wc, uc), (pp, rp, lp, wp, up) = runs["cuda"], runs["cpu"]
    check(pc.params.sweep_dtype is None and pc.model.water.h.is_cuda,
          "3l: the day is not the float64 path on the card")
    f_rel = 0.0
    for a, b in zip(rc, rp):
        for k, v in b["forcing"].items():
            d = float((a["forcing"][k] - v).abs().max())
            f_rel = max(f_rel, d / max(float(v.abs().max()), 1e-300))
        t_rel = abs(a["transmissivity"] - b["transmissivity"]) / b["transmissivity"]
        f_rel = max(f_rel, t_rel)
        check(a["stats"][:3] == b["stats"][:3],
              f"3l hour {a['when'].hour}: stats {a['stats']} (card) {b['stats']} (CPU)")
    d_mbr = max(abs(a["mbr"] - b["mbr"]) for a, b in zip(lc, lp))
    dh = float((pc.model.water.h.cpu() - pp.model.water.h).abs().max())
    # the daily update's per-cell Tmin / Tmax maps, then its degree days and LAI
    tx_rel = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                 for a, b in zip(uc[1:], up[1:]))
    valid = pp.grid.mask[0]
    t_span = float((up[2] - up[1])[valid].max())
    dd_rel = max(float(((getattr(pc.model, k).cpu() - getattr(pp.model, k)).abs()
                        / getattr(pp.model, k).abs().clamp_min(1e-300)).max())
                 for k in ("degree_days", "lai"))
    (rast_c, tab_c), (rast_p, tab_p) = project_files(pc), project_files(pp)
    check(sorted(rast_c) == sorted(rast_p) and len(rast_c) == PROJECT_3L_HOURS[1] * 4,
          f"3l: rasters differ in name or number ({len(rast_c)}, {len(rast_p)})")
    ulp = 0
    for name, (a, _) in rast_c.items():
        b = rast_p[name][0].astype(np.float32)
        a = a.astype(np.float32)
        check(bool((np.isnan(a) == np.isnan(b)).all()), f"3l: {name} NaN cells differ")
        fin = ~np.isnan(a)
        ulp = max(ulp, int(np.abs(a[fin].view(np.int32).astype(np.int64)
                                 - b[fin].view(np.int32).astype(np.int64)).max()))
    db_rel = 0.0
    check(sorted(tab_c) == sorted(tab_p), "3l: output DB tables differ")
    for t, rows in tab_c.items():
        check(len(rows) == len(tab_p[t]) == PROJECT_3L_HOURS[1],
              f"3l: {t} has {len(rows)} rows")
        for r, q in zip(rows, tab_p[t]):
            check(r[0] == q[0], f"3l: {t} times differ")
            a, b = np.asarray(r[1:], float), np.asarray(q[1:], float)
            db_rel = max(db_rel, float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max()))
    print(f"# project day 32 box ({card}): card {wc} s, CPU {wp} s; {pc.grid.n_nodes} nodes; "
          f"stats card {[r['stats'] for r in rc]}; max |dMBR| per hour {d_mbr} (tolerance "
          f"1e-8); max |dh| {dh} m (1e-6); forcing maps and transmissivity rel {f_rel} "
          f"(1e-12); the 23 h update's Tmin / Tmax maps rel {tx_rel} (1e-12, daily span up "
          f"to {t_span} K), degree days and LAI rel {dd_rel}; rasters within {ulp} "
          f"float32 ulp (1); output DB rel {db_rel} (1e-9); spatial QC turned away "
          f"{pc.qc_rejected} readings", flush=True)
    check(f_rel <= 1e-12, f"3l: forcing maps differ by rel {f_rel}")
    check(d_mbr < 1e-8, f"3l: hourly MBRs differ by {d_mbr}")
    check(dh < 1e-6, f"3l: heads differ by {dh} m")
    check(tx_rel <= 1e-12 and t_span > 0.0 and dd_rel <= 1e-12,
          f"3l: the daily update did not run alike (Tmin / Tmax rel {tx_rel}, "
          f"span {t_span} K, degree days and LAI rel {dd_rel})")
    check(ulp <= 1, f"3l: rasters differ by {ulp} float32 ulp")
    check(db_rel < 1e-9, f"3l: output DB values differ by rel {db_rel}")

    # the coupled hour: compute_heat turns on heat vapor and advection
    ini_h = write_project(os.path.join(tmp, "p32h"), n=32, seed=seed, n_stations=6,
                          compute_heat=True)
    first, n_hours = PROJECT_3L_HEAT_HOURS
    heat = {}
    for dev in ("cuda", "cpu"):
        prj = Criteria3DProject.load(ini_h, output_dir=os.path.join(tmp, f"out32h_{dev}"))
        prj.initialize(device=dev)
        check(prj.params.heat_vapor and prj.params.heat_advection and prj.model.heat is not None,
              "3l: compute_heat did not turn on vapor and advection")
        C.reset_counts()
        t0 = time.time()
        log = prj.run_period(day + datetime.timedelta(hours=first), n_hours)
        heat[dev] = (prj, log, C.counts(), time.time() - t0)
    (hc, lhc, cc, whc), (hp, lhp, cp, whp) = heat["cuda"], heat["cpu"]
    dT = float((hc.model.heat.t.cpu() - hp.model.heat.t).abs().max())
    dh_h = float((hc.model.water.h.cpu() - hp.model.water.h).abs().max())
    print(f"# project coupled hours {first}-{first + n_hours - 1}, 32 box ({card}): card "
          f"{whc} s, CPU {whp} s; counts card {cc} CPU {cp}; MBR card "
          f"{[e['mbr'] for e in lhc]} CPU {[e['mbr'] for e in lhp]}; max |dT| {dT} K "
          f"(tolerance 1e-6), max |dh| {dh_h} m (1e-6)", flush=True)
    for key in ("steps", "attempts", "approximations", "chunks",
                "substeps_accepted", "substeps_rejected"):
        check(cc[key] == cp[key], f"3l coupled: {key} differ, card {cc[key]} CPU {cp[key]}")
    check(cc["heat_sweeps"] > 0 and hc.model.heat.t.is_cuda, "3l coupled: no heat sweep on the card")
    check(dT < 1e-6, f"3l coupled: T differs by {dT} K")
    check(dh_h < 1e-6, f"3l coupled: heads differ by {dh_h} m")
    return dict(walls_day=(wc, wp), d_mbr=d_mbr, dh=dh, f_rel=f_rel, ulp=ulp, db_rel=db_rel,
                walls_heat=(whc, whp), dT=dT, dh_heat=dh_h, counts_heat=cc)


def project_phases(seed: int, card: str) -> dict:
    """Phases 3k and 3l (the project stack); returns what they measured."""
    import torch
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        full = project_full_size(seed, card, tmp)
        torch.cuda.empty_cache()
        small = project_day_card_vs_cpu(seed, card, tmp)
    seconds = time.time() - t0
    print(f"# phases 3k-3l took {seconds} s ({card})", flush=True)
    return dict(full=full, small=small, seconds=seconds)


# ----------------------------------------------------------------------
# the side process models: HYDRALL and RothC in the model cycle (3m, 3n)
# and the VINE3D project (3o, 3p)
# ----------------------------------------------------------------------

# 3m: hours 10-13 of the model day (daylight, dry), then hour 14 profiled
HYDRALL_HOURS = (10, 11, 12, 13)
# 3o / 3p: the vine project's summer day (problems.VINE_DATE); 3o runs the
# late morning and the irrigated last hours, then hour 14 profiled
VINE_HOURS = (11, 12, 13, 22, 23)
# 3o: the canopy-flux window held against the CPU (rows, cols)
VINE_WINDOW = (slice(352, 416), slice(352, 416))
# 3p: the vine day's box (32 until the shell phases joined the run; the
# script stays near 600 s)
VINE_3P_BOX = 16


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(torch.device(dev))


def _peak_gib(dev, reset: bool = False) -> float:
    """Peak device memory [GiB] since the last reset (0 on the CPU)."""
    import torch
    if torch.device(dev).type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2**30


def _profiled(label, run, wall_s, ranges, dev, eager: bool = False):
    """:func:`breakdown` on the card (``eager``: the run under the eager
    driver, whose units' ranges the profiler sees; a replayed graph shows
    it the kernels only); on the CPU (a rehearsal) the run only (there is
    no device time to measure)."""
    import contextlib
    from criteria3d_tpu_torch.solver import device_loop
    with device_loop.forced_eager() if eager else contextlib.nullcontext():
        if torch_device_type(dev) != "cuda":
            run()
            return 1.0, {}, {r: 1.0 for r in ranges}
        return breakdown(label, run, wall_s, ranges=ranges)


def torch_device_type(dev) -> str:
    import torch
    return torch.device(dev).type


def recording(module, name: str, store: list, stops: bool = False):
    """Replace ``module.name`` by a wrapper that appends each call's
    keyword arguments (with ``stops``: a fixed point's per-cell stop
    information) to ``store``; returns the original, to put back."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        if stops:
            *out, info = orig(*args, return_stop=True, **kw)
            store.append(info)
            return tuple(out)
        store.append((args, kw))
        return orig(*args, **kw)

    # the fixed points count their iterations on the module's function
    wrapper.iterations = wrapper.calls = 0
    setattr(module, name, wrapper)
    return orig


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (0 when both are 0)."""
    import torch
    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max()) if b.numel() else 0.0
    d = float((a - b).abs().max()) if b.numel() else 0.0
    return d / scale if scale > 0.0 else d


def stop_flips(stops_a, stops_b, tol: float = 1e-7):
    """(flipped cells, cells) of the fixed-point calls of two runs: cells
    whose stop iteration differs; a flipped cell's |dASS| on the run that
    stopped must lie within rounding of ``tol``."""
    flips = cells = 0
    for a, b in zip(stops_a, stops_b):
        sa, sb = a["stop"].cpu(), b["stop"].cpu()
        diff = sa != sb
        cells += sa.numel()
        flips += int(diff.sum())
        if diff.any():
            d = a["d_ass"].cpu()[diff & (sa >= 0)]
            check(bool((d <= tol * (1.0 + 1e-6)).all()),
                  f"a stop flip with |dASS| {float(d.max())} away from tol")
    return flips, cells


def _flat_tensors(obj, prefix: str = ""):
    """Every tensor of a tensor, tuple, list, dict or dataclass, by path."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, (tuple, list)):
        for k, v in enumerate(obj):
            yield from _flat_tensors(v, f"{prefix}[{k}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flat_tensors(v, f"{prefix}.{k}")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _flat_tensors(getattr(obj, f.name), f"{prefix}.{f.name}")


def fixed_point_drivers(label: str, run, module, kernel: str, dev) -> dict:
    """A call that reaches the fixed point ``module.kernel`` (``run()``)
    graph-driven and eager-driven on ``dev``, each call's per-cell stops
    recorded: every output bit-equal, every call's stop iterations and
    |dASS| equal; on the card each call of the graph run graph-driven in
    one launch of the machine (one host read), none eager. Prints both
    runs' walls, host reads, calls, launches and peaks; returns them."""
    import contextlib
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.physics import fixed_point as FP
    from criteria3d_tpu_torch.solver import device_loop
    on_card = torch_device_type(dev) == "cuda"
    runs = {}
    # each call's least bytes an iteration (FP.iteration_bytes)
    moved = []
    fp_run = FP.run

    def run_and_size(kind, body, inputs, carries, *args, **kw):
        moved.append(FP.iteration_bytes(inputs, carries))
        return fp_run(kind, body, inputs, carries, *args, **kw)
    for driver in ("graph", "eager"):
        stops = []
        orig = recording(module, kernel, stops, stops=True)
        FP.run = run_and_size
        try:
            _sync(dev)
            _peak_gib(dev, reset=True)
            device_loop.reset_counts()
            host_read.count = 0
            t0 = time.time()
            with device_loop.forced_eager() if driver == "eager" else contextlib.nullcontext():
                out = run()
            _sync(dev)
            runs[driver] = dict(out=out, stops=stops, wall_s=time.time() - t0,
                                reads=host_read.count, drivers=device_loop.counts(),
                                peak_gib=_peak_gib(dev))
        finally:
            setattr(module, kernel, orig)
            FP.run = fp_run
    g, e = runs["graph"], runs["eager"]
    ga, ea = dict(_flat_tensors(g["out"])), dict(_flat_tensors(e["out"]))
    differ = [k for k in ea if not torch.equal(ga[k], ea[k])]
    same_stops = len(g["stops"]) == len(e["stops"]) and all(
        torch.equal(a["stop"], b["stop"]) and torch.equal(a["d_ass"], b["d_ass"])
        for a, b in zip(g["stops"], e["stops"]))
    gd, calls = g["drivers"], len(g["stops"])
    iterations = [int(st["iterations"]) for st in g["stops"]]
    # the bound of one iteration: its least bytes over the card's rate
    bound_ms = [b / HBM_BYTES_PER_S * 1e3 for b in moved[:calls]]
    graph_ms = g["wall_s"] * 1e3 / max(sum(iterations), 1)
    print(f"# {label} graph vs eager ({torch_device_type(dev)}): {calls} fixed-point calls, "
          f"iterations {iterations}; an iteration's least bytes {moved[:calls]}, bound "
          f"{bound_ms} ms (bytes), graph-driven wall {graph_ms} ms an iteration; graph "
          f"{gd['graph_fixed_points']} "
          f"calls in {gd['launches']} launches (capture {gd['capture_s']} s), wall "
          f"{g['wall_s']} s, host reads {g['reads']}, peak {g['peak_gib']} GiB; eager wall "
          f"{e['wall_s']} s, host reads {e['reads']}, peak {e['peak_gib']} GiB; outputs "
          f"bit-equal {not differ} ({len(ea)} tensors), stops equal {same_stops}",
          flush=True)
    check(calls > 0 and not differ and ga.keys() == ea.keys(),
          f"{label}: the graph-driven outputs differ from the eager ones: {differ[:5]}")
    check(same_stops, f"{label}: the stop iterations differ between the drivers")
    if on_card:
        check(gd["graph_fixed_points"] == calls and gd["eager_fixed_points"] == 0
              and gd["launches"] == calls,
              f"{label}: {calls} fixed-point calls, drivers {gd}")
    return dict(calls=calls, graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"],
                iteration_bytes=moved[:calls], iteration_bound_ms=bound_ms,
                graph_ms_per_iteration=graph_ms, graph_reads=g["reads"], eager_reads=e["reads"],
                graph_peak_gib=g["peak_gib"], eager_peak_gib=e["peak_gib"],
                launches=gd["launches"], capture_s=gd["capture_s"])


def hydrall_full_size(dem, seed: int, card: str, dev="cuda") -> dict:
    """phase 3m: HYDRALL and RothC in the model cycle at full size
    (``problems.build_hydrall_problem`` under ``fast_f32()``): hours 10-13
    of the model day, hour 14 profiled, hour 13's ``hydrall_hour`` on the
    card and on the CPU, then the Jan-1 annual step and a monthly RothC
    step."""
    import dataclasses
    import datetime
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.model import masked_mean
    from criteria3d_tpu_torch.physics import hydrall as HY
    from criteria3d_tpu_torch.problems import build_hydrall_problem, model_day_forcing
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    _peak_gib(dev, reset=True)
    t0 = time.time()
    model = build_hydrall_problem(dem, 4.0, SolverParameters.fast_f32(), dev, seed=seed)
    _sync(dev)
    forest = model.forest_mask
    n_forest = int(forest.sum())
    print(f"# hydrall model ({card}): built in {time.time() - t0:.1f} s; "
          f"{model.grid.n_nodes} nodes, {n_forest} forest cells", flush=True)
    captured = []
    orig = recording(HY, "hydrall_hour", captured)
    runs = []
    try:
        for hour in HYDRALL_HOURS:
            forcing = model_day_forcing(model.grid, None, hour)
            del captured[:]
            _sync(dev)
            JB.jacobi_bundle.launches = 0
            host_read.count = 0
            HY.photosynthesis_kernel.iterations = 0
            device_loop.reset_counts()
            t0 = time.time()
            out = model.run_hour(forcing, *MODEL_DATE, hour)
            _sync(dev)
            wall = time.time() - t0
            syncs, launches = host_read.count, JB.jacobi_bundle.launches
            iters = HY.photosynthesis_kernel.iterations
            fixed = device_loop.counts()["graph_fixed_points"]
            mbr = float(out["mbr"])
            assim, transp = out["hydrall_assimilation"], out["hydrall_transpiration"]
            a_mean = float(masked_mean(assim, forest, device=True))
            t_mean = float(masked_mean(transp, forest, device=True))
            print(f"# hydrall model hour {hour} ({card}): wall {wall} s, host reads {syncs}, "
                  f"stats {out['solver_stats']}, MBR {mbr}, fixed-point iterations {iters} "
                  f"(2 calls, {fixed} graph-driven), forest means: assimilation {a_mean} mol m-2 s-1, "
                  f"transpiration {t_mean} mm; bundle launches {launches}", flush=True)
            for name, t in list(tensors_of(model.hydrall)) + list(tensors_of(model.rothc)) + [
                    (k, v) for k, v in out.items() if isinstance(v, torch.Tensor)]:
                check(t.device.type == torch_device_type(dev),
                      f"3m hour {hour}: {name} is on {t.device}")
            check(abs(mbr) < 2e-3, f"3m hour {hour}: |MBR| {mbr} >= 2e-3")
            check(launches == 0, f"3m hour {hour}: {launches} bundle launches")
            check(iters >= 2, f"3m hour {hour}: {iters} fixed-point iterations")
            check(bool(torch.isfinite(assim).all()) and bool(torch.isfinite(transp).all())
                  and float(transp.min()) >= 0.0 and a_mean > 0.0,
                  f"3m hour {hour}: HYDRALL outputs out of range")
            check(float(transp[~forest].abs().max()) == 0.0,
                  f"3m hour {hour}: transpiration outside the forest")
            if torch_device_type(dev) == "cuda":
                check(fixed == 2, f"3m hour {hour}: {fixed} of 2 fixed points graph-driven")
            runs.append(dict(wall_s=wall, syncs=syncs, iterations=iters, mbr=mbr,
                             stats=out["solver_stats"], fixed_points=fixed))
    finally:
        HY.hydrall_hour = orig
    peak = _peak_gib(dev)
    walls = [r["wall_s"] for r in runs]
    # eager-driven: the profiler sees the units' ranges (c3d.hydrall's among
    # them) only off a graph
    busy, _, layers = _profiled(
        "hydrall model hour 14 (eager-driven)", lambda: dataclasses.replace(model).run_hour(
            model_day_forcing(model.grid, None, 14), *MODEL_DATE, 14),
        statistics.median(walls), layer_ranges() + (HY.HYDRALL_RANGE,), dev, eager=True)
    hyd_s = layers.get(HY.HYDRALL_RANGE, 0.0)
    check(busy > 0.0 and hyd_s > 0.0,
          f"3m: no device time in the hour ({busy}) or in {HY.HYDRALL_RANGE} ({hyd_s})")
    print(f"# hydrall model hour 14 ({card}): {HY.HYDRALL_RANGE} {hyd_s} s of device "
          f"busy {busy} s ({hyd_s / busy}); peak memory {peak:.2f} GiB", flush=True)

    # the last hour's hydrall_hour on its own inputs, card against CPU
    (args, kw), = captured
    results = {}
    for d in (dev, "cpu"):
        stops = []
        orig_k = recording(HY, "photosynthesis_kernel", stops, stops=True)
        try:
            maps = args[0].to(d)
            kw_d = {k: v.to(d) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            results[d] = HY.hydrall_hour(maps, **kw_d) + (stops,)
        finally:
            HY.photosynthesis_kernel = orig_k
    (mc, oc, sc), (mp, op, sp) = results[dev], results["cpu"]
    flips, cells = stop_flips(sc, sp)
    rels = {k: rel_err(oc[k], op[k]) for k in op}
    rels.update({f"maps.{n}": rel_err(t, dict(tensors_of(mp))[n]) for n, t in tensors_of(mc)})
    worst = max(rels.values())
    print(f"# hydrall_hour card vs CPU on hour 13's inputs ({card}): stop flips {flips} of "
          f"{cells} cells; max rel {worst} ({max(rels, key=rels.get)}; tolerance 1e-12)",
          flush=True)
    if flips == 0:
        check(worst <= 1e-12, f"3m: hydrall_hour card vs CPU rel {worst}")
    else:   # a flip moves a cell's output by up to tol (1e-7 mol m-2 s-1)
        check(float((oc["assimilation"].cpu() - op["assimilation"]).abs().max()) <= 4e-7,
              "3m: a stop flip moved the assimilation by more than 2 tol x 2 leaves")
    # the same call graph-driven against eager-driven on the card
    maps = args[0].to(dev)
    kw_d = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    drivers = fixed_point_drivers("3m hydrall_hour on hour 13's inputs",
                                  lambda: HY.hydrall_hour(maps, **kw_d), HY,
                                  "photosynthesis_kernel", dev)

    # the Jan-1 annual step and one monthly RothC step on the card
    t0 = time.time()
    model.daily_update(-3.0, 8.5, date=datetime.date(2024, 1, 1))
    diag = model.monthly_rothc_update(torch.tensor(4.0, dtype=torch.float64, device=dev),
                                      60.0, 25.0)
    _sync(dev)
    step_s = time.time() - t0
    litter = model._rothc_litter
    check(isinstance(litter, torch.Tensor) and litter.device.type == torch_device_type(dev)
          and bool(torch.isfinite(litter).all())
          and float(litter.min()) > 0.0, "3m: the annual step gave no litter map on the card")
    soc = masked_mean(model.rothc.soc, model.grid.mask[0])
    check(math.isfinite(soc) and float(diag["co2"].min()) >= 0.0,
          f"3m: RothC after the monthly step: SOC {soc}")
    print(f"# hydrall model ({card}): Jan-1 annual step + monthly RothC step {step_s} s; "
          f"litter {float(litter.mean())} kg C m-2 (map mean), catchment SOC {soc} t C/ha, "
          f"monthly CO2 {float(diag['co2'].mean())} t C/ha", flush=True)
    return dict(walls=walls, syncs=[r["syncs"] for r in runs],
                iterations=[r["iterations"] for r in runs], mbrs=[r["mbr"] for r in runs],
                stats=[r["stats"] for r in runs], peak_gib=peak, busy_s=busy,
                hydrall_s=hyd_s, flips=flips, rel=worst, step_s=step_s,
                drivers=drivers, fixed_points=[r["fixed_points"] for r in runs])


def dry_day_forcing(grid, date, hour):
    """problems.model_day_forcing without its snow and rain: 4 K warmer,
    70 % humidity, wind 2 m/s, transmissivity 0.6 (a dry winter day)."""
    import dataclasses
    import torch
    from criteria3d_tpu_torch.problems import model_day_forcing
    f = model_day_forcing(grid, date, hour)
    t = f.air_temperature
    return dataclasses.replace(
        f, air_temperature=t + 4.0, precipitation=torch.zeros_like(t),
        rel_humidity=torch.full_like(t, 70.0), wind_speed=torch.full_like(t, 2.0),
        transmissivity=torch.full_like(t, 0.6))


def hydrall_card_vs_cpu(seed: int, card: str, dev="cuda") -> dict:
    """phase 3n: run_period over Dec 31 and Jan 1 (the month-end RothC step,
    the Jan-1 annual step) of a dry winter (:func:`dry_day_forcing`) on a
    16 box under SolverParameters(), card against CPU."""
    import datetime
    import torch
    from criteria3d_tpu_torch import SolverParameters
    from criteria3d_tpu_torch.problems import small_hydrall_model
    first = datetime.date(2023, 12, 31)
    runs = {}
    for d in (dev, "cpu"):
        m = small_hydrall_model(SolverParameters(), d, n=16, seed=seed)
        stats = []
        inner = m.run_hour

        def run_hour(*a, inner=inner, stats=stats):
            out = inner(*a)
            stats.append(out["solver_stats"])
            return out

        m.run_hour = run_hour
        t0 = time.time()
        log = m.run_period(first, 2, lambda day, h, g=m.grid: dry_day_forcing(g, day, h))
        _sync(d)
        runs[d] = (m, log, stats, time.time() - t0)
    (mc, lc, sc, wc), (mp, lp, sp, wp) = runs[dev], runs["cpu"]
    check(sc == sp, f"3n: the hours' stats differ (card {sc}, CPU {sp})")
    d_mbr = max(abs(a["mbr"] - b["mbr"]) for a, b in zip(lc, lp))
    dh = float((mc.water.h.cpu() - mp.water.h).abs().max())
    rels = {f"rothc.{n}": rel_err(t, getattr(mp.rothc, n)) for n, t in tensors_of(mc.rothc)}
    rels.update({f"hydrall.{n}": rel_err(t, dict(tensors_of(mp.hydrall))[n])
                 for n, t in tensors_of(mc.hydrall)})
    rels["litter"] = rel_err(mc._rothc_litter, mp._rothc_litter)
    rels["lai"] = rel_err(mc.lai, mp.lai)
    worst = max(rels.values())
    print(f"# hydrall period Dec 31 - Jan 1, 16 box ({card}): card {wc} s, CPU {wp} s; "
          f"{len(sc)} hours, {sum(s[0] for s in sc)} steps; daily MBRs card "
          f"{[e['mbr'] for e in lc]}; max |dMBR| {d_mbr} (1e-8); max |dh| {dh} m (1e-6); "
          f"RothC, HYDRALL, litter, LAI max rel {worst} ({max(rels, key=rels.get)}; 1e-9)",
          flush=True)
    check(d_mbr < 1e-8, f"3n: daily MBRs differ by {d_mbr}")
    check(dh < 1e-6, f"3n: heads differ by {dh} m")
    check(worst <= 1e-9, f"3n: side-model maps differ by rel {worst}")
    check(isinstance(mc._rothc_litter, torch.Tensor), "3n: no Jan-1 litter")
    return dict(walls=(wc, wp), d_mbr=d_mbr, dh=dh, rel=worst, steps=sum(s[0] for s in sc))


def vine_full_size(seed: int, card: str, tmp: str, dev="cuda", n: int = 768) -> dict:
    """phase 3o: the VINE3D project at n = 768 under initialize(fast=True)
    with the seeded mid-season canopy: hours 11-13 and 22-23 (irrigation
    booked for the day), the daily update, one more hour profiled; one
    hour's canopy fluxes on a window held against the CPU."""
    import contextlib
    import dataclasses
    import datetime
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.physics import vine_photosynthesis as VP
    from criteria3d_tpu_torch.problems import (VINE_DATE, VINE_IRRIGATION_HOURS,
                                               seed_vine_canopy, write_vine_project)
    from criteria3d_tpu_torch.project import INTERPOLATION_RANGE
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    from criteria3d_tpu_torch.vine3d import DISEASES_RANGE
    from criteria3d_tpu_torch.vine3d_project import Vine3DProject
    t0 = time.time()
    ini = write_vine_project(os.path.join(tmp, "v768"), n=n, seed=seed, n_stations=20)
    write_s = time.time() - t0
    t0 = time.time()
    prj = Vine3DProject.load(ini, output_dir=os.path.join(tmp, "vout768"))
    load_s = time.time() - t0
    _peak_gib(dev, reset=True)
    t0 = time.time()
    prj.initialize(fast=True, device=dev)
    _sync(dev)
    init_s = time.time() - t0
    model = prj.model
    check(model.water.h.device.type == torch_device_type(dev)
          and prj.base.params.inner_solver == "cg",
          "3o: the vine project did not build on the card under fast=True")
    seed_vine_canopy(model)
    date = datetime.date(*VINE_DATE)
    model.apply_field_book(date)
    n_vine = int(model.vineyard_mask.sum())
    print(f"# vine project 768 ({card}): wrote {write_s:.1f} s, loaded {load_s:.1f} s, "
          f"initialized {init_s:.1f} s; {prj.base.grid.n_nodes} nodes, {n_vine} vineyard "
          f"cells, irrigation {model._irrigation_hours} h at {model.max_irrigation_rate} mm/h",
          flush=True)
    captured = []
    orig = recording(VP, "vine_canopy_fluxes", captured)
    runs = []
    try:
        for hour in VINE_HOURS:
            when = datetime.datetime(*VINE_DATE, hour)
            _sync(dev)
            JB.jacobi_bundle.launches = 0
            host_read.count = 0
            VP.photosynthesis_kernel_simplified.iterations = 0
            device_loop.reset_counts()
            t0 = time.time()
            out = model.run_hour(prj.hourly_forcing(when), *VINE_DATE, hour)
            _sync(dev)
            wall = time.time() - t0
            syncs, launches = host_read.count, JB.jacobi_bundle.launches
            iters = VP.photosynthesis_kernel_simplified.iterations
            fixed = device_loop.counts()["graph_fixed_points"]
            irrigated = int((out["irrigation"] > 0).sum())
            demand = float(out["vine_transpiration_demand"][model.vineyard_mask].mean())
            # the mass gate against the hour's gross exchange: in an irrigated
            # hour the net sink (irrigation in, transpiration out) can nearly
            # cancel, and the whole-period MBR divides by it
            bw = model.water.balance_whole
            irr_m3 = float(out["irrigation"].sum()) / 1000.0 * float(model.grid.area)
            gross = max(abs(float(bw.sink_source)), irr_m3, 0.001)
            mass = abs(float(bw.mbe)) / gross
            print(f"# vine project 768 hour {hour} ({card}): wall {wall} s, host reads "
                  f"{syncs}, stats {out['solver_stats']}, MBR {out['mbr']} (mass error "
                  f"{float(bw.mbe)} m3 over a gross exchange of {gross} m3: {mass}), "
                  f"fixed-point iterations {iters} (4 calls, {fixed} graph-driven), "
                  f"irrigated cells {irrigated}, "
                  f"vineyard transpiration demand {demand} mm, bundle launches {launches}",
                  flush=True)
            for name, t in [(k, v) for k, v in out.items() if isinstance(v, torch.Tensor)]:
                check(t.device.type == torch_device_type(dev),
                      f"3o hour {hour}: {name} is on {t.device}")
            check(mass < 2e-3, f"3o hour {hour}: mass error {mass} of the gross exchange")
            check(launches == 0, f"3o hour {hour}: {launches} bundle launches")
            check(bool(torch.isfinite(out["vine_transpiration_demand"]).all()),
                  f"3o hour {hour}: non-finite transpiration")
            check(irrigated == (int((torch.as_tensor(model.field_map) == 1).sum())
                                if hour >= 24 - VINE_IRRIGATION_HOURS else 0),
                  f"3o hour {hour}: {irrigated} irrigated cells")
            if torch_device_type(dev) == "cuda":
                check(fixed == 4, f"3o hour {hour}: {fixed} of 4 fixed points graph-driven")
            runs.append(dict(wall_s=wall, syncs=syncs, iterations=iters, mbr=out["mbr"],
                             mass=mass, stats=out["solver_stats"], irrigated=irrigated,
                             launches=launches, fixed_points=fixed))
    finally:
        VP.vine_canopy_fluxes = orig
    t0 = time.time()
    day = model.daily_update(date)
    _sync(dev)
    day_s = time.time() - t0
    check(bool(torch.isfinite(day["lai"]).all()) and bool(torch.isfinite(day["stage"]).all()),
          "3o: the daily update is not finite")
    peak = _peak_gib(dev)
    walls = [r["wall_s"] for r in runs]
    when = datetime.datetime(*VINE_DATE, 14)
    # hour 14 from the same state under each driver: graph-driven, then
    # eager-driven and profiled (the profiler sees the units' ranges,
    # c3d.vine's among them, only off a graph): each one's peak memory, wall
    # and host reads, the graph-driven peak at most 2 x the eager one
    ranges = layer_ranges() + (VP.VINE_RANGE, DISEASES_RANGE, INTERPOLATION_RANGE)
    hour14 = {}
    for driver in ("graph", "eager"):
        twin = dataclasses.replace(model)
        device_loop.clear()
        if torch_device_type(dev) == "cuda":
            torch.cuda.empty_cache()
        _sync(dev)
        _peak_gib(dev, reset=True)
        host_read.count = 0
        t0 = time.time()
        if driver == "graph":
            twin.run_hour(prj.hourly_forcing(when), *VINE_DATE, 14)
        else:
            busy, _, layers = _profiled(
                "vine hour 14 (eager-driven)", lambda: twin.run_hour(
                    prj.hourly_forcing(when), *VINE_DATE, 14),
                hour14["graph"]["wall_s"], ranges, dev, eager=True)
        _sync(dev)
        hour14[driver] = dict(wall_s=time.time() - t0, reads=host_read.count,
                              peak_gib=_peak_gib(dev))
        del twin
    print(f"# vine project 768 hour 14 ({card}): graph-driven {hour14['graph']}, "
          f"eager-driven and profiled {hour14['eager']}", flush=True)
    if torch_device_type(dev) == "cuda":
        check(hour14["graph"]["peak_gib"] <= 2.0 * hour14["eager"]["peak_gib"],
              f"3o: the graph-driven hour's peak {hour14['graph']['peak_gib']} GiB is above "
              f"2 x the eager hour's {hour14['eager']['peak_gib']}")
    vine_s, dis_s = layers.get(VP.VINE_RANGE, 0.0), layers.get(DISEASES_RANGE, 0.0)
    check(busy > 0.0 and vine_s > 0.0 and dis_s > 0.0,
          f"3o: no device time in {VP.VINE_RANGE} ({vine_s}) or {DISEASES_RANGE} ({dis_s})")
    print(f"# vine hour 14 ({card}): device busy {busy} s; {VP.VINE_RANGE} {vine_s} s "
          f"({vine_s / busy}), {DISEASES_RANGE} {dis_s} s ({dis_s / busy}); daily update "
          f"{day_s} s; peak memory {peak:.2f} GiB; device time by layer "
          + "; ".join(f"{k} {layers.get(k, 0.0)} s" for k in ranges + ("other",)), flush=True)

    # hour 12's canopy fluxes on a window of its own inputs, card against CPU
    _, kw = captured[1]
    rows, cols = VINE_WINDOW if n == 768 else (slice(0, n), slice(0, n))

    def window(v, d):
        if isinstance(v, torch.Tensor):
            if v.dim() >= 2 and v.shape[-2:] == model.grid.shape[1:]:
                v = v[..., rows, cols]
            return v.to(d)
        return v

    results = {}
    for d in (dev, "cpu"):
        stops = []
        orig_k = recording(VP, "photosynthesis_kernel_simplified", stops, stops=True)
        try:
            results[d] = (VP.vine_canopy_fluxes(**{k: window(v, d) for k, v in kw.items()}),
                          stops)
        finally:
            VP.photosynthesis_kernel_simplified = orig_k
    (oc, sc), (op, sp) = results[dev], results["cpu"]
    flips, cells = stop_flips(sc, sp)
    keys = ("assimilation", "transpiration_layer", "total_stomatal_conductance",
            "transpiration_nostress", "absorbed_par", "vpd_pa")
    rels = {k: rel_err(oc[k], op[k]) for k in keys}
    # the stress coefficient is a 0-1 fraction formed as 1 - Gs / Gs0, near
    # 0 where the layers are wet: held absolutely, against 1
    rels["stress_coefficient"] = float(
        (oc["stress_coefficient"].cpu() - op["stress_coefficient"]).abs().max())
    worst = max(rels.values())
    never = sum(int((s["stop"] < 0).sum()) for s in sc)
    print(f"# vine canopy fluxes card vs CPU, hour 12 on a {rows.stop - rows.start} x "
          f"{cols.stop - cols.start} window ({card}): stop flips {flips} of {cells} cells "
          f"({never} never stop in {len(sc)} calls); max rel {worst} "
          f"({max(rels, key=rels.get)}; tolerance 1e-12)", flush=True)
    if flips == 0:
        check(worst <= 1e-12, f"3o: canopy fluxes card vs CPU rel {worst}")
    # hour 12's canopy fluxes over the whole box, graph- against eager-driven
    kw_full = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    drivers = fixed_point_drivers("3o vine canopy fluxes on hour 12's inputs",
                                  lambda: VP.vine_canopy_fluxes(**kw_full), VP,
                                  "photosynthesis_kernel_simplified", dev)
    return dict(walls=walls, syncs=[r["syncs"] for r in runs],
                iterations=[r["iterations"] for r in runs],
                stats=[r["stats"] for r in runs], mbrs=[r["mbr"] for r in runs],
                mass=[r["mass"] for r in runs], irrigated=[r["irrigated"] for r in runs],
                launches=sum(r["launches"] for r in runs), peak_gib=peak, busy_s=busy,
                vine_s=vine_s, diseases_s=dis_s, flips=flips, rel=worst,
                setup_s=(write_s, load_s, init_s), n_vine=n_vine, hour14=hour14,
                drivers=drivers, fixed_points=[r["fixed_points"] for r in runs])


def vine_day_card_vs_cpu(seed: int, card: str, tmp: str, dev="cuda") -> dict:
    """phase 3p: a VINE3D project's day through ``run_day`` on a
    VINE_3P_BOX box under its float64 parameters on the card and on the
    CPU."""
    import datetime
    import numpy as np
    import torch
    from criteria3d_tpu_torch.problems import VINE_DATE, seed_vine_canopy, write_vine_project
    from criteria3d_tpu_torch.vine3d_project import Vine3DProject
    n = VINE_3P_BOX
    ini = write_vine_project(os.path.join(tmp, f"v{n}"), n=n, seed=seed)
    date = datetime.date(*VINE_DATE)
    runs = {}
    for d in (dev, "cpu"):
        prj = Vine3DProject.load(ini, output_dir=os.path.join(tmp, f"vout{n}_{d}"))
        prj.initialize(device=d)
        seed_vine_canopy(prj.model)
        hours = []
        inner = prj.model.run_hour

        def run_hour(*a, inner=inner, hours=hours):
            out = inner(*a)
            hours.append((out["solver_stats"], out["mbr"], out["downy_mildew_infection"].cpu(),
                          out["irrigation"].cpu()))
            return out

        prj.model.run_hour = run_hour
        t0 = time.time()
        day = prj.run_day(date)
        _sync(d)
        runs[d] = (prj, day, hours, time.time() - t0)
    (pc, dc, hc, wc), (pp, dp, hp, wp) = runs[dev], runs["cpu"]
    check(pc.base.params.sweep_dtype is None
          and pc.model.water.h.device.type == torch_device_type(dev),
          "3p: the day is not the float64 path on the card")
    check([h[0] for h in hc] == [h[0] for h in hp],
          f"3p: the hours' stats differ (card {[h[0] for h in hc]}, CPU {[h[0] for h in hp]})")
    d_mbr = max(abs(a[1] - b[1]) for a, b in zip(hc, hp))
    flags = all(torch.equal(a[2], b[2]) and torch.equal(a[3], b[3]) for a, b in zip(hc, hp))
    dh = float((pc.model.water.h.cpu() - pp.model.water.h).abs().max())
    rels = {k: rel_err(dc[k], dp[k]) for k in ("tavg", "stage", "lai", "fruit_biomass")}
    rels.update({f"vine.{n}": rel_err(t, getattr(pp.model.vine, n))
                 for n, t in tensors_of(pc.model.vine)})
    worst = max(rels.values())
    risk = float((dc["powdery_infection_risk"].cpu() - dp["powdery_infection_risk"]).abs().max())
    downy_eq = torch.equal(pc.model.downy.stage.cpu(), pp.model.downy.stage) and torch.equal(
        pc.model.downy.is_germination.cpu(), pp.model.downy.is_germination)
    print(f"# vine project day {n} box ({card}): card {wc} s, CPU {wp} s; "
          f"{pc.base.grid.n_nodes} nodes; stats card {[h[0] for h in hc]}; max |dMBR| "
          f"{d_mbr} (1e-8); max |dh| {dh} m (1e-6); vine maps max rel {worst} "
          f"({max(rels, key=rels.get)}; 1e-9); powdery risk max |d| {risk} (4 float32 ulp "
          f"of the pool, {4 * 2.0 ** -23}); infection flags, irrigation, downy stages "
          f"equal {flags and downy_eq}; irrigated cells {int((dc['irrigation_mm'] > 0).sum())}",
          flush=True)
    check(d_mbr < 1e-8, f"3p: hourly MBRs differ by {d_mbr}")
    check(dh < 1e-6, f"3p: heads differ by {dh} m")
    check(worst <= 1e-9, f"3p: vine maps differ by rel {worst}")
    check(risk <= 4 * 2.0 ** -23, f"3p: powdery risk differs by {risk}")
    check(flags and downy_eq, "3p: disease flags, stages or irrigation differ")
    check(np.isfinite(dc["mbr"]), "3p: no daily MBR")
    return dict(walls=(wc, wp), d_mbr=d_mbr, dh=dh, rel=worst, risk=risk)


def side_phases(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """Phases 3m-3p (HYDRALL and RothC in the model cycle, the VINE3D
    project); returns what they measured. ``dev="cpu"`` with a small ``n``
    rehearses them on the CPU (no device time, no peak memory)."""
    import torch
    from criteria3d_tpu_torch.problems import synthetic_catchment
    t0 = time.time()
    full_m = hydrall_full_size(synthetic_catchment(seed, n=n, radius=n * 366.0 / 768),
                               seed, card, dev)
    if torch_device_type(dev) == "cuda":
        torch.cuda.empty_cache()
    small_m = hydrall_card_vs_cpu(seed, card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        full_v = vine_full_size(seed, card, tmp, dev, n)
        if torch_device_type(dev) == "cuda":
            torch.cuda.empty_cache()
        small_v = vine_day_card_vs_cpu(seed, card, tmp, dev)
    seconds = time.time() - t0
    print(f"# phases 3m-3p took {seconds} s ({card})", flush=True)
    return dict(hydrall=full_m, hydrall_small=small_m, vine=full_v, vine_small=small_v,
                seconds=seconds)


# ----------------------------------------------------------------------
# the command shell and what it drives (3q), the meteo grid as the weather
# source (3r), and both on a small box on the card against the CPU (3s)
# ----------------------------------------------------------------------

# 3q: the batch script the shell runs: ``{fast}`` is "FAST ON\n" at full
# size and empty for the float64 card-against-CPU run (3s), whose RUN starts
# at 10 h, not 06 h: from 06 h the two devices' float64 snow packs part at
# the 0-internal-energy branch (PERF.md section 2 (4): SWE 0.25 mm apart
# after 08 h on the card and the CPU), and ANIM's 15 degC melt then moves
# the heads 5e-3 m apart; from 10 h the 32 box has no snow. At full size
# the script also runs from 10 h since the library phases joined the run
# (SHELL_3Q_START; 06 h until then, when an ANIM hour at 15 degC on the
# morning's snow pack took 1,500-2,946 steps, 36-83 s on an H100; 3k runs
# hours 6-7 of the same project), and ANIM one hour (two until then)
SHELL_3Q_START = 10
SHELL_SCRIPT = """PROJ {ini}
{fast}INITIALIZE
RUN 3 2023-03-21T{start:02d}
INFO
EXPORTPNG swc out/swc.png
EXPORTPNG dem out/dem.png
MAP out/map.png swc
VIEW3D out/v3d.png dem
CHART S00 out/chart.png
PROXY out/proxy.png
HOURLYCSV S00 out/s00.csv
STATE SAVE st
STATE LOAD st
ANIM out/anim.png 1 pond
REPORT out/run.html
"""
# the files the script writes under its working directory; the images of
# the model's state (rendered from root-zone theta and ponding)
SHELL_FILES = ("out/swc.png", "out/dem.png", "out/map.png", "out/v3d.png",
               "out/chart.png", "out/proxy.png", "out/s00.csv", "out/anim.png",
               "out/run.html", "st/WP_0.flt")
SHELL_STATE_IMAGES = ("out/swc.png", "out/map.png", "out/anim.png")
# 3r: the grid's cells and margin [m] at full size and at the small box
GRID_FULL = dict(cell=500.0, margin=1000.0)
GRID_SMALL = dict(cell=32.0, margin=32.0)
# 3r: the grid hours (first hour, hours; one more hour profiled and exported)
GRID_HOURS = (10, 2)
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_pixels(blob: bytes):
    """The (H, W, 4) uint8 pixels of an RGBA PNG as the port's writers
    write it (8-bit, filter 0 rows)."""
    import struct
    import zlib
    import numpy as np
    check(blob[:8] == PNG_SIGNATURE, "not a PNG file")
    pos, idat = 8, b""
    while pos < len(blob):
        (length,), tag = struct.unpack(">I", blob[pos:pos + 4]), blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", payload[:8])
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    return raw[:, 1:].reshape(h, w, 4)


def pixel_share(a: bytes, b: bytes) -> float:
    """The share of decoded pixels that differ between two PNG files."""
    x, y = png_pixels(a), png_pixels(b)
    check(x.shape == y.shape, f"PNG shapes differ: {x.shape} {y.shape}")
    return float((x != y).any(-1).mean())


def run_batch(root: str, script: str, dev) -> dict:
    """``criteria3d_tpu_torch.cli.main`` on ``script`` in-process, with
    ``root`` as the working directory (``--device cpu`` when ``dev`` is the
    CPU). Returns the printed lines, each command's (name, wall, host
    reads), each model hour's wall, host reads, stats, MBR and forcing
    maps (copied to the host), and the shell."""
    import contextlib
    import io
    from criteria3d_tpu_torch import cli
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.model import Criteria3DModel
    with open(os.path.join(root, "batch.txt"), "w") as f:
        f.write(script)
    commands, hours, shells = [], [], []
    execute0, run_hour0 = cli.Shell.execute, Criteria3DModel.run_hour

    def execute(self, line):
        shells[:] = [self]
        _sync(dev)
        t0, r0 = time.time(), host_read.count
        out = execute0(self, line)
        _sync(dev)
        commands.append((line.split()[0] if line.split() else "", time.time() - t0,
                         host_read.count - r0))
        return out

    def run_hour(self, forcing, *a):
        _sync(dev)
        t0, r0 = time.time(), host_read.count
        out = run_hour0(self, forcing, *a)
        _sync(dev)
        hours.append(dict(wall_s=time.time() - t0, syncs=host_read.count - r0,
                          stats=out.get("solver_stats"), mbr=out["mbr"],
                          forcing={k: getattr(forcing, k).cpu() for k in
                                   ("air_temperature", "precipitation",
                                    "rel_humidity", "wind_speed")}))
        return out

    argv = ["batch.txt"] if torch_device_type(dev) == "cuda" else ["--device", "cpu",
                                                                  "batch.txt"]
    said, cwd = io.StringIO(), os.getcwd()
    cli.Shell.execute, Criteria3DModel.run_hour = execute, run_hour
    try:
        os.chdir(root)
        with contextlib.redirect_stdout(said):
            rc = cli.main(argv)
    finally:
        cli.Shell.execute, Criteria3DModel.run_hour = execute0, run_hour0
        os.chdir(cwd)
    lines = said.getvalue().replace(root, "<root>").splitlines()
    errors = [x for x in lines if x.startswith("ERROR:")]
    check(rc == 0 and not errors, f"the shell printed {errors} (exit code {rc})")
    for rec in hours:
        rec["mbr"] = float(rec["mbr"])
    return dict(lines=lines, commands=commands, hours=hours, shell=shells[0])


def shell_files(root: str) -> dict:
    """The script's files (SHELL_FILES) by name; each must exist, each PNG
    must carry the PNG signature."""
    out = {}
    for name in SHELL_FILES:
        path = os.path.join(root, name)
        check(os.path.isfile(path), f"the shell did not write {name}")
        with open(path, "rb") as f:
            out[name] = f.read()
        if name.endswith(".png"):
            check(out[name][:8] == PNG_SIGNATURE, f"{name} is not a PNG file")
    check(b"data:image/png;base64," in out["out/run.html"], "the report has no image")
    return out


def shell_full_size(seed: int, card: str, tmp: str, dev="cuda", n: int = 768) -> dict:
    """phase 3q: the command shell at full width: write_project (3k's
    project) with its DEM as a GeoTIFF, then the batch script through
    cli.main in-process, then ``python -m criteria3d_tpu_torch.cli`` once in
    a subprocess."""
    import numpy as np
    import torch
    from criteria3d_tpu_torch.problems import dem_as_geotiff, write_project
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    t0 = time.time()
    ini = write_project(os.path.join(tmp, f"p{n}"), n=n, seed=seed, n_stations=20)
    tif = dem_as_geotiff(ini)
    write_s = time.time() - t0
    root = os.path.join(tmp, "shell")
    os.makedirs(root)
    peak0 = _peak_gib(dev, reset=True)
    JB.jacobi_bundle.launches = 0
    t0 = time.time()
    run = run_batch(root, SHELL_SCRIPT.format(ini=ini, fast="FAST ON\n", start=SHELL_3Q_START),
                    dev)
    script_s = time.time() - t0
    launches = JB.jacobi_bundle.launches
    peak = _peak_gib(dev)
    sh = run["shell"]
    prj = sh.project
    check(prj.params.inner_solver == "cg" and prj.params.cg_precond == "line",
          f"3q: FAST ON gave {prj.params}")
    for name, t in list(model_tensors(sh.model)) + list(tensors_of(sh.grid)):
        check(t.device.type == torch_device_type(dev), f"3q: {name} is on {t.device}")
    for line in run["lines"]:
        print(f"#   3q> {line}")
    for (cmd, wall, reads) in run["commands"]:
        print(f"# shell {n} command {cmd} ({card}): wall {wall} s, host reads {reads}",
              flush=True)
    for i, rec in enumerate(run["hours"]):
        kind = "RUN" if i < 3 else "ANIM"
        print(f"# shell {n} {kind} hour {i} ({card}): wall {rec['wall_s']} s, host reads "
              f"{rec['syncs']}, stats {rec['stats']}, MBR {rec['mbr']}", flush=True)
        check(abs(rec["mbr"]) < 2e-3, f"3q hour {i}: |MBR| {rec['mbr']} >= 2e-3")
    check(len(run["hours"]) == 4, f"3q: {len(run['hours'])} model hours, expected 4")
    check(launches == 0, f"3q: the shell's hours launched {launches} jacobi_bundle kernels")
    files = shell_files(root)
    w = prj._raster_writer
    n_vars = sum(len(d) for d in prj.output_variables().values())
    rasters = sorted(f for f in os.listdir(os.path.join(root, "OUTPUT", "rasters", "20230321"))
                     if f.endswith(".flt"))
    check(w is not None and w.written == 3 * n_vars == len(rasters) and w.errors == 0,
          f"3q: the writer pool wrote {w and w.written} rasters with {w and w.errors} "
          f"errors; {len(rasters)} files, {3 * n_vars} staged")
    print(f"# shell {n} ({card}): project written with a GeoTIFF DEM in {write_s:.1f} s; "
          f"script {script_s} s; writer pool written {w.written} errors {w.errors}; "
          f"peak memory {peak:.2f} GiB (from {peak0:.2f}); bundle launches {launches}; "
          f"files {', '.join(f'{k} {len(v)} B' for k, v in files.items())}", flush=True)

    # the module entry point itself, in a fresh interpreter
    with open(os.path.join(root, "entry.txt"), "w") as f:
        f.write(f"VERSION\nDEM {tif}\nINFO\n")
    argv = [] if torch_device_type(dev) == "cuda" else ["--device", "cpu"]
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "criteria3d_tpu_torch.cli", *argv,
                           "entry.txt"], capture_output=True, text=True, cwd=root,
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(
                              os.path.abspath(__file__))), timeout=300)
    entry_s = time.time() - t0
    out = proc.stdout.splitlines()
    check(proc.returncode == 0 and not [x for x in out if x.startswith("ERROR:")]
          and "criteria3d-tpu> INFO" in out and f"DEM: ({n}, {n}), cell 4.0 m, "
          f"{int((prj.dem != -9999.0).sum())} valid cells" in out,
          f"3q: python -m criteria3d_tpu_torch.cli gave {proc.returncode}: "
          f"{proc.stdout[-600:]} {proc.stderr[-600:]}")
    print(f"# shell {n} ({card}): python -m criteria3d_tpu_torch.cli took {entry_s} s: "
          + " | ".join(out), flush=True)
    result = dict(script_s=script_s, commands=run["commands"],
                  hours=[r["wall_s"] for r in run["hours"]],
                  syncs=[r["syncs"] for r in run["hours"]],
                  stats=[r["stats"] for r in run["hours"]],
                  mbrs=[r["mbr"] for r in run["hours"]], launches=launches,
                  written=w.written, errors=w.errors, peak_gib=peak, entry_s=entry_s)
    del run, sh, prj
    return ini, result


def grid_hours(ini: str, out_dir: str, dev, fast: bool, grid: dict, seed: int,
               records: list):
    """A project loaded with a meteo grid (problems.write_meteo_grid) as its
    weather, initialised on ``dev``, then run_period over GRID_HOURS with
    outputs; each hour's record (wall, reads, stats, MBR, forcing maps on
    the host) goes to ``records``. Returns the project and its log."""
    import datetime
    from criteria3d_tpu_torch.problems import PROJECT_DATE, write_meteo_grid
    from criteria3d_tpu_torch.project import Criteria3DProject
    xml, db = write_meteo_grid(os.path.dirname(ini), ini, seed=seed, **grid)
    prj = Criteria3DProject.load(ini, output_dir=out_dir)
    t0 = time.time()
    prj.load_meteo_grid(xml, db, as_forcing=True)
    load_s = time.time() - t0
    prj.initialize(fast=fast, device=dev)
    first, n_hours = GRID_HOURS
    instrument_run_hour(prj, records, keep_forcing=True, dev=dev)
    log = prj.run_period(datetime.datetime(*PROJECT_DATE, first), n_hours)
    return prj, log, load_s


def grid_full_size(ini: str, seed: int, card: str, tmp: str, dev="cuda") -> dict:
    """phase 3r: the meteo grid at full width: a 10 x 10 UTM grid of 500 m
    cells over 3k's box and a 1 km margin as the weather of the 768 box
    project (fast), two hours with outputs, one more profiled, and that
    hour's temperature map exported into the grid's tables."""
    import datetime
    import numpy as np
    import torch
    from criteria3d_tpu_torch.outputs import OUTPUTS_RANGE
    from criteria3d_tpu_torch.project import INTERPOLATION_RANGE
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    records = []
    _peak_gib(dev, reset=True)
    JB.jacobi_bundle.launches = 0
    prj, log, load_s = grid_hours(ini, os.path.join(tmp, "grid_out"), dev, True,
                                  GRID_FULL, seed, records)
    launches = JB.jacobi_bundle.launches
    peak = _peak_gib(dev)
    n = prj.dem.shape[0]
    cells = int((n * prj.header.cellsize + 2 * GRID_FULL["margin"]) // GRID_FULL["cell"]) ** 2
    check(len(prj.stations) == len(prj.meteo_grid_cells) == cells
          and (n != 768 or cells == 100),
          f"3r: {len(prj.stations)} stations from the grid, expected {cells}")
    valid = prj.grid.mask[0].cpu()
    for rec, e in zip(records, log):
        fin = all(bool(torch.isfinite(v[valid]).all()) for v in rec["forcing"].values())
        print(f"# grid {n} hour {rec['when'].hour} ({card}): wall "
              f"{rec['wall_s']} s, host reads {rec['syncs']}, stats {rec['stats']}, MBR "
              f"{e['mbr']}, T {float(rec['forcing']['air_temperature'][valid].min())}.."
              f"{float(rec['forcing']['air_temperature'][valid].max())} degC", flush=True)
        check(fin, f"3r hour {rec['when'].hour}: forcing not finite on the catchment")
        check(abs(e["mbr"]) < 2e-3, f"3r hour {rec['when'].hour}: |MBR| {e['mbr']}")
    check(launches == 0, f"3r: the grid hours launched {launches} jacobi_bundle kernels")

    when = records[-1]["when"] + datetime.timedelta(hours=1)
    outs = []
    ranges = layer_ranges() + (INTERPOLATION_RANGE, OUTPUTS_RANGE)
    busy, _, layers = _profiled(
        f"grid hour {when.hour}", lambda: (outs.append(prj.run_hour(when)),
                                           prj.flush_outputs()),
        statistics.median([r["wall_s"] for r in records]), ranges, dev)
    interp_s = layers.get(INTERPOLATION_RANGE, 0.0)
    t_map = torch.where(prj.grid.mask[0], outs[0]["forcing"].air_temperature, -9999.0)
    t0 = time.time()
    agg = prj.export_hourly_to_grid(101, t_map, when)
    export_s = time.time() - t0
    back = prj.meteo_grid.read_hourly_map(prj.meteo_grid.cell_codes_2d(), 101, when)
    ok = agg != -9999.0
    d_back = float(np.abs(back[ok] - agg[ok]).max())
    print(f"# grid hour {when.hour} ({card}): {cells} stations; c3d.interpolation "
          f"{interp_s} s of device time ({interp_s / busy} of busy {busy} s); exported "
          f"{int(ok.sum())} cells in {export_s} s, read back within {d_back} (1e-6); "
          f"peak memory {peak:.2f} GiB; load_meteo_grid {load_s} s", flush=True)
    check(ok.sum() > 0 and d_back <= 1e-6, f"3r: the exported map reads back {d_back} apart")
    hours = records[:len(log)]
    result = dict(walls=[r["wall_s"] for r in hours], syncs=[r["syncs"] for r in hours],
                  stats=[r["stats"] for r in hours], mbrs=[e["mbr"] for e in log],
                  interpolation_s=interp_s, busy_s=busy, d_back=d_back, export_s=export_s,
                  launches=launches, peak_gib=peak, load_s=load_s,
                  writer=(prj._raster_writer.written, prj._raster_writer.errors))
    check(result["writer"][1] == 0, f"3r: the writer pool had {result['writer'][1]} errors")
    return result


def shell_card_vs_cpu(seed: int, card: str, tmp: str, dev="cuda") -> dict:
    """phase 3s: a 32 box: the batch script (no FAST: the float64
    parameters) and two meteo-grid hours, on the card and on the CPU."""
    import numpy as np
    from criteria3d_tpu_torch.problems import write_project
    ini = write_project(os.path.join(tmp, "s32"), n=32, seed=seed, n_stations=6)
    runs = {}
    for d in (dev, "cpu"):
        root = os.path.join(tmp, f"shell32_{torch_device_type(d)}_{len(runs)}")
        os.makedirs(root)
        t0 = time.time()
        run = run_batch(root, SHELL_SCRIPT.format(ini=ini, fast="", start=10), d)
        run["wall_s"] = time.time() - t0
        run["files"] = shell_files(root)
        records = []
        t0 = time.time()
        prj, log, _ = grid_hours(ini, os.path.join(root, "grid_out"), d, False,
                                 GRID_SMALL, seed, records)
        run["grid"] = (prj, records, log, time.time() - t0)
        runs[len(runs)] = run
    c, p = runs[0], runs[1]
    check(c["shell"].params.sweep_dtype is None, "3s: the shell is not on the float64 path")
    check([r["stats"] for r in c["hours"]] == [r["stats"] for r in p["hours"]],
          f"3s: shell hours' stats differ: {[r['stats'] for r in c['hours']]} "
          f"{[r['stats'] for r in p['hours']]}")
    dh = float((c["shell"].model.water.h.cpu() - p["shell"].model.water.h).abs().max())
    f_rel = 0.0
    for a, b in zip(c["hours"] + c["grid"][1], p["hours"] + p["grid"][1]):
        for k, v in b["forcing"].items():
            f_rel = max(f_rel, rel_err(a["forcing"][k], v))
    gc, gp = c["grid"], p["grid"]
    check([r["stats"] for r in gc[1]] == [r["stats"] for r in gp[1]],
          f"3s: grid hours' stats differ: {[r['stats'] for r in gc[1]]} "
          f"{[r['stats'] for r in gp[1]]}")
    dh_g = float((gc[0].model.water.h.cpu() - gp[0].model.water.h).abs().max())
    shares, same, report_diff = {}, [], ""
    for name, a in c["files"].items():
        b = p["files"][name]
        if name.endswith(".html"):
            import base64
            import re
            parts = []
            for html in (a.decode(), b.decode()):
                imgs = [base64.b64decode(m) for m in
                        re.findall(r'src="data:image/png;base64,([^"]*)"', html)]
                text = re.sub(r'src="data:image/png;base64,[^"]*"', "", html)
                parts.append((re.sub(r"<footer>[^<]*</footer>", "", text), imgs))
            if parts[0][0] != parts[1][0]:
                i = next(k for k, (x, y) in enumerate(zip(*(q[0] for q in parts)))
                         if x != y)
                report_diff = (f"card ...{parts[0][0][i - 80:i + 80]}... CPU "
                               f"...{parts[1][0][i - 80:i + 80]}...")
            for k, (x, y) in enumerate(zip(parts[0][1], parts[1][1])):
                shares[f"{name}[{k}]"] = 0.0 if x == y else pixel_share(x, y)
        elif name in SHELL_STATE_IMAGES:
            shares[name] = 0.0 if a == b else pixel_share(a, b)
        elif name.endswith((".png", ".csv")):
            check(a == b, f"3s: {name} differs between the card and the CPU")
            same.append(name)
    worst = max(shares.values())
    lines_differ = [(x, y) for x, y in zip(c["lines"], p["lines"]) if x != y]
    print(f"# shell 32 box ({card}): script card {c['wall_s']} s, CPU {p['wall_s']} s; "
          f"stats card {[r['stats'] for r in c['hours']]}; max |dh| {dh} m (1e-6); grid "
          f"hours card {gc[3]} s, CPU {gp[3]} s, stats {[r['stats'] for r in gc[1]]}, "
          f"max |dh| {dh_g} m (1e-6); forcing maps rel {f_rel} (1e-12); byte-equal "
          f"{same}; state images differing pixel shares {shares} (0.001); printed "
          f"lines differing (card, CPU) {lines_differ} of {len(c['lines'])}", flush=True)
    check(not report_diff, f"3s: the reports' text differs: {report_diff}")
    check(dh < 1e-6 and dh_g < 1e-6, f"3s: heads differ by {dh} / {dh_g} m")
    check(f_rel <= 1e-12, f"3s: forcing maps differ by rel {f_rel}")
    check(worst <= 1e-3, f"3s: state images differ in {worst} of their pixels")
    check(len(c["lines"]) == len(p["lines"]), "3s: the shells printed different line counts")
    return dict(walls=(c["wall_s"], p["wall_s"]), walls_grid=(gc[3], gp[3]), dh=dh,
                dh_grid=dh_g, f_rel=f_rel, pixel_share=worst)


def shell_phases(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """Phases 3q-3s (the command shell, the meteo grid, both card against
    CPU); returns what they measured. ``dev="cpu"`` with a small ``n``
    rehearses them on the CPU (no device time, no peak memory)."""
    import torch
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ini, full_s = shell_full_size(seed, card, tmp, dev, n)
        if torch_device_type(dev) == "cuda":
            torch.cuda.empty_cache()
        full_g = grid_full_size(ini, seed, card, tmp, dev)
        if torch_device_type(dev) == "cuda":
            torch.cuda.empty_cache()
        small = shell_card_vs_cpu(seed, card, tmp, dev)
    seconds = time.time() - t0
    print(f"# phases 3q-3s took {seconds} s ({card})", flush=True)
    return dict(shell=full_s, grid=full_g, small=small, seconds=seconds)


# ----------------------------------------------------------------------
# the interpolation library on the card (3t) and the host library on
# full-size products (3u)
# ----------------------------------------------------------------------

# 3t: the stations are write_meteo_grid's cells over the box (3r's rule: a
# 10 x 10 grid of 500 m cells with a 1 km margin at full size; 32 m cells
# and margin on a small box) with the day's 07 h temperatures (a thermal
# inversion); the local map takes ceil(1.2 x 20) = 24 neighbours, 16 starts
# (2 a parameter) and 60 iterations; the elevation gate is 10 m (the
# valley's stations span about 300 m, under the default 100 m stddev gate)
LIB_GRID_FULL = dict(cell=500.0, margin=1000.0)
LIB_GRID_SMALL = dict(cell=32.0, margin=32.0)
LIB_OPTIONS = dict(min_points_local=20, n_lm_iterations=60, elevation_std_threshold=10.0)
# 3t: the glocal areas are the box's quadrants; their window [m] is a disc
# of 50 cells' radius at 4 m
LIB_GLOCAL_WINDOW = 200.0
# 3t: the side of the window run on the card and on the CPU [cells]
LIB_WINDOW = 48
# 3t: the largest cond(V) of the window's kriging system; 64 eps x cond(V)
# bounds the maps' gap, and above ~7e13 that bound passes any map (the
# fitted spherical model's cond is 1.2e3)
LIB_KRIGING_COND = 1e8
# 3t: the local map is profiled on a band of rows (128 at full size: 3
# chunks of cells)
LIB_PROFILED_ROWS = 128
# 3u: the outline's check raster has cells of 9 x the DEM's (odd: their
# centres are DEM cell centres)
LIB_OUTLINE_CELLS = 9


def library_inputs(seed: int, n: int) -> dict:
    """3t's inputs as numpy arrays: problems.library_stations on 3k's box
    (the DEM of write_project(n, seed)), the cell-centre coordinate maps,
    heights (the valley plane's off the catchment), the quadrant zones and
    each quadrant's stations."""
    import numpy as np
    from criteria3d_tpu_torch.problems import library_stations, valley_plane
    dem, hdr, sx, sy, sz, sv = library_stations(
        n, seed, **(LIB_GRID_FULL if n == 768 else LIB_GRID_SMALL))
    rows, cols = np.mgrid[0:n, 0:n].astype(np.float64)
    cs = hdr.cellsize
    valid = dem != hdr.nodata
    zones = np.where(valid, 1 + 2 * (rows >= n // 2) + (cols >= n // 2), 0).astype(np.int32)
    xc, yc = hdr.xllcorner + n * cs / 2, hdr.yllcorner + n * cs / 2
    st_zone = 1 + 2 * (sy < yc) + (sx >= xc)
    return dict(dem=dem, header=hdr, sx=sx, sy=sy, sz=sz, sv=sv, valid=valid,
                gx=hdr.xllcorner + (cols + 0.5) * cs, gy=hdr.yllcorner + (n - rows - 0.5) * cs,
                gz=np.where(valid, dem, valley_plane(rows, cols, n, cs)), zones=zones,
                areas=[np.nonzero(st_zone == z)[0] for z in range(1, 5)])


def library_calls(inp: dict, dev, card: str, label: str) -> tuple:
    """The device library over ``inp`` on ``dev``, each call timed (wall,
    host reads, peak memory): multiple_detrending and retrend_map, the
    local map, the glocal weights and map, the topographic distances and
    Kh, the empirical and fitted variogram and ordinary kriging of the
    temperatures. Returns (results by call, records by call)."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.physics import detrending as D
    from criteria3d_tpu_torch.physics import kriging as K
    gx, gy, gz = (torch.as_tensor(inp[k], dtype=torch.float64, device=dev)
                  for k in ("gx", "gy", "gz"))
    sx, sy, sz, sv = (inp[k] for k in ("sx", "sy", "sz", "sv"))
    hdr = inp["header"]
    opt = D.DetrendingOptions(**LIB_OPTIONS)
    out, records = {}, {}

    def run(name, fn):
        _sync(dev)
        _peak_gib(dev, reset=True)
        r0, t0 = host_read.count, time.time()
        res = fn()
        _sync(dev)
        records[name] = (time.time() - t0, host_read.count - r0, _peak_gib(dev))
        print(f"# library {label} {name} ({card}): wall {records[name][0]} s, host reads "
              f"{records[name][1]}, peak memory {records[name][2]:.2f} GiB", flush=True)
        out[name] = res
        return res

    detr, model = run("multiple_detrending",
                      lambda: D.multiple_detrending(sv, sz, options=opt, device=dev))
    run("retrend_map", lambda: D.retrend_map(model, gz))
    run("local_detrending_map", lambda: D.local_detrending_map(
        sx, sy, sz, sv, gx, gy, gz, options=opt, device=dev))
    w = run("glocal_weight_maps", lambda: D.glocal_weight_maps(
        inp["zones"], LIB_GLOCAL_WINDOW, hdr.cellsize, device=dev))
    run("glocal_detrending_map", lambda: D.glocal_detrending_map(
        sx, sy, sz, sv, gx, gy, gz, area_stations=inp["areas"], area_weights=w,
        options=opt, device=dev))
    topo, _ = run("topographic_distance_matrix", lambda: D.topographic_distance_matrix(
        inp["dem"], hdr.xllcorner, hdr.yllcorner, hdr.cellsize, hdr.nrows, sx, sy, sz,
        device=dev))
    run("optimize_topo_kh", lambda: D.optimize_topo_kh(
        sx, sy, sz, sv, topo_dist=topo, detrend_model=model, device=dev))
    # the temperatures themselves, their model fitted among the spherical and
    # exponential ones: the detrended values are pure nugget (a flat
    # variogram), whose kriging system is singular, and the gaussian model
    # these temperatures would pick gives a system of cond 2.9e18 over the
    # stations, whose map is rounding noise (in JAX too)
    h, g, c = run("empirical_variogram", lambda: K.empirical_variogram(sx, sy, sv,
                                                                       device=dev))
    vm = run("fit_variogram", lambda: K.fit_variogram(h, g, c,
                                                      modes=(K.SPHERICAL, K.EXPONENTIAL)))
    run("ordinary_kriging", lambda: K.ordinary_kriging(sx, sy, sv, gx, gy, vm))
    return out, records


def library_full_size(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """phase 3t: the device library over 3k's box (n x n cells, 100
    stations at full size) on ``dev``, then the local map once more under
    the profiler (the ``c3d.detrending`` range's device time)."""
    import numpy as np
    import torch
    from criteria3d_tpu_torch.physics import detrending as D
    inp = library_inputs(seed, n)
    out, records = library_calls(inp, dev, card, f"{n} box")
    valid = torch.as_tensor(inp["valid"], device=dev)
    model = out["multiple_detrending"][1]
    lm = out["local_detrending_map"]
    kh = out["optimize_topo_kh"]
    print(f"# library {n} box ({card}): {len(inp['sx'])} stations, {n * n} cells; elevation "
          f"fit {model.elevation_params.tolist()} r2 {float(model.elevation_r2)} significant "
          f"{bool(model.elevation_significant)}; local map {float(lm[valid].min())}.."
          f"{float(lm[valid].max())} degC; Kh {kh}; variogram {out['fit_variogram']}",
          flush=True)
    for name in ("retrend_map", "local_detrending_map", "glocal_detrending_map",
                 "ordinary_kriging"):
        m = out[name]
        check(tuple(m.shape) == (n, n) and m.device.type == torch_device_type(dev)
              and bool(torch.isfinite(m).all()) and bool((m[valid] != -9999.0).all()),
              f"3t: {name} is not a finite ({n}, {n}) map on {dev}")
    w = out["glocal_weight_maps"]
    check(float((w.sum(0)[valid] - 1.0).abs().max()) <= 1e-6 and w.dtype == torch.float32,
          "3t: the glocal weights do not sum to 1 on the catchment")
    check(0 <= kh <= 256, f"3t: optimize_topo_kh gave {kh}")
    opt = D.DetrendingOptions(**LIB_OPTIONS)
    band = slice(0, LIB_PROFILED_ROWS)
    gx, gy, gz = (torch.as_tensor(inp[k][band], dtype=torch.float64, device=dev)
                  for k in ("gx", "gy", "gz"))
    band_wall = records["local_detrending_map"][0] * gx.numel() / (n * n)
    busy, _, layers = _profiled(
        f"local detrending map, {gx.shape[0]}-row band", lambda: D.local_detrending_map(
            inp["sx"], inp["sy"], inp["sz"], inp["sv"], gx, gy, gz, options=opt, device=dev),
        band_wall, (D.DETRENDING_RANGE,), dev)
    local_s = layers.get(D.DETRENDING_RANGE, 0.0)
    check(local_s > 0.0, "3t: no device time in the c3d.detrending range")
    print(f"# library {n} box local map, {gx.shape[0]}-row band ({card}): c3d.detrending "
          f"{local_s} s of device time ({local_s / busy} of busy {busy} s)", flush=True)
    return dict(records=records, detrending_s=local_s, busy_s=busy, kh=kh,
                variogram=out["fit_variogram"], stations=len(inp["sx"]))


def _window(inp: dict, n: int) -> dict:
    """``inp`` cut to the LIB_WINDOW x LIB_WINDOW window at the box's
    centre (the stations and the DEM as they are)."""
    side = min(LIB_WINDOW, n)
    sl = slice(n // 2 - side // 2, n // 2 - side // 2 + side)
    cut = dict(inp)
    for k in ("gx", "gy", "gz", "zones", "valid"):
        cut[k] = inp[k][sl, sl]
    return cut


def library_card_vs_cpu(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """phase 3t's window: the same calls on the LIB_WINDOW window on ``dev``
    and on the CPU. Maps rel 1e-9 with the count of differing cells (0),
    the detrended station values 1e-9 of the temperatures' scale;
    the glocal weights and topographic distances bit-equal, the same Kh
    and variogram mode and range (nugget and sill rel 1e-12); the kriging
    system's cond(V) at most LIB_KRIGING_COND and the map within 64 eps x
    cond(V) of its largest value (an LU on each device)."""
    import numpy as np
    import torch
    inp = _window(library_inputs(seed, n), n)
    side = inp["gx"].shape[0]
    runs = {}
    for d in (dev, "cpu"):
        t0 = time.time()
        runs[len(runs)] = (library_calls(inp, d, card, f"window {side} {torch_device_type(d)}")[0],
                           time.time() - t0)
    (oc, wc), (op, wp) = runs[0], runs[1]

    def cells_over(a, b, rtol=1e-9):
        a, b = a.double().cpu(), b.double().cpu()
        return int(((a - b).abs() > rtol * b.abs()).sum()), rel_err(a, b)

    differ, rels = {}, {}
    for name in ("retrend_map", "local_detrending_map", "glocal_detrending_map"):
        differ[name], rels[name] = cells_over(oc[name], op[name])
    # the detrended station values are residuals of the fit, near 0: held
    # to rel 1e-9 of the temperatures' scale
    scale = float(abs(inp["sv"]).max())
    dd = (oc["multiple_detrending"][0].cpu() - op["multiple_detrending"][0]).abs()
    differ["multiple_detrending"] = int((dd > 1e-9 * scale).sum())
    rels["multiple_detrending"] = float(dd.max()) / scale
    w_equal = torch.equal(oc["glocal_weight_maps"].cpu(), op["glocal_weight_maps"])
    topo_equal = torch.equal(oc["topographic_distance_matrix"][0].cpu(),
                             op["topographic_distance_matrix"][0])
    hc, gc, cc = (t.cpu() for t in oc["empirical_variogram"])
    hp, gp, cp = op["empirical_variogram"]
    vario_rel = rel_err(gc, gp)
    vm = op["fit_variogram"]
    from criteria3d_tpu_torch.physics import kriging as K
    d = np.hypot(inp["sx"][:, None] - inp["sx"][None], inp["sy"][:, None] - inp["sy"][None])
    V = np.ones((len(inp["sv"]) + 1,) * 2)
    V[:-1, :-1] = K.variogram(d, vm, device="cpu").numpy()
    V[-1, -1] = 0.0
    cond = float(np.linalg.cond(V))
    bound = 64 * np.finfo(float).eps * cond
    krig = float((oc["ordinary_kriging"].cpu() - op["ordinary_kriging"]).abs().max()
                 / op["ordinary_kriging"].abs().max())
    print(f"# library window {side} ({card}): card {wc} s, CPU {wp} s; cells over rel 1e-9 "
          f"{differ}, rel {rels}; glocal weights bit-equal {w_equal}; topographic distances "
          f"bit-equal {topo_equal}; Kh card {oc['optimize_topo_kh']} CPU "
          f"{op['optimize_topo_kh']}; variogram card {oc['fit_variogram']} CPU {vm}, "
          f"semivariances rel {vario_rel}; kriging map {krig} of its largest value "
          f"(bound {bound}, cond(V) {cond})", flush=True)
    check(not any(differ.values()), f"3t: cells differ between the card and the CPU: {differ}")
    check(w_equal and topo_equal, "3t: glocal weights or topographic distances differ")
    check(oc["optimize_topo_kh"] == op["optimize_topo_kh"], "3t: Kh differs")
    check(torch.equal(hc, hp) and torch.equal(cc, cp) and vario_rel <= 1e-12,
          f"3t: the empirical variogram differs (rel {vario_rel})")
    vc = oc["fit_variogram"]
    # the mode and range are decisions; nugget, sill and slope sums over
    # the bins, in each device's order
    check(vc.mode == vm.mode and vc.range_ == vm.range_
          and all(abs(getattr(vc, k) - getattr(vm, k)) <= 1e-12 * abs(getattr(vm, k))
                  for k in ("nugget", "sill", "slope")),
          f"3t: the fitted variogram differs: card {vc}, CPU {vm}")
    check(cond <= LIB_KRIGING_COND, f"3t: the kriging system's cond(V) {cond} is over "
          f"{LIB_KRIGING_COND}: its bound {bound} would hold no map")
    check(krig <= bound, f"3t: kriging maps differ by {krig} of the largest value")
    return dict(walls=(wc, wp), differ=differ, rels=rels, kriging=krig, bound=bound, cond=cond)


def _basin_outline(basin, hdr):
    """A clockwise ring around a basin raster whose rows are contiguous:
    down the east edges of its rows, then up the west edges."""
    import numpy as np
    ok = basin != hdr.nodata
    rows = [r for r in range(ok.shape[0]) if ok[r].any()]
    cs = hdr.cellsize
    top = hdr.yllcorner + hdr.nrows * cs
    east, west = [], []
    for r in rows:
        cols = np.nonzero(ok[r])[0]
        y0, y1 = top - r * cs, top - (r + 1) * cs
        xe = hdr.xllcorner + (cols[-1] + 1) * cs
        xw = hdr.xllcorner + cols[0] * cs
        east += [(xe, y0), (xe, y1)]
        west += [(xw, y0), (xw, y1)]
    ring = east + west[::-1]
    return np.array(ring + ring[:1], dtype=np.float64)


def host_library(seed: int, card: str, tmp: str, dev="cuda", n: int = 768,
                 storm=None, state_map=None) -> dict:
    """phase 3u: the host library on full-size products: the strict D8
    watershed of 3k's DEM from its outlet; its outline as a shapefile
    (rasterized back and given its mean height through shape_utils),
    reprojected to lat-lon, written and read back; a state map through
    NetCDF and back; balance_report and dump_linear_system on the bundle
    storm hour's state on ``dev``.

    ``storm`` is (grid, params, state0, state) of that hour (on any
    device; built and run here when None); ``state_map`` a state map of
    3k's last hour (the storm hour's root-zone water content when None)."""
    import numpy as np
    import torch
    from criteria3d_tpu_torch.core.watershed import clean_basin
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.io import netcdf, reproject, shape_utils, shapefile
    from criteria3d_tpu_torch.problems import project_dem
    from criteria3d_tpu_torch.project import state_maps
    from criteria3d_tpu_torch.solver import water as W
    from criteria3d_tpu_torch.utils import debug_dump, telemetry
    walls = {}
    dem, hdr = project_dem(n, seed)
    valid = dem != hdr.nodata
    col = n // 2
    row = int(np.nonzero(valid[:, col])[0][-1])
    x, y = hdr.xllcorner + (col + 0.5) * hdr.cellsize, hdr.yllcorner + (n - row - 0.5) * hdr.cellsize
    t0 = time.time()
    basin, bh = clean_basin(dem, hdr, x, y)
    walls["clean_basin"] = time.time() - t0
    in_basin = basin != hdr.nodata
    check(in_basin.sum() >= 0.9 * valid.sum(),
          f"3u: the watershed holds {int(in_basin.sum())} of {int(valid.sum())} cells")

    t0 = time.time()
    ring = _basin_outline(basin, bh)
    h = shapefile.ShapeHandler()
    path = os.path.join(tmp, "catchment.shp")
    h.new_shapefile(path, shapefile.POLYGON)
    h.fields = [shapefile.DbfField("ID", "N", 6, 0)]
    h.add_shape(shapefile.ShapeObject(shapefile.POLYGON, [ring]), {"ID": 1})
    # rasterized back on cells of 9 x the DEM's: each cell's centre is a DEM
    # cell's centre (the crossing test over every edge stays small)
    k = LIB_OUTLINE_CELLS
    zones, zh = shape_utils.initialize_raster_from_shape(h, k * bh.cellsize)
    shape_utils.fill_raster_with_shape_index(zones, zh, h)
    # both rasters start at the outline's south-west corner: a coarse cell's
    # centre lies in the DEM cell k // 2 cells up and right of its corner
    rc, cc = np.mgrid[0:zh.nrows, 0:zh.ncols]
    rf = bh.nrows - 1 - ((zh.nrows - 1 - rc) * k + k // 2)
    cf = cc * k + k // 2
    inside = (rf >= 0) & (cf < bh.ncols)
    at = np.where(inside, basin[np.maximum(rf, 0), np.minimum(cf, bh.ncols - 1)],
                  hdr.nodata)
    check(bool(((zones == 0) == (at != hdr.nodata)).all()),
          "3u: the outline does not rasterize back to the watershed")
    zmean = shape_utils.zonal_statistics_shape(h, zones, at, "ZMEAN")
    h.save()
    ll = reproject.reproject_shapes(shapefile.ShapeHandler().open(path).shapes,
                                    ("utm", 32), ("latlon",))
    hl = shapefile.ShapeHandler()
    path_ll = os.path.join(tmp, "catchment_ll.shp")
    hl.new_shapefile(path_ll, shapefile.POLYGON)
    hl.fields = [shapefile.DbfField("ID", "N", 6, 0)]
    hl.add_shape(ll[0], {"ID": 1})
    hl.save()
    back_ll = shapefile.ShapeHandler().open(path_ll).shapes[0].parts[0]
    back = reproject.reproject_shapes(shapefile.ShapeHandler().open(path_ll).shapes,
                                      ("latlon",), ("utm", 32))[0].parts[0]
    d_ring = float(np.abs(back - ring).max())
    walls["shapefile"] = time.time() - t0
    check(np.array_equal(back_ll, ll[0].parts[0]) and d_ring < 0.01,
          f"3u: the reprojected outline reads back {d_ring} m from the ring")

    if storm is None:
        from criteria3d_tpu_torch import SolverParameters
        from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
        from criteria3d_tpu_torch.solver.step import compute_period_stats
        params = SolverParameters.fast_f32(use_pallas=True)
        grid, state0 = build_problem(synthetic_catchment(seed, n=n, radius=n * 366.0 / 768),
                                     4.0, params, dev)
        state, _ = compute_period_stats(grid, params, state0, 3600.0)
    else:
        grid, params, state0, state = storm
        grid, state0, state = grid.to(dev), state0.to(dev), state.to(dev)
    if state_map is None:
        state_map = state_maps(grid, params, state)[0]
    t0 = time.time()
    nc = os.path.join(tmp, "swc.nc")
    netcdf.export_raster(nc, state_map, hdr, var_name="swc", unit="m3 m-3",
                         long_name="root-zone water content")
    hn = netcdf.NetCDFHandler().read(nc)
    read, _ = hn.extract_raster("swc")
    hn.close()
    walls["netcdf"] = time.time() - t0
    # the file holds float32 values
    d_nc = float(np.abs(read - state_map.astype(np.float32)).max())
    check(read.shape == state_map.shape and d_nc == 0.0,
          f"3u: the NetCDF map reads back {d_nc} apart from its float32 values")

    host_read.count = 0
    t0 = time.time()
    s0 = host_read(W.total_water_content(grid, params, state0.h, state0.se))
    rain = host_read(state0.sink_source.sum()) * 3600.0
    rep = telemetry.balance_report(grid, params, state, s0, total_precipitation=rain)
    walls["balance_report"] = time.time() - t0
    reads = host_read.count
    check(all(math.isfinite(v) for v in rep.values())
          and abs(rep["mass_balance_error_m3"]) < 2e-3 * rain,
          f"3u: balance_report {rep} (rain {rain} m3)")
    t0 = time.time()
    dump = debug_dump.load_dump(debug_dump.dump_linear_system(
        os.path.join(tmp, "system"), grid, params, state, dt=60.0))
    walls["dump_linear_system"] = time.time() - t0
    se = W.compute_se(grid, params, state.h)
    cap, k = W.compute_capacity(grid, params, state.h, state.h_old, se)
    flow, rate = W.update_boundary_water(grid, params, state.h, state.h_old, k,
                                         state.sink_source, state.pond, 60.0)
    sysm = W.assemble_system(grid, params, state.h, state.h_old, k, flow, cap, state.pond,
                             0, 60.0)
    card_arrays = dict(b=sysm.b, diag=sysm.diag, c_up=sysm.c_up, c_down=sysm.c_down,
                       c_lat=sysm.c_lat, capacity=cap, k=k, water_flow=flow,
                       boundary_rate=rate, x0=state.h)
    same = all(np.array_equal(dump[key], v.cpu().numpy()) for key, v in card_arrays.items())
    check(same and dump["courant"] == float(sysm.courant) and state.h.device.type
          == torch_device_type(dev), "3u: the linear-system dump differs from the card's arrays")
    print(f"# host library {n} box ({card}): watershed {int(in_basin.sum())} cells "
          f"({bh.nrows} x {bh.ncols}) in {walls['clean_basin']} s; outline of {len(ring)} "
          f"vertices, mean height {float(zmean[0])} m, to lat-lon and back within {d_ring} m "
          f"in {walls['shapefile']} s; NetCDF state map {state_map.shape} back within {d_nc} "
          f"in {walls['netcdf']} s; balance_report ({reads} host reads) {rep} in "
          f"{walls['balance_report']} s; dump_linear_system of {state.h.numel()} nodes equal "
          f"to the card's arrays in {walls['dump_linear_system']} s", flush=True)
    return dict(walls=walls, basin_cells=int(in_basin.sum()), d_ring=d_ring, d_nc=d_nc,
                report=rep, reads=reads)


def library_phases(seed: int, card: str, dev="cuda", n: int = 768, storm=None,
                   state_map=None) -> dict:
    """Phases 3t-3u (the interpolation library on the device, then the
    host library); returns what they measured. ``dev="cpu"`` with a small
    ``n`` rehearses them on the CPU (no device time, no peak memory)."""
    import torch
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        full = library_full_size(seed, card, dev, n)
        if torch_device_type(dev) == "cuda":
            torch.cuda.empty_cache()
        small = library_card_vs_cpu(seed, card, dev, n)
        host = host_library(seed, card, tmp, dev, n, storm, state_map)
    seconds = time.time() - t0
    print(f"# phases 3t-3u took {seconds} s ({card})", flush=True)
    return dict(full=full, small=small, host=host, seconds=seconds)


# ----------------------------------------------------------------------
# the device mesh (3v): virtual blocks on one card
# ----------------------------------------------------------------------

# 3v: the meshes of virtual blocks (4 gives 2 x 2, 8 gives 2 x 4) and the
# sweep cap of the seeded loops (SolverParameters' max_iterations)
MESH_BLOCKS = (4, 8)
MESH_MAX_ITER = 200


def virtual_mesh(blocks: int, dev):
    """A mesh of ``blocks`` blocks, all on ``dev``."""
    import torch
    from criteria3d_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(blocks, devices=[torch.device(dev)] * blocks)


def mesh_halo(seed: int, dev, n: int) -> None:
    """3v (i): halo_exchange of a seeded (7, n, n) and (8, 7, n, n) array
    over 2 x 2 and 2 x 4 blocks on ``dev``: every grown block bit-equal to
    its window of the zero-padded array."""
    import numpy as np
    import torch
    from criteria3d_tpu_torch.parallel.sharding import halo_exchange, split_blocks
    from criteria3d_tpu_torch.solver.jacobi_bundle import SWEEPS_PER_BUNDLE as K
    g = torch.Generator(device=dev).manual_seed(seed)
    for lead in ((7,), (8, 7)):
        a = torch.rand(*lead, n, n, generator=g, device=dev)
        padded = torch.nn.functional.pad(a, (K, K, K, K))
        for nb in MESH_BLOCKS:
            mesh = virtual_mesh(nb, dev)
            mr, mc = mesh.devices.shape
            r, c = n // mr, n // mc
            for (i, j), blk in np.ndenumerate(halo_exchange(split_blocks(a, mesh), K, mesh)):
                check(torch.equal(blk, padded[..., i * r:i * r + r + 2 * K,
                                              j * c:j * c + c + 2 * K]),
                      f"3v: halo_exchange of {tuple(a.shape)} over {mesh.shape}: "
                      f"block ({i}, {j}) differs from its zero-padded window")
        print(f"# 3v halo_exchange of {tuple(a.shape)} over 2 x 2 and 2 x 4 blocks: "
              "bit-equal to the zero-padded windows", flush=True)
        del a, padded


def mesh_loops(seed: int, dev, n: int, meshes=None) -> dict:
    """3v (ii): the mesh loop on phase 2's seeded (7, n, n) inputs over
    ``meshes`` (2 x 2 blocks on ``dev`` when None: the script's 600 s
    leave no room for 2 x 4), keyed by their block counts, against the single-device loop (x bit-equal,
    the same n_it and flag); the ms of one bundle of each (CUDA events on
    the card), of the x exchange alone, the bound of a mesh bundle (each
    block's kernel bound at its grown size plus the exchange's bytes:
    every grown cell written once, read once from its source) and the
    tiled variant each block runs; on the card the kernel's ms on each
    block, on the block's own card (``block_ms``, row-major)."""
    import numpy as np
    import torch
    from criteria3d_tpu_torch.bench_jacobi import bundle_inputs, cuda_ms
    from criteria3d_tpu_torch.parallel.sharding import (exchange, gather_pytree,
                                                        shard_pytree)
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    K = JB.SWEEPS_PER_BUNDLE
    L = 7
    card = torch_device_type(dev) == "cuda"
    inputs = bundle_inputs((L, n, n), seed, dev)
    n_nodes = int(inputs[4].sum())
    x1, d1, n1 = JB.jacobi_solve_loop(*inputs, MESH_MAX_ITER, 1e-7, n_nodes)
    single_ms = cuda_ms(lambda: JB.jacobi_bundle(*inputs), reps=20) if card else None
    out = dict(single_ms=single_ms, n_it=n1, meshes={})
    for mesh in meshes or [virtual_mesh(4, dev)]:
        blocked = [shard_pytree(a, mesh) for a in inputs]
        system, xs = tuple(blocked[:5]), blocked[5]
        xm, dm, nm = JB.jacobi_solve_loop(*blocked, MESH_MAX_ITER, 1e-7, n_nodes,
                                          mesh=mesh)
        xm = gather_pytree(xm, dev)
        _sync(dev)
        check(torch.equal(xm, x1) and (nm, dm) == (n1, d1),
              f"3v: the mesh loop over {mesh.shape} gave n_it {nm} diverged {dm}, "
              f"max |dx| {float((xm - x1).abs().max())} against the single-device "
              f"loop's n_it {n1} diverged {d1}")
        variants = [JB.tiled_variant(*(a.blocks[i, j] for a in system), x) if card
                    else None for (i, j), x in np.ndenumerate(xs.blocks)]
        grown = [int(x.numel()) for x in xs.blocks.flat]
        bound_ms = (sum(max((14 * v + 1) * 4 / HBM_BYTES_PER_S,
                            v * (K * FLOPS_PER_NODE_SWEEP + FLOPS_PER_NODE_NORM) / F32_FLOPS)
                        for v in grown) + 2 * 4 * sum(grown) / HBM_BYTES_PER_S) * 1e3
        rec = dict(mesh=mesh.shape, n_it=nm, variants=variants, bound_ms=bound_ms,
                   grown_share=sum(grown) / (L * n * n))
        if card:
            rec["ms"] = cuda_ms(lambda: JB.mesh_bundle(system, xs), reps=20)
            rec["exchange_ms"] = cuda_ms(lambda: exchange(xs), reps=20)
            rec["block_ms"] = []
            for idx, x in np.ndenumerate(xs.blocks):
                with torch.cuda.device(x.device):
                    rec["block_ms"].append(cuda_ms(lambda: JB.jacobi_bundle(
                        *(a.blocks[idx] for a in system), x, halo=K), reps=20))
        out["meshes"][mesh.devices.size] = rec
        share = rec["exchange_ms"] / rec["ms"] if card else None
        print(f"# 3v mesh loop over {mesh.shape} (blocks on "
              f"{sorted({str(d) for d in mesh.devices.flat})}): x bit-equal to the "
              f"single-device loop, n_it {nm} diverged {dm}; blocks hold "
              f"{rec['grown_share']} x the cells; ms per bundle {rec.get('ms')} "
              f"(exchange {rec.get('exchange_ms')}, share {share}; the kernel on each "
              f"block, on its card, {rec.get('block_ms')}) against the single "
              f"kernel's {single_ms}, bound {bound_ms} ms; tiled variants {variants}",
              flush=True)
        del blocked, system, xs, xm
    return out


# 3v (iii): the storm hours partitioned, in phases 3-3c's order
MESH_FORMS = ("bundle", "cg_line", "f64")
# and the same blocks split into machines (each block its own, and the
# bundle's also by rows of blocks), run by the rounds driver
MESH_MACHINES = {"bundle": ((0, 1, 2, 3), (0, 0, 1, 1)), "cg_line": ((0, 1, 2, 3),),
                 "f64": ((0, 1, 2, 3),)}


# 3v (iii): phase 3e's coupled storm hour on the same blocks split into
# machines, and (3x (v)) the bundle-form coupled hour at its small box on
# 2 x 2 blocks split into machines, both in 3v's process of their own
COUPLED_MACHINES = ((0, 1, 2, 3),)
BUNDLE_COUPLED_MACHINES = ((0, 1, 2, 3), (0, 0, 1, 1))


def mesh_form_params(form: str, mesh=None):
    from criteria3d_tpu_torch import SolverParameters
    if form == "coupled":       # phase 3e's
        return SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True,
                                         mesh=mesh)
    if form == "bundle_coupled":        # 3x (v)'s
        return SolverParameters.fast_f32(use_pallas=True, heat_vapor=True,
                                         heat_frozen_props=True, mesh=mesh)
    if form == "bundle":
        return SolverParameters.fast_f32(use_pallas=True, mesh=mesh)
    if form == "cg_line":
        return SolverParameters.fast_f32(mesh=mesh)
    return SolverParameters(mesh=mesh)


def one_device_hour(form: str, seed: int, dev, n: int) -> dict:
    """The storm hour of ``form`` on one device, graph-driven on the card
    (eager on the CPU): the reference of a partitioned hour (phases 3-3c
    give it in ``main``, with their eager hour's reads and peak). The grid
    and initial state stay on the host."""
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    params = mesh_form_params(form)
    grid, state0 = build_problem(synthetic_catchment(seed, n=n, radius=n * 366.0 / 768),
                                 4.0, params, dev)
    host_read.count = 0
    out, stats = compute_period_stats(grid, params, state0, 3600.0)
    eager = _mesh_driver(None, grid.device) == "eager"
    return dict(grid=grid.to("cpu"), state0=state0.to("cpu"), h=out.h.to("cpu"),
                stats=tuple(stats), mbr=float(out.balance_whole.mbr),
                reads=host_read.count, eager_reads=host_read.count if eager else None,
                eager_peak_gib=None)


def _mesh_driver(mesh, device=None) -> str:
    """The driver of a period on ``mesh`` (on ``device`` without one)."""
    from criteria3d_tpu_torch.solver import device_loop
    return device_loop.driver_for(mesh.home if mesh is not None else device, mesh)[0]


def mesh_hour(form: str, card: str, dev, ref: dict, mesh) -> dict:
    """3v (iii): the storm hour of ``form`` partitioned over ``mesh``
    (grid and state cut from the host by ``shard_pytree``, the whole
    water step on the blocks, the result joined by ``gather_pytree``)
    against the one-device hour ``ref``: stats, MBR, wall, host reads,
    bundle launches (one per block and bundle), the graph machine's
    launches and capture seconds, the peak memory. On one card's blocks the
    graph driver runs it (its machine captured by a zero-length period
    first), and on a mesh over several cards the rounds driver (one
    machine a card), against the graph-driven one-device hour: the same
    stats and MBR, float32 heads bit-equal, float64 within 1e-9 m, host
    reads at most 5 % of the eager one-device hour's (graph) or at most the
    graph launches plus 3 (rounds). The eager driver (the CPU) runs it
    against the eager one-device hour: the same host reads; heads within
    1e-5 m (f32) or 1e-9 m (f64) when the stats are equal, else within the
    free-running float32 envelopes of tests/test_fast_f32.py (max 0.1 m,
    median 1e-2 m). |MBR| < 2e-3 either way. The result holds the joined
    heads on the host (``h``)."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    K = JB.SWEEPS_PER_BUNDLE
    blocks = mesh.devices.size
    driver = _mesh_driver(mesh)
    on_card = torch_device_type(mesh.home) == "cuda"
    params = mesh_form_params(form, mesh)
    device_loop.clear()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    grid_s, state_s = shard_pytree(ref["grid"], mesh), shard_pytree(ref["state0"], mesh)
    _sync_mesh(mesh)
    parts = dict(shard=time.time() - t0)
    device_loop.reset_counts()
    t0 = time.time()
    compute_period_stats(grid_s, params, state_s, 0.0)
    _sync_mesh(mesh)
    parts["capture"] = time.time() - t0
    capture_s = device_loop.counts()["capture_s"]
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    device_loop.reset_counts()
    t0 = time.time()
    out, stats = compute_period_stats(grid_s, params, state_s, 3600.0)
    _sync_mesh(mesh)
    wall = time.time() - t0
    launches, reads, drv = JB.jacobi_bundle.launches, host_read.count, device_loop.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    device_loop.clear()
    t0 = time.time()
    out = gather_pytree(out, "cpu")
    parts["gather"] = time.time() - t0
    mbr = float(out.balance_whole.mbr)
    err = (out.h - ref["h"]).abs()[ref["grid"].mask]
    dh_max, dh_median = float(err.max()), float(err.median())
    print(f"# 3v {form} storm hour partitioned, {mesh.shape} blocks on "
          f"{sorted({str(d) for d in mesh.devices.flat})} ({card}), {driver} driver "
          f"({drv['launches']} graph launches, capture {capture_s} s): stats {stats} "
          f"(one device {ref['stats']}) whole-period MBR={mbr} (one device {ref['mbr']}) "
          f"wall {wall} s host reads {reads} (one device {ref['reads']}, eager "
          f"{ref['eager_reads']}) bundle launches {launches}; peak memory {peak} GiB (the "
          f"eager one-device hour's {ref['eager_peak_gib']}); heads against the one-device "
          f"hour: max {dh_max} m, median {dh_median} m", flush=True)
    check(abs(mbr) < 2e-3, f"3v {form}: |whole-period MBR| {mbr} >= 2e-3")
    if form == "bundle" and on_card:
        check(launches * K == blocks * stats[3],
              f"3v: {launches} launches for {stats[3]} sweeps on {blocks} blocks")
    if form != "bundle":
        check(launches == 0, f"3v {form}: {launches} bundle launches")
    if driver in ("graph", "rounds"):
        check(drv[f"{driver}_periods"] == 1 and drv["eager_periods"] == 0,
              f"3v {form}: the partitioned hour did not run {driver}-driven ({drv})")
        check(tuple(stats) == tuple(ref["stats"]) and mbr == ref["mbr"],
              f"3v {form}: stats {stats} MBR {mbr} against the one device's "
              f"{ref['stats']} {ref['mbr']}")
        check(dh_max <= 1e-9 if form == "f64" else dh_max == 0.0,
              f"3v {form}: heads {dh_max} m from the one-device hour's")
        if driver == "rounds":
            check_rounds(f"3v {form}", reads, drv)
        elif ref["eager_reads"]:
            check(reads <= 0.05 * ref["eager_reads"], f"3v {form}: {reads} host reads, "
                  f"more than 5 % of the eager hour's {ref['eager_reads']}")
    else:
        check(reads == ref["eager_reads"], f"3v {form}: {reads} host reads, the "
                                           f"one-device hour {ref['eager_reads']}")
        if tuple(stats) == tuple(ref["stats"]):
            tol = 1e-9 if form == "f64" else 1e-5
            check(dh_max <= tol, f"3v {form}: equal stats, heads {dh_max} m apart")
        else:
            check(dh_max < 0.1 and dh_median < 1e-2,
                  f"3v {form}: heads {dh_max} m (median {dh_median}) outside the f32 "
                  "envelopes")
    res = dict(stats=tuple(stats), mbr=mbr, wall_s=wall, host_reads=reads,
               launches=launches, graph_launches=drv["launches"], rounds=drv["rounds"],
               rounds_enqueued=drv["rounds_enqueued"], capture_s=capture_s, peak_gib=peak,
               driver=driver, dh_max=dh_max, parts=parts, h=out.h)
    del grid_s, state_s
    return res


def check_rounds(label: str, reads: int, drv: dict) -> None:
    """A period run by the rounds driver: host reads at most its batches
    of rounds (graph launches) plus 3, and as many batches as the rounds
    that ran a segment need (a batch ends early once none is left)."""
    from criteria3d_tpu_torch.solver import device_loop
    check(reads <= drv["launches"] + 3,
          f"{label}: {reads} host reads for {drv['launches']} batches of rounds")
    check(drv["launches"] == -(-drv["rounds"] // device_loop.UNITS_PER_LAUNCH)
          and drv["rounds"] <= drv["rounds_enqueued"],
          f"{label}: {drv['launches']} batches for {drv['rounds']} rounds run, "
          f"{drv['rounds_enqueued']} enqueued")


def machines_hour(form: str, card: str, grid_s, state_s, mesh, machines) -> dict:
    """3v (iii): the storm hour of ``form`` on the blocks of ``mesh``
    (``grid_s``, ``state_s``) split into the machines ``machines`` (one
    int a block, row-major), run by the rounds driver (each machine on its
    own stream; captured by a zero-length period first): its stats, MBR,
    wall, host reads, graph launches (batches of rounds), rounds run and
    enqueued, bundle launches, capture seconds, peak memory and heads (on
    the host, ``h``), host reads held by :func:`check_rounds`."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, make_mesh, remesh
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    split = make_mesh(mesh.devices.size, devices=list(mesh.devices.flat), machines=machines)
    grid, state = remesh(grid_s, split), remesh(state_s, split)
    params = mesh_form_params(form, split)
    on_card = torch_device_type(mesh.home) == "cuda"
    driver = _mesh_driver(split)
    check(driver == "rounds", f"3v {form}: machines {machines} run by the {driver} driver")
    device_loop.clear()
    if on_card:
        _sync_mesh(mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    device_loop.reset_counts()
    compute_period_stats(grid, params, state, 0.0)
    _sync_mesh(mesh)
    capture_s = device_loop.counts()["capture_s"]
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    device_loop.reset_counts()
    t0 = time.time()
    out, stats = compute_period_stats(grid, params, state, 3600.0)
    _sync_mesh(mesh)
    wall = time.time() - t0
    launches, reads, drv = JB.jacobi_bundle.launches, host_read.count, device_loop.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    h = gather_pytree(out.h, "cpu")
    mbr = float(out.balance_whole.mbr)
    device_loop.clear()
    print(f"# 3v {form} storm hour on {mesh.shape} blocks split into machines {machines} "
          f"({card}), rounds driver: stats {tuple(stats)} MBR {mbr} wall {wall} s host reads "
          f"{reads} graph launches {drv['launches']} rounds {drv['rounds']} (enqueued "
          f"{drv['rounds_enqueued']}) bundle launches {launches} capture {capture_s} s peak "
          f"{peak} GiB", flush=True)
    check(drv["rounds_periods"] == 1 and drv["eager_periods"] == 0,
          f"3v {form} machines {machines}: drivers {drv}")
    check_rounds(f"3v {form} machines {machines}", reads, drv)
    return dict(stats=tuple(stats), mbr=mbr, wall_s=wall, host_reads=reads,
                graph_launches=drv["launches"], rounds=drv["rounds"],
                rounds_enqueued=drv["rounds_enqueued"], launches=launches,
                capture_s=capture_s, peak_gib=peak, h=h)


def machines_hours_run(work: str, card: str, dev) -> None:
    """The body of :func:`machines_hours`, in the process that runs the
    hours: the grids and states saved in ``work`` cut into 2 x 2 blocks of
    ``dev``, and each storm hour (MESH_FORMS) split into each grouping of
    MESH_MACHINES (:func:`machines_hour`); phase 3e's coupled storm hour
    split into each grouping of COUPLED_MACHINES (:func:`mesh_coupled_hour`
    against the saved one-device hour); 3x (v)'s bundle-form coupled hour
    in machines (:func:`bundle_coupled_machines`). Each hour's heads (and
    temperatures) and numbers written back to ``work``."""
    import torch
    from criteria3d_tpu_torch.parallel.sharding import make_mesh, shard_pytree
    saved = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    mesh = virtual_mesh(4, dev)
    results = {}

    def keep(name, r):
        torch.save({k: r.pop(k) for k in ("h", "t") if k in r},
                   os.path.join(work, f"{name}.pt"))
        results[name] = r
    for form in MESH_FORMS:
        grid, state = saved[form]
        grid_s, state_s = shard_pytree(grid, mesh), shard_pytree(state, mesh)
        for machines in MESH_MACHINES[form]:
            keep(f"{form}-{''.join(map(str, machines))}",
                 machines_hour(form, card, grid_s, state_s, mesh, machines))
        del grid_s, state_s
    for machines in COUPLED_MACHINES:
        split = make_mesh(4, devices=list(mesh.devices.flat), machines=machines)
        keep(f"coupled-{''.join(map(str, machines))}",
             mesh_coupled_hour(card, dev, saved["coupled"], split))
    bundle = bundle_coupled_machines(card, dev, saved["bundle_coupled_n"])
    with open(os.path.join(work, "results.json"), "w") as f:
        json.dump(dict(hours=results, bundle_coupled=bundle), f)


def machines_hours(refs: dict, card: str, dev, n: int = 768) -> dict:
    """3v (iii): the storm hours (MESH_FORMS) and phase 3e's coupled hour
    on 2 x 2 blocks split into machines, and 3x (v)'s bundle-form coupled
    hour in machines on a box of n / 16 (at least 16, at most 48)
    (:func:`machines_hours_run`), on the card in a process of its own
    (``chip_smoke.py --machines-hours DIR``): torch.profiler, once run in a
    process, slows every CUDA call after it there, and the rounds driver
    makes ~50 a round from the host. ``refs`` gives each form's grid and
    initial state and the coupled one-device hour (saved for that process);
    returns, per form (and "coupled") and grouping, what
    :func:`machines_hour` (:func:`mesh_coupled_hour`) measured, with the
    heads (and temperatures), and under "bundle_coupled" what
    :func:`bundle_coupled_machines` measured."""
    import torch
    with tempfile.TemporaryDirectory() as work:
        torch.save(dict({form: (refs[form]["grid"], refs[form]["state0"])
                         for form in MESH_FORMS}, coupled=refs["coupled"],
                        bundle_coupled_n=min(48, max(n // 16, 16))),
                   os.path.join(work, "inputs.pt"))
        if torch_device_type(dev) == "cuda":
            sys.stdout.flush()
            done = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--machines-hours", work], timeout=600)
            check(done.returncode == 0,
                  f"3v: the machines' hours exited with {done.returncode}")
        else:
            machines_hours_run(work, card, dev)
        with open(os.path.join(work, "results.json")) as f:
            results = json.load(f)
        out = {form: {} for form in MESH_FORMS + ("coupled",)}
        for name, r in results["hours"].items():
            form, groups = name.split("-")
            r["stats"] = tuple(r["stats"])
            r.update(torch.load(os.path.join(work, f"{name}.pt")))
            out[form][tuple(int(c) for c in groups)] = r
        out["bundle_coupled"] = results["bundle_coupled"]
    return out


def bundle_coupled_machines(card: str, dev="cuda", n: int = 48) -> dict:
    """3x (v) in machines: the bundle-form coupled storm hour of
    :func:`bundle_coupled_graph_vs_eager` (an n x n box of the synthetic
    catchment) on 2 x 2 blocks of ``dev``, one machine (graph-driven on
    the card, eager on the CPU) and then split into each grouping of
    BUNDLE_COUPLED_MACHINES (the rounds driver), each captured by a
    zero-length period first and its counts set to 0 just before its
    hour: every count, both MBRs and the bundle launches equal to the one
    machine's, h and T bit-equal, host reads at most the batches of rounds
    plus 3; on the card the bundle launched on every block (launches x K =
    4 x inner iterations). Returns, per grouping ("one" and the
    groupings' digits), the counts, MBRs, wall, host reads, bundle and
    graph launches, rounds run and enqueued and capture seconds."""
    import torch
    from criteria3d_tpu_torch.bench import coupled_heat_mbr
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, make_mesh, shard_pytree
    from criteria3d_tpu_torch.problems import build_coupled_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    on_card = torch_device_type(dev) == "cuda"
    whole = mesh_form_params("bundle_coupled")
    inputs = build_coupled_problem(synthetic_catchment(0, n=n, radius=n * 366.0 / 768), 4.0,
                                   whole, "cpu")
    out = {}
    for machines in (None,) + BUNDLE_COUPLED_MACHINES:
        mesh = make_mesh(4, devices=[torch.device(dev)] * 4, machines=machines)
        params = mesh_form_params("bundle_coupled", mesh)
        blocked = [shard_pytree(x, mesh) for x in inputs]
        device_loop.clear()
        device_loop.reset_counts()
        CP.compute_period_coupled(blocked[0], params, *blocked[1:], 0.0)
        _sync_mesh(mesh)
        capture_s = device_loop.counts()["capture_s"]
        CP.reset_counts()
        device_loop.reset_counts()
        JB.jacobi_bundle.launches = 0
        host_read.count = 0
        t0 = time.time()
        w, h = CP.compute_period_coupled(blocked[0], params, *blocked[1:], 3600.0)
        _sync_mesh(mesh)
        wall = time.time() - t0
        counts, reads, launches = CP.counts(), host_read.count, JB.jacobi_bundle.launches
        drv = device_loop.counts()
        device_loop.clear()
        w, h = gather_pytree(w, "cpu"), gather_pytree(h, "cpu")
        r = dict(counts=counts, mbr=float(w.balance_whole.mbr),
                 heat_mbr=coupled_heat_mbr(inputs[0], whole, w, h), wall_s=wall,
                 host_reads=reads, launches=launches, graph_launches=drv["launches"],
                 rounds=drv["rounds"], rounds_enqueued=drv["rounds_enqueued"],
                 capture_s=capture_s, driver=_mesh_driver(mesh), h=w.h, t=h.t)
        name = "one" if machines is None else "".join(map(str, machines))
        print(f"# 3x (v) bundle coupled hour, {n} box on 2 x 2 blocks, machines {name} "
              f"({card}), {r['driver']} driver: counts {counts} MBRs {r['mbr']} / "
              f"{r['heat_mbr']} wall {wall} s host reads {reads} bundle launches {launches} "
              f"graph launches {drv['launches']} rounds {drv['rounds']} (enqueued "
              f"{drv['rounds_enqueued']}) capture {capture_s} s", flush=True)
        check(abs(r["mbr"]) < 2e-3 and math.isfinite(r["heat_mbr"]),
              f"3x (v) bundle coupled, machines {name}: MBRs {r['mbr']} / {r['heat_mbr']}")
        if on_card:
            check(launches > 0 and launches * JB.SWEEPS_PER_BUNDLE
                  == 4 * counts["inner_iterations"],
                  f"3x (v) bundle coupled, machines {name}: {launches} launches for "
                  f"{counts['inner_iterations']} sweeps on 4 blocks")
        if machines is not None:
            one = out["one"]
            same = torch.equal(r["h"], one["h"]) and torch.equal(r["t"], one["t"])
            check(r["driver"] == "rounds" and drv["rounds_periods"] == 1,
                  f"3x (v) bundle coupled, machines {name}: the {r['driver']} driver ({drv})")
            check(all(r[k] == one[k] for k in ("counts", "mbr", "heat_mbr", "launches"))
                  and same, f"3x (v) bundle coupled, machines {name}: counts {counts}, MBRs "
                  f"{r['mbr']} / {r['heat_mbr']}, launches {launches}, h and T equal {same} "
                  f"against one machine's {one['counts']}, {one['mbr']} / "
                  f"{one['heat_mbr']}, {one['launches']}")
            check_rounds(f"3x (v) bundle coupled, machines {name}", reads, drv)
        out[name] = r
        del blocked, w, h
    for r in out.values():
        del r["h"], r["t"]
    return out


def check_machines_hour(form: str, card: str, machines, r: dict, one: dict) -> None:
    """3v (iii): ``r``, the storm hour of ``form`` (or phase 3e's coupled
    hour) on 2 x 2 blocks split into ``machines`` (:func:`machines_hour`,
    :func:`mesh_coupled_hour`), against ``one``, the one machine's hour on
    the same blocks (:func:`mesh_hour`, :func:`mesh_coupled_hour`): stats
    (every count of the coupled hour), MBR (both) and bundle launches
    equal, heads (and temperatures) bit-equal."""
    import torch
    keys = (("counts", "mbr", "heat_mbr", "launches") if form == "coupled"
            else ("stats", "mbr", "launches"))
    fields = ("h", "t") if form == "coupled" else ("h",)
    same = all(torch.equal(r[k], one[k]) for k in fields)
    print(f"# 3v {form} storm hour in machines {machines} ({card}): "
          + " ".join(f"{k} {r[k]}" for k in keys) + f" wall {r['wall_s']} s host reads "
          f"{r['host_reads']} graph launches {r['graph_launches']} rounds {r['rounds']} "
          f"(enqueued {r['rounds_enqueued']}) capture {r['capture_s']} s; one machine: "
          + " ".join(f"{k} {one[k]}" for k in keys) + f" wall {one['wall_s']} s; "
          f"{' and '.join(fields)} bit-equal {same}", flush=True)
    check(all(r[k] == one[k] for k in keys),
          f"3v {form} machines {machines}: " + " ".join(f"{k} {r[k]}" for k in keys)
          + " against one machine's " + " ".join(f"{k} {one[k]}" for k in keys))
    check(same, f"3v {form} machines {machines}: " + ", ".join(
        f"{k} {float((r[k] - one[k]).abs().max())}" for k in fields) + " from one machine's")


def one_device_coupled_hour(seed: int, dev, n: int) -> dict:
    """Phase 3e's coupled storm hour on one device, graph-driven on the
    card (eager on the CPU): the reference of 3v (iv) (phase 3e gives it in
    ``main``, with its eager hour's reads): its inputs, h and T on the
    host, its counts, MBRs and host reads."""
    from criteria3d_tpu_torch.bench import coupled_heat_mbr
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.problems import build_coupled_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import coupled as CP
    params = mesh_form_params("coupled")
    inputs = build_coupled_problem(
        synthetic_catchment(seed, n=n, radius=n * 366.0 / 768), 4.0, params, dev)
    CP.reset_counts()
    host_read.count = 0
    w, h = CP.compute_period_coupled(inputs[0], params, *inputs[1:], 3600.0)
    eager = _mesh_driver(None, inputs[0].device) == "eager"
    return dict(inputs=[x.to("cpu") for x in inputs], h=w.h.to("cpu"),
                t=h.t.to("cpu"), counts=CP.counts(), reads=host_read.count,
                mbr=float(w.balance_whole.mbr),
                heat_mbr=coupled_heat_mbr(inputs[0], params, w, h),
                eager_reads=host_read.count if eager else None)


def mesh_coupled_hour(card: str, dev, ref: dict, mesh) -> dict:
    """3v (iv): phase 3e's coupled storm hour partitioned over ``mesh``
    (grid, water, heat and boundary cut from the host by ``shard_pytree``,
    the whole coupled step on the blocks, the result joined by
    ``gather_pytree``) against the one-device hour ``ref``: water stats,
    chunks, sub-steps, heat sweeps, host reads, wall, bundle launches (0),
    the graph machine's launches and capture seconds, water and heat MBR,
    the gaps of h and T, the peak memory. |water MBR| < 2e-3, the heat MBR
    finite. Graph-driven on one card's blocks, or in rounds on a mesh whose
    blocks several machines run (one a card, or ``make_mesh``'s
    ``machines``), each captured by a zero-length period first, against
    the graph-driven one-device hour: every count and the water MBR equal,
    the heat MBR within rel 1e-8 (its balance adds the blocks' partials in
    another order), h and T bit-equal; host reads at most 5 % of the eager
    one-device hour's (graph) or at most the batches of rounds plus 3
    (rounds). The eager driver (the CPU's one machine) against the eager
    one-device hour: the same host reads; h and T within 1e-5 when every
    count is equal, else within the float32 envelopes (h: max 0.1 m, median
    1e-2 m, tests/test_fast_f32.py; T 0.2 K, JAX's sharded-vs-single bar,
    tests/test_sharding.py). The result holds h and T on the host."""
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    grid = ref["inputs"][0]
    from criteria3d_tpu_torch.parallel.sharding import machine_groups
    driver = _mesh_driver(mesh)
    on_card = torch_device_type(mesh.home) == "cuda"
    params = mesh_form_params("coupled", mesh)
    device_loop.clear()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    blocked = [shard_pytree(x, mesh) for x in ref["inputs"]]
    _sync_mesh(mesh)
    parts = dict(shard=time.time() - t0)
    device_loop.reset_counts()
    t0 = time.time()
    CP.compute_period_coupled(blocked[0], params, *blocked[1:], 0.0)
    _sync_mesh(mesh)
    parts["capture"] = time.time() - t0
    capture_s = device_loop.counts()["capture_s"]
    CP.reset_counts()
    device_loop.reset_counts()
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    t0 = time.time()
    w, h = CP.compute_period_coupled(blocked[0], params, *blocked[1:], 3600.0)
    _sync_mesh(mesh)
    wall = time.time() - t0
    counts, reads, launches = CP.counts(), host_read.count, JB.jacobi_bundle.launches
    drv = device_loop.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    del blocked
    device_loop.clear()
    t0 = time.time()
    w, h = gather_pytree(w, "cpu"), gather_pytree(h, "cpu")
    parts["gather"] = time.time() - t0
    mbr = float(w.balance_whole.mbr)
    heat_mbr = heat_outcome("3v coupled", grid, mesh_form_params("coupled"), w, h)[0]
    heat_mask = grid.mask.clone()
    heat_mask[0] = False
    dh = (w.h - ref["h"]).abs()[grid.mask]
    dt = (h.t - ref["t"]).abs()[heat_mask]
    dh_max, dh_median = float(dh.max()), float(dh.median())
    dt_max, dt_median = float(dt.max()), float(dt.median())
    same = torch.equal(w.h, ref["h"]) and torch.equal(h.t, ref["t"])
    stats = tuple(counts[k] for k in ("steps", "attempts", "approximations",
                                      "inner_iterations"))
    print(f"# 3v coupled storm hour partitioned, {mesh.shape} blocks on "
          f"{sorted({str(d) for d in mesh.devices.flat})} in machines "
          f"{machine_groups(mesh)} ({card}), {driver} driver ({drv['launches']} graph "
          f"launches, rounds {drv['rounds']} (enqueued {drv['rounds_enqueued']}), capture "
          f"{capture_s} s): water stats {stats}; "
          f"heat chunks {counts['chunks']}, sub-steps accepted "
          f"{counts['substeps_accepted']} rejected {counts['substeps_rejected']}, heat "
          f"sweeps {counts['heat_sweeps']} (one device {ref['counts']}); host reads "
          f"{reads} (one device {ref['reads']}, eager {ref['eager_reads']}); wall {wall} s; "
          f"peak memory {peak} GiB; bundle launches {launches}; water whole-period MBR "
          f"{mbr} (one device {ref['mbr']}), heat MBR {heat_mbr} (one device "
          f"{ref['heat_mbr']}); against the one-device hour: h and T bit-equal {same}, h max "
          f"{dh_max} m, median {dh_median} m; T max {dt_max} K, median {dt_median} K",
          flush=True)
    check(abs(mbr) < 2e-3, f"3v coupled: |water whole-period MBR| {mbr} >= 2e-3")
    check(math.isfinite(heat_mbr), f"3v coupled: heat MBR {heat_mbr} is not finite")
    check(launches == 0, f"3v coupled: {launches} bundle launches")
    if driver in ("graph", "rounds"):
        check(drv[f"{driver}_periods"] == 1 and drv["eager_periods"] == 0,
              f"3v coupled: the partitioned hour did not run {driver}-driven ({drv})")
        check(counts == ref["counts"] and mbr == ref["mbr"]
              and abs(heat_mbr - ref["heat_mbr"]) <= 1e-8 * abs(ref["heat_mbr"]),
              f"3v coupled: counts {counts}, MBRs {mbr} / {heat_mbr} against the one "
              f"device's {ref['counts']}, {ref['mbr']} / {ref['heat_mbr']}")
        check(same, f"3v coupled: h {dh_max} m and T {dt_max} K from the one-device hour's")
        if driver == "rounds":
            check_rounds("3v coupled", reads, drv)
        elif ref["eager_reads"]:
            check(reads <= 0.05 * ref["eager_reads"], f"3v coupled: {reads} host reads, "
                  f"more than 5 % of the eager hour's {ref['eager_reads']}")
    else:
        check(reads == ref["eager_reads"], f"3v coupled: {reads} host reads, the "
                                           f"one-device hour {ref['eager_reads']}")
        if counts == ref["counts"]:
            check(dh_max <= 1e-5 and dt_max <= 1e-5,
                  f"3v coupled: equal counts, h {dh_max} m and T {dt_max} K apart")
        else:
            check(dh_max < 0.1 and dh_median < 1e-2 and dt_max <= 0.2,
                  f"3v coupled: h {dh_max} m (median {dh_median}), T {dt_max} K outside "
                  "the float32 envelopes")
    return dict(stats=stats, counts=counts, mbr=mbr, heat_mbr=heat_mbr, wall_s=wall,
                host_reads=reads, launches=launches, graph_launches=drv["launches"],
                rounds=drv["rounds"], rounds_enqueued=drv["rounds_enqueued"],
                capture_s=capture_s, peak_gib=peak, driver=driver, dh_max=dh_max,
                dt_max=dt_max, parts=parts, h=w.h, t=h.t)


def _sync_mesh(mesh) -> None:
    for dev in {str(d) for d in mesh.devices.flat}:
        _sync(dev)


def mesh_cards(seed: int, card: str, n: int = 768) -> dict:
    """3v on a host with several cards (``main`` needs one and does not run
    it): the mesh of one block per card (``make_mesh()``): the mesh loop on
    phase 2's inputs against one card; each storm hour (MESH_FORMS)
    graph-driven on one card, whole and on 2 x 2 blocks (one machine), and
    partitioned over the cards, one machine a card in rounds: stats, MBR
    and launches equal, heads bit-equal to the one card's 2 x 2 hour, host
    reads at most the rounds' batches plus 3; each card's peak memory of
    the bundle hour over the cards at most 0.35 of the one-card whole
    hour's (nothing whole lives on a card: the grid and state are cut from
    the host); the coupled hour (:func:`mesh_cards_coupled`, in rounds
    over the cards as well); and the scaling bench's line, whose mesh leg
    takes one block per card."""
    import torch
    from criteria3d_tpu_torch import scaling_bench
    from criteria3d_tpu_torch.parallel.sharding import make_mesh
    from criteria3d_tpu_torch.solver import device_loop
    check(torch.cuda.device_count() > 1, "mesh_cards needs more than one card")
    mesh = make_mesh()
    cards = torch.cuda.device_count()
    peer = [[torch.cuda.can_device_access_peer(a, b) for b in range(cards) if b != a]
            for a in range(cards)]
    print(f"# 3v mesh over {cards} cards: peer access {peer} ({card})", flush=True)
    loops = mesh_loops(seed, "cuda", n, [mesh])
    torch.cuda.empty_cache()
    hours, one_peak = {}, None
    for form in MESH_FORMS:
        torch.cuda.synchronize(0)
        torch.cuda.reset_peak_memory_stats(0)
        ref = one_device_hour(form, seed, "cuda:0", n)
        torch.cuda.synchronize(0)
        if form == "bundle":
            one_peak = torch.cuda.max_memory_allocated(0)
        device_loop.clear()
        torch.cuda.empty_cache()
        two = mesh_hour(form, card, "cuda", ref, virtual_mesh(4, "cuda:0"))
        torch.cuda.empty_cache()
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        over = mesh_hour(form, card, "cuda", ref, mesh)
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(cards)]
        same = torch.equal(over["h"], two["h"])
        print(f"# 3v {form} storm hour over {cards} cards ({over['driver']} driver): wall "
              f"{over['wall_s']} s host reads {over['host_reads']} graph launches "
              f"{over['graph_launches']} rounds {over['rounds']} (enqueued "
              f"{over['rounds_enqueued']}) capture {over['capture_s']} s; "
              f"one card's 2 x 2 hour {two['wall_s']} s ({two['driver']}); heads bit-equal to "
              f"it {same}; each card's peak {[p / 2**30 for p in peaks]} GiB ({card})",
              flush=True)
        check(over["driver"] == "rounds", f"3v {form} over the cards: {over['driver']} driver")
        check(over["stats"] == two["stats"] and over["mbr"] == two["mbr"]
              and over["launches"] == two["launches"] and same,
              f"3v {form} over the cards: stats {over['stats']} MBR {over['mbr']} launches "
              f"{over['launches']} against the one card's 2 x 2 hour's {two['stats']} "
              f"{two['mbr']} {two['launches']}, heads bit-equal {same}")
        over["peaks"] = peaks
        over["one_card_2x2_wall_s"] = two["wall_s"]
        if form == "bundle":
            shares = [p / one_peak for p in peaks]
            print(f"# 3v bundle storm hour: one card's peak {one_peak / 2**30} GiB; over "
                  f"{cards} cards, each card's shares {shares} ({card})", flush=True)
            check(max(shares) <= 0.35, f"3v: a card's peak is {max(shares)} of the "
                                       "one-card hour's, above 0.35")
            over["shares"] = shares
        for r in (over, two):
            r.pop("h")
        hours[form] = over
        del ref, two
        device_loop.clear()
        torch.cuda.empty_cache()
    coupled = mesh_cards_coupled(seed, card, n, mesh)
    scaling = scaling_bench.scaling(n, n, mesh.devices.size, "cuda")
    print(json.dumps(scaling), flush=True)
    return dict(loops=loops, hours=hours, one_card_peak=one_peak, peer=peer,
                coupled=coupled, scaling=scaling)


def mesh_cards_coupled(seed: int, card: str, n: int = 768, mesh=None) -> dict:
    """3v (iv) with one block per card (``make_mesh()`` when ``mesh`` is
    None): phase 3e's coupled storm hour graph-driven on one card, whole
    (:func:`one_device_coupled_hour`, with its peak memory) and on 2 x 2
    blocks (one machine), then partitioned over the cards, one machine a
    card in rounds (each :func:`mesh_coupled_hour` against the whole
    hour): the hour over the cards with every count and both MBRs equal to
    the one card's 2 x 2 hour's, h and T bit-equal to it, host reads at
    most the batches of rounds plus 3, each card's peak memory at most
    0.35 of the one-card whole hour's."""
    import torch
    from criteria3d_tpu_torch.parallel.sharding import make_mesh
    from criteria3d_tpu_torch.solver import device_loop
    check(torch.cuda.device_count() > 1, "mesh_cards_coupled needs more than one card")
    mesh = mesh or make_mesh()
    torch.cuda.synchronize(0)
    torch.cuda.reset_peak_memory_stats(0)
    ref = one_device_coupled_hour(seed, "cuda:0", n)
    torch.cuda.synchronize(0)
    one_peak = torch.cuda.max_memory_allocated(0)
    device_loop.clear()
    torch.cuda.empty_cache()
    two = mesh_coupled_hour(card, "cuda", ref, virtual_mesh(4, "cuda:0"))
    torch.cuda.empty_cache()
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    over = mesh_coupled_hour(card, "cuda", ref, mesh)
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count())]
    shares = [p / one_peak for p in peaks]
    same = torch.equal(over["h"], two["h"]) and torch.equal(over["t"], two["t"])
    print(f"# 3v coupled storm hour over {mesh.devices.size} cards ({over['driver']} driver): "
          f"wall {over['wall_s']} s host reads {over['host_reads']} graph launches "
          f"{over['graph_launches']} rounds {over['rounds']} (enqueued "
          f"{over['rounds_enqueued']}) capture {over['capture_s']} s; one card whole "
          f"{ref['reads']} reads, peak {one_peak / 2**30} GiB; one card's 2 x 2 hour "
          f"{two['wall_s']} s ({two['driver']}); h and T bit-equal to it {same}; each card's "
          f"peak {[p / 2**30 for p in peaks]} GiB, shares {shares} ({card})", flush=True)
    check(over["driver"] == "rounds", f"3v coupled over the cards: {over['driver']} driver")
    check(all(over[k] == two[k] for k in ("counts", "mbr", "heat_mbr")) and same,
          f"3v coupled over the cards: counts {over['counts']} MBRs {over['mbr']} / "
          f"{over['heat_mbr']} against the one card's 2 x 2 hour's {two['counts']} "
          f"{two['mbr']} / {two['heat_mbr']}, h and T bit-equal {same}")
    check(max(shares) <= 0.35, f"3v coupled: a card's peak is {max(shares)} of the "
                               "one-card hour's, above 0.35")
    for r in (over, two):
        del r["h"], r["t"]
    del ref
    device_loop.clear()
    torch.cuda.empty_cache()
    return dict(hour=over, one_card_2x2=two, one_card_peak=one_peak, peaks=peaks,
                shares=shares)


# 3x (vi): graph against eager on the same 2 x 2 blocks at a small box:
# the box of the 600 s f64 water machine whose units run one by one, the
# coupled period's valley (test_torch_cuda.py's) and that period's length
# [s], half an hour
MESH_GRAPH_BOX = 64
MESH_GRAPH_VALLEY = 32
MESH_GRAPH_PERIOD = 1800.0


def valley_box(n: int):
    """test_torch_cuda.py's coupled valley: an n x n DEM sloping down the
    rows, a V across the columns (10 m cells)."""
    import numpy as np
    rows, cols = np.mgrid[0:n, 0:n]
    return 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8


def _mesh_run(run, eager: bool, on_card: bool) -> dict:
    """``run()`` with every count set to 0 before it (the drivers' kept
    machines dropped) and read after, under the graph or the eager driver:
    its result, host reads, bundle launches, the drivers' counts and the
    peak memory [GiB]."""
    import contextlib
    import torch
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    device_loop.clear()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    device_loop.reset_counts()
    CP.reset_counts()
    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    t0 = time.time()
    with device_loop.forced_eager() if eager else contextlib.nullcontext():
        out = run()
    if on_card:
        torch.cuda.synchronize()
    res = dict(out=out, wall_s=time.time() - t0, reads=host_read.count,
               launches=JB.jacobi_bundle.launches, drivers=device_loop.counts(),
               counts=CP.counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0)
    device_loop.clear()
    return res


def units_make_no_sync(label: str, machine, on_card: bool) -> set:
    """Every unit of ``machine`` (loaded) run in turn to DONE, each under
    ``torch.cuda.set_sync_debug_mode("error")`` on the card (a host
    synchronisation inside a unit raises); the status read between units.
    Returns the phases run."""
    import torch
    from criteria3d_tpu_torch.device import host_array
    units, seen = machine.units(), set()
    status = host_array(machine.status)
    while status[0] != machine.DONE:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            units[int(status[0])][1]()
        except RuntimeError as e:
            fail(f"{label}: unit {units[int(status[0])][0]!r} synchronised with the "
                 f"host ({e})")
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        seen.add(int(status[0]))
        status = host_array(machine.status)
    return seen


def mesh_graph_vs_eager(card: str, dev="cuda") -> dict:
    """Phase 3x (vi): the frozen coupled storm period (MESH_GRAPH_PERIOD)
    on 2 x 2 blocks of the MESH_GRAPH_VALLEY valley of ``dev``, graph-driven
    against eager-driven on the same blocks: every count, both MBRs and
    bundle launches equal, h and T bit-equal; on the card the graph driver
    ran, its host reads at most 5 % of the eager period's, its peak at
    most 2 x. Then every unit of a 600 s f64 water machine on 2 x 2 blocks
    of a MESH_GRAPH_BOX box (its ring-refresh unit among them) and a 600 s
    coupled machine on the valley's blocks runs under
    ``set_sync_debug_mode("error")``: no host synchronisation inside a
    unit. (The water forms' graph-driven hours on blocks are held to the
    one-device hours in 3v at full size; their eager twins on blocks run in
    tests/test_torch_cuda.py.)"""
    import torch
    from criteria3d_tpu_torch.bench import coupled_heat_mbr
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.problems import (build_coupled_problem, build_problem,
                                               synthetic_catchment)
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import step as TSt
    on_card = torch_device_type(dev) == "cuda"
    mesh = virtual_mesh(4, dev)
    out = {}
    n = MESH_GRAPH_BOX
    whole = mesh_form_params("coupled")
    params = mesh_form_params("coupled", mesh)
    inputs = build_coupled_problem(valley_box(MESH_GRAPH_VALLEY), 10.0, whole, dev)
    blocked = [shard_pytree(x, mesh) for x in inputs]
    g, e = (_mesh_run(lambda: CP.compute_period_coupled(blocked[0], params, *blocked[1:],
                                                        MESH_GRAPH_PERIOD), eager,
                          on_card)
            for eager in (False, True))
    (gw, gt), (ew, et) = ([gather_pytree(x, "cpu") for x in r["out"]] for r in (g, e))
    gmbr = (float(gw.balance_whole.mbr), coupled_heat_mbr(inputs[0].to("cpu"), whole, gw, gt))
    embr = (float(ew.balance_whole.mbr), coupled_heat_mbr(inputs[0].to("cpu"), whole, ew, et))
    ratio = g["reads"] / max(e["reads"], 1)
    same = torch.equal(gw.h, ew.h) and torch.equal(gt.t, et.t)
    print(f"# 3x coupled {MESH_GRAPH_PERIOD} s on 2 x 2 blocks of the {MESH_GRAPH_VALLEY} "
          f"valley ({card}): "
          f"graph counts {g['counts']} MBRs {gmbr} wall {g['wall_s']} s host reads "
          f"{g['reads']} graph launches {g['drivers']['launches']} capture "
          f"{g['drivers']['capture_s']} s peak {g['peak_gib']} GiB; eager counts "
          f"{e['counts']} MBRs {embr} wall {e['wall_s']} s host reads {e['reads']} peak "
          f"{e['peak_gib']} GiB; reads graph / eager {ratio}; h and T bit-equal {same}",
          flush=True)
    check(g["counts"] == e["counts"] and gmbr == embr and g["launches"] == e["launches"] == 0,
          f"3x coupled on blocks: graph {g['counts']} {gmbr}, eager {e['counts']} {embr}")
    check(same, "3x coupled on blocks: h or T differ between the drivers")
    check(g["counts"]["heat_sweeps"] > 0, "3x coupled on blocks: no heat sweep")
    if on_card:
        check(g["drivers"]["graph_periods"] == 1 and e["drivers"]["eager_periods"] == 1,
              f"3x coupled on blocks: drivers {g['drivers']} / {e['drivers']}")
        check(ratio <= 0.05, f"3x coupled on blocks: graph reads {g['reads']} > 5 % of "
                             f"eager {e['reads']}")
        check(g["peak_gib"] <= 2.0 * e["peak_gib"],
              f"3x coupled on blocks: graph peak {g['peak_gib']} > 2 x {e['peak_gib']}")
    out["coupled"] = dict(counts=g["counts"], graph_reads=g["reads"], eager_reads=e["reads"],
                          graph_wall_s=g["wall_s"], eager_wall_s=e["wall_s"],
                          graph_peak_gib=g["peak_gib"], eager_peak_gib=e["peak_gib"],
                          capture_s=g["drivers"]["capture_s"],
                          graph_launches=g["drivers"]["launches"])
    del g, e
    # every unit on the blocks without a host synchronisation
    p64 = mesh_form_params("f64", mesh)
    grid, state = build_problem(synthetic_catchment(0, n=n, radius=n * 30.0 / 64), 4.0,
                                mesh_form_params("f64"), dev)
    grid, state = shard_pytree(grid, mesh), shard_pytree(state, mesh)
    m = TSt._Machine(grid, p64, state, False)
    m.load(state, 600.0, 0.0)
    seen = units_make_no_sync("3x f64 on blocks", m, on_card)
    check(TSt.X_EXCHANGE in seen, "3x: the f64 machine on blocks refreshed no ring")
    mc = CP._CoupledMachine(blocked[0], params, *blocked[1:], False, 256)
    mc.load(*blocked[1:], 600.0)
    seen_c = units_make_no_sync("3x coupled on blocks", mc, on_card)
    check({CP.SWEEP, CP.H_EXCHANGE, CP.SUBSTEP_END} <= seen_c,
          "3x: the coupled machine on blocks refreshed no heat ring")
    print(f"# 3x units on 2 x 2 blocks ({card}): {len(seen)} f64 and {len(seen_c)} coupled "
          f"unit kinds run under set_sync_debug_mode('error'), no host synchronisation",
          flush=True)
    return out


def mesh_phases(seed: int, card: str, dev="cuda", n: int = 768, refs=None) -> dict:
    """Phase 3v (the device mesh: the halo exchange, the mesh loop against
    the single-device loop, the three storm hours partitioned over 2 x 2
    blocks of the card, graph-driven, the scaling bench's line, and phase
    3e's coupled hour partitioned over 2 x 2 blocks, graph-driven; the
    storm hours and the coupled hour on the same blocks split into
    machines, and 3x (v)'s bundle-form coupled hour in machines, in rounds
    in a process of their own) and (3x (vi)) the partitioned hours graph
    against eager on the same blocks at a small box; returns what it
    measured. ``refs`` maps each of MESH_FORMS and "coupled" to its
    graph-driven one-device hour (phases 3-3c's and 3e's; run here when
    None). ``dev="cpu"`` with a small ``n`` rehearses it on the CPU (the
    eager driver and the rounds driver's threads; no times, no
    launches)."""
    from criteria3d_tpu_torch import scaling_bench
    t0 = time.time()
    parts = {}

    def lap(name):
        nonlocal t0
        parts[name] = time.time() - t0
        t0 = time.time()
    start = t0
    mesh_halo(seed, dev, n)
    lap("halo")
    loops = mesh_loops(seed, dev, n)
    lap("loops")
    mesh = virtual_mesh(4, dev)
    refs = dict(refs or {})
    for form in MESH_FORMS:
        if form not in refs:
            refs[form] = one_device_hour(form, seed, dev, n)
    if "coupled" not in refs:
        refs["coupled"] = one_device_coupled_hour(seed, dev, n)
    lap("one-device hours")
    split = machines_hours(refs, card, dev, n)
    lap("machines (a process of their own)")
    hours = {}
    for form in MESH_FORMS:
        hours[form] = mesh_hour(form, card, dev, refs[form], mesh)
        for machines, r in split[form].items():
            check_machines_hour(form, card, machines, r, hours[form])
            r.pop("h")
        hours[form]["machines"] = split[form]
        hours[form].pop("h")
        lap(f"{form} partitioned")
    scaling = scaling_bench.scaling(n, n, 4, dev)
    print(json.dumps(scaling), flush=True)
    lap("scaling")
    hours["coupled"] = mesh_coupled_hour(card, dev, refs["coupled"], mesh)
    for machines, r in split["coupled"].items():
        check_machines_hour("coupled", card, machines, r, hours["coupled"])
        del r["h"], r["t"]
    hours["coupled"]["machines"] = split["coupled"]
    del hours["coupled"]["h"], hours["coupled"]["t"]
    lap("coupled partitioned")
    small = mesh_graph_vs_eager(card, dev)
    lap("graph vs eager on blocks")
    seconds = time.time() - start
    print(f"# phase 3v took {seconds} s ({card}): " + "; ".join(
        f"{k} {v} s" for k, v in parts.items()) + "; within the partitioned hours: "
        + "; ".join(f"{form} wall {h['wall_s']} s " + " ".join(
            f"{k} {v} s" for k, v in h["parts"].items()) for form, h in hours.items()),
        flush=True)
    return dict(loops=loops, hours=hours, scaling=scaling, small=small, seconds=seconds,
                parts=parts, bundle_coupled=split["bundle_coupled"])


def mesh_busy(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """The idle share of the graph-driven storm hours (MESH_FORMS) and of
    phase 3e's coupled storm hour on 2 x 2 blocks of the card (``main``
    does not run it): each hour's machine captured by a zero-length
    period, the hour run twice graph-driven (the second run of the kept
    machine bit-equal to the first; the wall is the second's), then once
    eager-driven under torch.profiler for its device busy time
    (:func:`breakdown`; the profiler does not see the kernels inside the
    machine's conditional nodes, so a graph-driven run's busy time is not
    measured), the idle share 1 - busy / graph wall. Returns, per form, the
    walls, busy seconds and idle share."""
    import torch
    from criteria3d_tpu_torch.parallel.sharding import gather_pytree, shard_pytree
    from criteria3d_tpu_torch.problems import (build_coupled_problem, build_problem,
                                               synthetic_catchment)
    from criteria3d_tpu_torch.solver import coupled as CP
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    dem = synthetic_catchment(seed, n=n, radius=n * 366.0 / 768)
    mesh = virtual_mesh(4, dev)
    out = {}
    for form in MESH_FORMS + ("coupled",):
        if form == "coupled":
            host = build_coupled_problem(dem, 4.0, mesh_form_params(form), "cpu")
        else:
            host = build_problem(dem, 4.0, mesh_form_params(form), "cpu")
        params = mesh_form_params(form, mesh)
        inputs = [shard_pytree(x, mesh) for x in host]

        def run(period=3600.0):
            if form == "coupled":
                return CP.compute_period_coupled(inputs[0], params, *inputs[1:], period)
            return compute_period_stats(inputs[0], params, inputs[1], period)
        device_loop.clear()
        torch.cuda.empty_cache()
        run(0.0)
        walls, heads = [], []
        for _ in range(2):
            _sync(dev)
            t0 = time.time()
            res = run()
            _sync(dev)
            walls.append(time.time() - t0)
            heads.append(gather_pytree(res[0].h, "cpu"))
            del res
        device_loop.clear()
        check(torch.equal(heads[0], heads[1]),
              f"{form} on 2 x 2 blocks: the kept machine's second run differs from its first")
        with device_loop.forced_eager():
            busy, _, _ = breakdown(f"{form} storm hour on 2 x 2 blocks, eager-driven", run,
                                   walls[1])
        out[form] = dict(graph_walls_s=walls, busy_s=busy,
                         idle_share=1.0 - busy / walls[1] if busy else None)
        del inputs, heads
    print(f"# graph-driven storm hours on 2 x 2 blocks ({card}): " + "; ".join(
        f"{form}: walls {v['graph_walls_s']} s (the kept machine's second run bit-equal to "
        f"its first), eager-profiled busy {v['busy_s']} s, idle share {v['idle_share']}"
        for form, v in out.items()), flush=True)
    return out


def mesh_rounds_busy(seed: int, card: str, mesh=None, n: int = 768) -> dict:
    """The idle share of each storm hour (MESH_FORMS) under the rounds
    driver on ``mesh`` (one block a card, ``make_mesh()``, when None; or a
    grouping of one card's blocks), which ``main`` does not run: each
    hour captured by a zero-length period and run once for its wall, all
    of them before any profiling (a profiled run slows the launches after
    it in the same process); then each once more under torch.profiler:
    each card's busy time (the union of its device activities: the
    profiler sees the kernels inside the machines' segment graphs) and
    idle share 1 - busy / the unprofiled wall. Returns, per form, the
    wall, host reads, busy seconds and idle shares per card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from criteria3d_tpu_torch.device import host_read
    from criteria3d_tpu_torch.parallel.sharding import make_mesh, shard_pytree
    from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
    from criteria3d_tpu_torch.solver import device_loop
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    from criteria3d_tpu_torch.utils.profiling import busy_by_device
    mesh = mesh or make_mesh()
    check(_mesh_driver(mesh) == "rounds", f"mesh_rounds_busy: {mesh.shape} runs no rounds")
    dem = synthetic_catchment(seed, n=n, radius=n * 366.0 / 768)
    device_loop.clear()
    runs, out = {}, {}
    for form in MESH_FORMS:
        grid, state = (shard_pytree(x, mesh)
                       for x in build_problem(dem, 4.0, mesh_form_params(form), "cpu"))
        params = mesh_form_params(form, mesh)
        compute_period_stats(grid, params, state, 0.0)
        _sync_mesh(mesh)
        host_read.count = 0
        t0 = time.time()
        _, stats = compute_period_stats(grid, params, state, 3600.0)
        _sync_mesh(mesh)
        runs[form] = (grid, params, state)
        out[form] = dict(stats=tuple(stats), wall_s=time.time() - t0,
                         host_reads=host_read.count)
    for form, (grid, params, state) in runs.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            compute_period_stats(grid, params, state, 3600.0)
            _sync_mesh(mesh)
        busy = busy_by_device(prof)
        r = out[form]
        r.update(busy_s=busy, idle_share={c: 1.0 - b / r["wall_s"] for c, b in busy.items()})
        print(f"# {form} storm hour in rounds on {mesh.shape} blocks of "
              f"{sorted({str(d) for d in mesh.devices.flat})} ({card}): stats {r['stats']} "
              f"wall {r['wall_s']} s host reads {r['host_reads']}; each card's busy {busy} s, "
              f"idle share {r['idle_share']}", flush=True)
        check(busy and all(b > 0 for b in busy.values()),
              f"{form}: the profiler saw no device activity in the rounds")
    device_loop.clear()
    return out


# ----------------------------------------------------------------------
# the water period as CUDA graphs against the eager driver (3x)
# ----------------------------------------------------------------------

GRAPH_FORMS = (("bundle", "bundle hour"), ("cg_line", "CG line hour"), ("f64", "f64 hour"))


def graph_control_ms() -> tuple:
    """The graph machine's control cost per unit against the eager
    driver's, on the card: a small hour graph-driven keeps its machine; with
    the phase set to a code that names no unit, one launch runs
    ``UNITS_PER_LAUNCH`` empty units (CUDA events, per unit); the eager
    driver's per-unit cost is one host read of the machine's status (CUDA
    events around back-to-back reads)."""
    import torch
    from criteria3d_tpu_torch.bench_jacobi import cuda_ms
    from criteria3d_tpu_torch.device import host_array
    from criteria3d_tpu_torch.problems import SMALL_CONFIGS, small_hour
    from criteria3d_tpu_torch.solver import device_loop
    device_loop.clear()
    small_hour(SMALL_CONFIGS["cg_line"][0](), "cuda")
    gm = next(iter(device_loop._cache.values()))
    m = gm.machine
    stream = torch.cuda.current_stream().cuda_stream
    m.status[0].fill_(max(m.units()) + 1)
    ms = cuda_ms(lambda: gm.lib.c3d_machine_launch(gm.exec, stream), reps=5,
                 batches=3) / device_loop.UNITS_PER_LAUNCH
    plain_ms = cuda_ms(lambda: host_array(m.status), reps=200, batches=3)
    device_loop.clear()
    return ms, plain_ms


def coupled_graph_phase(label, grid, params, on_card: bool) -> dict:
    """Phase 3x (iv) on its own: the bench's coupled leg on ``grid``
    (graph-driven on the card, one run after the capture) against the same
    hour eager-driven and profiled (``trace_coupled.traced_hour``), held to
    each other by :func:`coupled_graph_vs_eager`."""
    from criteria3d_tpu_torch import bench, trace_coupled
    from criteria3d_tpu_torch.solver import device_loop
    cp = bench.coupled_leg(grid, params, {}, max_runs=1)
    w, h = cp.pop("out")
    hparams, hgrid = cp["inputs"][:2]
    graph = dict(counts=cp["counts"], syncs=cp["host_reads"], wall_s=cp["wall_s"],
                 peak_gib=cp["peak_gib"], mbr=cp["mbr"], heat_mbr=cp["heat_mbr"],
                 h=w.h.to("cpu"), t=h.t.to("cpu"), launches=cp["launches"],
                 driver=cp["driver"], capture_s=cp["capture_s"],
                 graph_launches=cp["graph_launches"])
    del w, h
    device_loop.clear()
    trace = trace_coupled.traced_hour(cp.pop("inputs"), cp["wall_s"])
    out = coupled_graph_vs_eager(label, graph, eager_coupled(trace, hgrid, hparams),
                                 on_card)
    out["graph_launches"] = graph["graph_launches"]
    return out


def graph_phases(seed: int, card: str, dev="cuda", n: int = 768) -> dict:
    """Phase 3x on its own (``main`` runs it inside phases 3-3c, 3d, 3e and
    3f): the storm hour of the n x n synthetic catchment in the three forms
    of the main path (the bundle, CG line, float64), graph-driven through
    the bench's storm leg (one run, after the capture) and eager-driven
    (:func:`eager_hour`), held to each other by :func:`graph_vs_eager`;
    (iv) the coupled storm hour of phase 3e the same way
    (:func:`coupled_graph_phase`); (v) the bundle-form coupled hour
    (:func:`bundle_coupled_graph_vs_eager`, on a box of n / 16 at most 48);
    3f (ii)'s float32 exact-mode periods (:func:`exact_f32_coupled`); then
    on the card 3d's locked-dt hours, graph-driven, against the CPU.
    Returns each form's numbers. ``dev="cpu"`` with a small ``n``
    rehearses it on the CPU, where both hours run the eager driver."""
    import torch
    from criteria3d_tpu_torch import bench
    from criteria3d_tpu_torch.problems import (SMALL_CONFIGS, catchment_grid,
                                               synthetic_catchment)
    from criteria3d_tpu_torch.solver import device_loop
    start = time.time()
    on_card = torch_device_type(dev) == "cuda"
    dem = synthetic_catchment(seed, n=n, radius=n * 366.0 / 768)
    grid = catchment_grid(dem, 4.0, dev)
    out = {}
    for form, label in GRAPH_FORMS:
        params = mesh_form_params(form)
        sl = bench.storm_leg(grid, params, 1)
        ev = eager_hour(label, grid, params, sl["wall_s"])
        out[form] = graph_vs_eager(label, sl, ev, on_card)
        del sl, ev
        device_loop.clear()
    out["coupled"] = coupled_graph_phase("coupled hour", grid,
                                         mesh_form_params("cg_line"), on_card)
    out["bundle_coupled"] = bundle_coupled_graph_vs_eager(card, dev, min(48, max(n // 16, 16)))
    out["exact_f32"] = exact_f32_coupled(card, dev)
    if on_card:
        for name in SMALL_CONFIGS:
            small_card_vs_cpu(name)
    out["seconds"] = time.time() - start
    print(f"# phase 3x took {out['seconds']} s ({card})", flush=True)
    return out


# ----------------------------------------------------------------------
# the port's bench (3w): the legs that no other phase runs
# ----------------------------------------------------------------------

# 3w (i): the day leg's coarsen level (bench.py's BENCH_DAY_COARSEN
# default) and its hours: the storm's 3 (the day's drainage hours take
# minutes on the card, at coarsen 16 as at 4)
BENCH_DAY_COARSEN = 4
BENCH_DAY_HOURS = 3


def bench_phases(seed: int, card: str, dev="cuda", n: int = 768, refs=None,
                 trace=None) -> dict:
    """Phase 3w, the legs of ``python -m criteria3d_tpu_torch.bench`` that
    phases 3b and 3e do not run: (i) the day leg at coarsen
    ``BENCH_DAY_COARSEN`` under ``fast_f32()``, its first
    ``BENCH_DAY_HOURS`` hours (the hour walls, the closing |MBR| < 2e-3,
    host reads); (ii) the mesh leg, the bundle hour on a (1,
    1) mesh at full size, graph-driven on the card, against the graph-driven
    one-device bundle hour (phase 3's in ``refs["bundle"]``, run here when
    None): the same stats and host reads, heads bit-equal, one launch a
    bundle; (iii) trace_coupled's roll-up of
    the coupled hour (phase 3e's ``trace``; ``trace_coupled.trace`` at
    coarsen 4 when None): its layers sum to its busy time. Returns what it
    measured. ``dev="cpu"`` with a small ``n`` rehearses it on the CPU (no
    device time: the roll-up is 0)."""
    import torch
    from criteria3d_tpu_torch import SolverParameters, bench, trace_coupled
    from criteria3d_tpu_torch.problems import synthetic_catchment
    from criteria3d_tpu_torch.solver.jacobi_bundle import SWEEPS_PER_BUNDLE as K
    start = t0 = time.time()
    parts = {}
    dem = bench.Dem(synthetic_catchment(seed, n=n, radius=n * 366.0 / 768), -9999.0,
                    4.0, f"synthetic_catchment(seed={seed})")
    day_grid = bench.build_grid(BENCH_DAY_COARSEN, dev, dem)
    day = bench.day_leg(day_grid, SolverParameters.fast_f32(), hours=BENCH_DAY_HOURS)
    del day["out"]
    walls = day["hour_walls_s"]
    print(f"# 3w day leg at coarsen {BENCH_DAY_COARSEN} ({day_grid.n_nodes} nodes, "
          f"{card}): {day['wall_s']} s for its first {BENCH_DAY_HOURS} hours; hour walls "
          f"{walls} s; host reads {day['host_reads']} ({sum(day['host_reads'])} in all); "
          f"closing MBR {day['mbr']}; peak memory {day['peak_gib']} GiB", flush=True)
    check(len(walls) == BENCH_DAY_HOURS, f"3w: the day ran {len(walls)} hours")
    check(abs(day["mbr"]) < 2e-3, f"3w: the day's closing |MBR| {day['mbr']} >= 2e-3")
    del day_grid
    parts["day"] = time.time() - t0
    t0 = time.time()
    ref = refs["bundle"] if refs else one_device_hour("bundle", seed, dev, n)
    ml = bench.mesh_leg(ref["grid"].to(dev))
    h = ml.pop("out").h.to("cpu")
    dh = float((h - ref["h"]).abs().max())
    print(f"# 3w mesh leg, {ml['mesh']} blocks on {dev} ({card}), {ml['driver']} driver"
          f"{': ' + ml['why'] if ml['why'] else ''} (capture {ml['capture_s']} s, "
          f"{ml['graph_launches']} graph launches): stats {ml['stats']} "
          f"(one device {ref['stats']}), whole-period MBR {ml['mbr']}, walls {ml['runs_s']} "
          f"s (median {ml['wall_s']}), host reads {ml['host_reads']} (one device "
          f"{ref['reads']}), bundle launches {ml['launches']}, peak memory "
          f"{ml['peak_gib']} GiB; heads against the one-device hour: max {dh} m",
          flush=True)
    check(tuple(ml["stats"]) == tuple(ref["stats"]),
          f"3w: the mesh leg gave stats {ml['stats']}, one device {ref['stats']}")
    check(torch.equal(h, ref["h"]), f"3w: the mesh leg's heads are {dh} m from one device's")
    # a (1, 1) mesh runs the one-device hour's units, so as many launches
    # and host reads (graph-driven on the card, eager on the CPU)
    check(ml["host_reads"] == ref["reads"], f"3w: the mesh leg read the host "
                                            f"{ml['host_reads']} times, one device {ref['reads']}")
    if torch_device_type(dev) == "cuda":
        check(ml["driver"] == "graph" and ml["graph_launches"] > 0,
              f"3w: the mesh leg ran the {ml['driver']} driver ({ml['why']})")
        check(ml["launches"] * K == ml["stats"][3],
              f"3w: {ml['launches']} launches for {ml['stats'][3]} sweeps")
    parts["mesh leg"] = time.time() - t0
    t0 = time.time()
    if trace is None:
        trace = trace_coupled.trace(4, dev, dem)
    layers, busy = trace["layers"], trace["busy_s"]
    layer_sum = sum(layers.values())
    print(f"# 3w coupled-trace roll-up ({card}): layers {layers} sum to {layer_sum} s "
          f"of {busy} s busy; the activities' durations {trace['durations_s']} s, "
          f"overlaps {trace['overlap_s']} s; a launch matched a range: "
          f"{trace['matched']}; idle share {trace['idle_share']}", flush=True)
    check(abs(layer_sum - busy) <= 1e-6 * busy,
          f"3w: the trace's layers sum to {layer_sum} s, its busy time is {busy} s")
    if torch_device_type(dev) == "cuda":
        # the attribution itself: launches found in the layers' ranges and
        # each water and heat layer with device time of its own; then the
        # durations less their overlaps (each activity's own part, as the
        # layers) against the busy union that roll_up merges apart
        check(trace["matched"], "3w: no launch of the traced hour matched a layer's range")
        for name in ("water assembly", "water inner solve", "heat assembly", "heat solve"):
            check(layers[name] > 0.0, f"3w: the trace's {name} layer holds no device time")
        check(layers["other"] < 0.5 * busy,
              f"3w: {layers['other']} s of {busy} s busy charged to no layer")
        check(abs(trace["durations_s"] - trace["overlap_s"] - busy) <= 1e-6 * busy,
              f"3w: durations {trace['durations_s']} s less overlaps "
              f"{trace['overlap_s']} s are not the busy {busy} s")
    parts["trace"] = time.time() - t0
    seconds = time.time() - start
    print(f"# phase 3w took {seconds} s ({card}): " + "; ".join(
        f"{k} {v} s" for k, v in parts.items()), flush=True)
    return dict(day=day, mesh=ml, trace=trace, seconds=seconds, parts=parts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--machines-hours", metavar="DIR",
                    help="run only 3v's hours in machines on the inputs saved in DIR "
                         "(the script starts this process itself)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from criteria3d_tpu_torch import SolverParameters
        from criteria3d_tpu_torch.bench_jacobi import cuda_ms
        from criteria3d_tpu_torch.problems import build_problem, synthetic_catchment
        from criteria3d_tpu_torch.solver import assemble_kernel as AK
        from criteria3d_tpu_torch.solver import device_loop
        from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    except ImportError as e:
        print(f"chip_smoke: the criteria3d_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    check("jax" not in sys.modules and "criteria3d_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.machines_hours:
        machines_hours_run(args.machines_hours, card_line(), "cuda")
        return 0
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t_start = time.time()

    # ---- 1. build ---------------------------------------------------------
    # one nvcc for each source, started together
    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda build: build(verbose=True),
                             (JB.build_library, device_loop.build_library,
                              AK.build_library)))
    print(f"# built {libs} in {time.time() - t0:.1f} s", flush=True)

    # ---- 2. kernel against plain version, on the card --------------------
    main_shape = (7, 768, 768)
    K = JB.SWEEPS_PER_BUNDLE
    TI, S = JB.plan_tiles(main_shape[0], K)
    err_main, _, inputs = compare_bundle(main_shape, args.seed)
    # the halo mode (the sharded loop's: K cells a side left out of the norm)
    err_halo, rel_halo, _ = compare_bundle(main_shape, args.seed, halo=K)
    for n, shape in enumerate([(5, 37, 45), (7, TI - 3, TI - 6),
                               (7, 2 * TI + 1, 3 * TI + 1)]):
        compare_bundle(shape, args.seed + 1 + n)
    x_t, n_t = JB.jacobi_bundle(*inputs)
    x_s, n_s = JB.jacobi_bundle_per_sweep(*inputs)
    torch.cuda.synchronize()
    check(torch.equal(x_t, x_s) and torch.equal(n_t, n_s),
          f"the tiled and the per-sweep designs differ at {main_shape}")
    print(f"# jacobi_bundle vs per-sweep design at {main_shape}: x and norm "
          f"bit-equal (norm {float(n_t)})", flush=True)
    del x_t, x_s
    print(f"# phases 1-2 done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 3. the main path at full size -----------------------------------
    params = SolverParameters.fast_f32(use_pallas=True)
    dem = synthetic_catchment(args.seed)
    t0 = time.time()
    grid, state0 = build_problem(dem, 4.0, params, "cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    L, R, C = grid.shape
    print(f"# grid {grid.shape} n_nodes={grid.n_nodes} "
          f"n_surface={grid.n_surface_nodes} setup {setup_s:.1f} s", flush=True)
    check(grid.n_surface_nodes == 420836, "synthetic catchment size changed")
    for name, t in list(tensors_of(grid)) + list(tensors_of(state0)):
        check(t.device.type == "cuda", f"{name} is on {t.device}, not on the card")
    # 2b: the water assembly's kernel pair against its chain at this box
    asm = compare_assembly(grid, SolverParameters.fast_f32(), args.seed)

    # one run, graph-driven (the capture before it): the script stays near
    # 600 s. The storm leg sets the counts of the bundle kernel and the
    # graph machine to 0 just before the hour it times
    sl = storm_hour("bundle hour", grid, params, 1)
    graph_main = dict(launches=sl["graph_launches"], capture_s=sl["capture_s"])
    check(graph_main["launches"] > 0, "the main path launched no graph machine")
    out, stats, wall, launches, syncs, mbr = (sl["out"], sl["stats"], sl["wall_s"],
                                              sl["launches"], sl["host_reads"], sl["mbr"])
    check(launches > 0, "the main path launched no jacobi_bundle kernel")
    check(launches * K == stats[3], f"launches {launches} x K != sweeps {stats[3]}")
    if args.seed == 0:   # the per-sweep design's trajectory: x and norm are bit-equal
        check(tuple(stats) == (91, 92, 193, 1640),
              f"seed 0 hour gave stats {stats}, not (91, 92, 193, 1640)")
    # 3x: the same hour eager-driven and profiled (the layer breakdown)
    ev = eager_hour("bundle hour", grid, params, wall)
    gx = {"bundle": graph_vs_eager("bundle hour", sl, ev, True)}
    # the hour's grid and states on the host for 3u (telemetry and the dump)
    storm = (grid.to("cpu"), params, state0.to("cpu"), out.to("cpu"))
    # the graph-driven one-device hours that 3v partitions (phases 3-3c), on
    # the host, with the eager hours' host reads and peaks
    refs = {"bundle": dict(grid=storm[0], state0=storm[2], h=storm[3].h,
                           stats=tuple(stats), mbr=mbr, reads=syncs,
                           eager_reads=ev["host_reads"], eager_peak_gib=ev["peak_gib"])}
    del sl
    busy_s, per_name = ev["busy_s"], ev["per_name"]
    jacobi_s = sum(v for k, v in per_name.items()
                   if any(name in k for name in JACOBI_KERNELS))
    print(f"# bundle hour (eager-driven, profiled): jacobi_bundle kernels {jacobi_s} s "
          f"({jacobi_s / max(busy_s, 1e-30)} of device busy)", flush=True)
    check(jacobi_s > 0.0, f"{launches} bundles per hour, but the profiled "
                          "jacobi_bundle kernel time reads 0")
    del out, ev

    # small locked-dt hour: the card against the port's CPU path
    small_card_vs_cpu("bundle")

    print(f"# phase 3 done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 3b. the production preset: CG with the line preconditioner ------
    from criteria3d_tpu_torch import bench
    p_cg = SolverParameters.fast_f32()
    check(p_cg.inner_solver == "cg" and p_cg.cg_precond == "line" and not p_cg.use_pallas,
          f"fast_f32() is not CG line: {p_cg}")
    check(bench.storm_params({}) == p_cg, "the bench's storm leg is not fast_f32()")
    with device_loop.unit_clock() as clock:
        sl = storm_hour("CG line hour", grid, p_cg, 1)
    asm["hours"] = {"cg_line": assembly_launches("CG line hour", sl, clock)}
    out, stats_cg, syncs_cg, mbr_cg = sl["out"], sl["stats"], sl["host_reads"], sl["mbr"]
    wall_cg, launches_cg = sl["wall_s"], sl["launches"]
    check(launches_cg == 0, f"the CG hour launched {launches_cg} jacobi_bundle kernels")
    if args.seed == 0:
        check(tuple(stats_cg) == (45, 52, 164, 528),
              f"seed 0 CG line hour gave stats {stats_cg}, not (45, 52, 164, 528)")
    ev = eager_hour("CG line hour", grid, p_cg, wall_cg)
    gx["cg_line"] = graph_vs_eager("CG line hour", sl, ev, True)
    refs["cg_line"] = dict(grid=storm[0], state0=storm[2], h=out.h.to("cpu"),
                           stats=tuple(stats_cg), mbr=mbr_cg, reads=syncs_cg,
                           eager_reads=ev["host_reads"], eager_peak_gib=ev["peak_gib"])
    check(ev["busy_s"] > 0.0, "the profiler saw no device activity in the CG hour")
    del out, sl, ev, grid, state0
    torch.cuda.empty_cache()

    # ---- 3c. the float64 parity path --------------------------------------
    p64 = SolverParameters()
    grid64, state64 = build_problem(dem, 4.0, p64, "cuda")
    sl = storm_hour("f64 hour", grid64, p64, 1)
    out, stats64, wall64, syncs64, mbr64 = (sl["out"], sl["stats"], sl["wall_s"],
                                            sl["host_reads"], sl["mbr"])
    check(sl["launches"] == 0, f"the f64 hour launched {sl['launches']} jacobi_bundle kernels")
    ev = eager_hour("f64 hour", grid64, p64, wall64)
    gx["f64"] = graph_vs_eager("f64 hour", sl, ev, True)
    # the f64 hour's grid is phase 3's (catchment_grid does not read params)
    refs["f64"] = dict(grid=storm[0], state0=state64.to("cpu"), h=out.h.to("cpu"),
                       stats=tuple(stats64), mbr=mbr64, reads=syncs64,
                       eager_reads=ev["host_reads"], eager_peak_gib=ev["peak_gib"])
    check(ev["busy_s"] > 0.0, "the profiler saw no device activity in the f64 hour")
    del out, sl, ev, grid64, state64
    device_loop.clear()
    torch.cuda.empty_cache()

    print(f"# phases 3b-3c done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 3d. small hours on the card against the CPU path ----------------
    for name in ("f64", "cg_line", "cg_diag_links"):
        small_card_vs_cpu(name)

    print(f"# phase 3d done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 3e. the coupled water + heat storm hour --------------------------
    from criteria3d_tpu_torch import trace_coupled
    from criteria3d_tpu_torch.problems import catchment_grid
    with device_loop.unit_clock() as clock:
        cp = coupled_hour("coupled hour", catchment_grid(dem, 4.0, "cuda"), p_cg)
    asm["hours"]["coupled"] = assembly_launches("coupled hour", cp, clock)
    check(cp["graph_launches"] > 0, "the coupled hour launched no graph machine")
    hparams, hgrid = cp["inputs"][:2]
    coupled_inputs = [x.to("cpu") for x in cp["inputs"][1:]]
    # one more hour, eager-driven and profiled: trace_coupled's roll-up (3w
    # holds its layers to its busy time) and (3x) the graph hour's reference
    device_loop.clear()
    torch.cuda.empty_cache()
    trace = trace_coupled.traced_hour(cp.pop("inputs"), cp["wall_s"])
    check(trace["busy_s"] > 0.0, "the profiler saw no device activity in the coupled hour")
    eager_cp = eager_coupled(trace, hgrid, hparams)
    gx["coupled"] = coupled_graph_vs_eager("coupled hour", cp, eager_cp, True)
    # the graph-driven one-device hour that 3v (iv) partitions, on the
    # host, with the eager hour's reads
    refs["coupled"] = dict(inputs=coupled_inputs, h=cp.pop("h"), t=cp.pop("t"),
                           counts=cp["counts"], mbr=cp["mbr"], heat_mbr=cp["heat_mbr"],
                           reads=cp["syncs"], eager_reads=eager_cp["syncs"])
    del eager_cp, hgrid
    layers_cp, sweeps = trace["layers"], cp["counts"]["heat_sweeps"]
    # a heat sweep's least bytes: b, c_up, c_down, 8 c_lat and x read as
    # float32, the bool mask, x written
    sweep_bytes = refs["coupled"]["inputs"][0].mask.numel() * (12 * 4 + 1 + 4)
    print(f"# coupled hour breakdown: {trace['activities']} device activities, busy "
          f"{trace['busy_s']} s, idle share {trace['idle_share']} of the median "
          f"{cp['wall_s']} s; device time by layer "
          + "; ".join(f"{k} {v} s" for k, v in layers_cp.items())
          + f"; heat sweep {layers_cp['heat solve'] / max(sweeps, 1) * 1e3} ms of device "
          f"time per sweep against a {sweep_bytes / HBM_BYTES_PER_S * 1e3} ms bound "
          f"(bytes), {sweeps} sweeps per hour; top: " + "; ".join(
              f"{k[:90]} {v:.4f} s x{n}" for k, v, n in trace["top"][:10]), flush=True)
    torch.cuda.empty_cache()

    # ---- 3f. small coupled hours on the card against the CPU path --------
    for name in ("f64_vapor", "frozen_vapor"):
        small_coupled_card_vs_cpu(name)
    # 3x (v): a coupled hour through the CUDA bundle, graph vs eager
    gx["bundle_coupled"] = bundle_coupled_graph_vs_eager(card)
    # (ii) ROADMAP C5: the float32 exact-mode periods, graph, eager and CPU
    exact = exact_f32_coupled(card)

    print(f"# phase 3f done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 3g-3j. the hourly model cycle ------------------------------------
    mp = model_phases(dem, args.seed, card)

    # ---- 3k-3l. the project stack -----------------------------------------
    pp = project_phases(args.seed, card)

    # ---- 3m-3p. the side process models and VINE3D -------------------------
    sp = side_phases(args.seed, card)

    # ---- 3q-3s. the command shell and the meteo grid ------------------------
    shp = shell_phases(args.seed, card)

    # ---- 3t-3u. the interpolation library and the host library ------------
    lp = library_phases(args.seed, card, storm=storm, state_map=pp["full"]["swc_map"])

    # ---- 3v. the device mesh ------------------------------------------------
    vp = mesh_phases(args.seed, card, refs=refs)

    # ---- 3w. the port's bench: the day and mesh legs, the trace -------------
    wp = bench_phases(args.seed, card, refs=refs, trace=trace)
    del storm, refs

    print(f"# phases 3g-3w done at {time.time() - t_start:.1f} s", flush=True)

    # ---- 4. kernel line ---------------------------------------------------
    # the two designs in turns (tiled, per-sweep, per-sweep, tiled)
    runs = {"tiled": [], "per_sweep": []}
    for design in ("tiled", "per_sweep", "per_sweep", "tiled"):
        fn = JB.jacobi_bundle if design == "tiled" else JB.jacobi_bundle_per_sweep
        runs[design].append(cuda_ms(lambda: fn(*inputs), reps=20))
    ms = statistics.mean(runs["tiled"])
    ms_per_sweep = statistics.mean(runs["per_sweep"])
    plain_ms = cuda_ms(lambda: JB.jacobi_bundle_reference(*inputs), reps=5,
                       batches=3)
    print(f"# jacobi_bundle ms in turns: tiled {runs['tiled']}, per-sweep "
          f"{runs['per_sweep']}", flush=True)
    nodes = L * R * C
    modelled_bytes = JB.modelled_passes(K, TI, S) * nodes * 4
    bytes_moved = (14 * nodes + 1) * 4
    flops = nodes * (K * FLOPS_PER_NODE_SWEEP + FLOPS_PER_NODE_NORM)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    kernels = [{
        "name": "jacobi_bundle",
        "route": "cuda",
        "source": "criteria3d_tpu_torch/csrc/jacobi_bundle.cu",
        "replaces": "criteria3d_tpu/solver/pallas_jacobi.py:176",
        "launches": launches,
        "max_abs_err": err_main,
        # the halo mode at the main-path shape, halo = K
        "halo_max_abs_err": err_halo,
        "halo_norm_rel_err": rel_halo,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "ms_per_sweep_design": ms_per_sweep,
        # device time per bundle in the profiled hour, on the catchment's own
        # systems (whose all-masked tiles the kernel skips)
        "ms_in_hour": jacobi_s / launches * 1e3,
        # launches in the model-cycle hour of phase 3i
        "launches_model_hour": mp["launches_bundle"],
        # launches in the vineyard hours of phase 3o (the CG-line preset)
        "launches_vine_hours": sp["vine"]["launches"],
        # launches in the shell's hours (3q) and the meteo-grid hours (3r)
        "launches_shell_hours": shp["shell"]["launches"],
        "launches_grid_hours": shp["grid"]["launches"],
        # the mesh (3v): launches in the partitioned bundle storm hour on
        # 2 x 2 blocks (4 a bundle), one bundle on 2 x 2 blocks of phase 2's
        # inputs, its x exchange alone, and its bound (the blocks' kernel
        # bounds at their grown size plus the exchange's bytes)
        "launches_mesh_hour": vp["hours"]["bundle"]["launches"],
        "mesh_ms_per_bundle": vp["loops"]["meshes"][4]["ms"],
        "mesh_exchange_ms": vp["loops"]["meshes"][4]["exchange_ms"],
        # the kernel alone on each of those blocks (halo = K)
        "mesh_block_ms": vp["loops"]["meshes"][4]["block_ms"],
        # launches in 3v's bundle storm hour on the same blocks split into 4
        # machines (rounds: each machine its own blocks' launches)
        "launches_mesh_machines_hour": vp["hours"]["bundle"]["machines"][(0, 1, 2, 3)][
            "launches"],
        # launches in 3x (v)'s bundle-form coupled hour on 2 x 2 blocks, one
        # machine and split into machines (rounds), each counted from 0
        # just before its hour
        "launches_bundle_coupled_machines_hours": {
            k: r["launches"] for k, r in vp["bundle_coupled"].items()},
        "mesh_bound_ms": vp["loops"]["meshes"][4]["bound_ms"],
        # launches in the bench's mesh leg (3w): the bundle hour on a (1, 1)
        # mesh, one a bundle
        "launches_bench_mesh_leg": wp["mesh"]["launches"],
        "variant": JB.tiled_variant(*inputs),
        "tile": TI,
        "sweeps_on_chip": S,
        "modelled_bytes": modelled_bytes,
        "achieved_tb_s": modelled_bytes / (ms * 1e-3) * 1e-12,
    }]
    gm_ms, gm_plain_ms = graph_control_ms()
    print(f"# graph machine control per unit ({card}): {gm_ms} ms graph-driven (a switch "
          f"on the phase and two one-thread kernels), {gm_plain_ms} ms eager-driven (one "
          f"host read of the status); the main path's hour: {graph_main['launches']} "
          f"launches, {graph_main['capture_s']} s of capture", flush=True)
    kernels.append({
        "name": "graph_machine",
        "route": "cuda",
        "source": "criteria3d_tpu_torch/csrc/graph_machine.cu",
        # the loop nests' control: the lax.while_loops of the water period
        # and step retries, and of the coupled period, its chunks,
        # sub-steps (frozen, exact) and heat sweeps (the inner loops' are
        # units of the same machines)
        "replaces": "criteria3d_tpu/solver/step.py:677; criteria3d_tpu/solver/"
                    "coupled.py:259, :215, :180, :209; criteria3d_tpu/solver/"
                    "heat.py:1094, :1298; criteria3d_tpu/physics/hydrall.py:302; "
                    "criteria3d_tpu/physics/vine_photosynthesis.py:411",
        "launches": graph_main["launches"],
        # launches in phase 3e's coupled storm hour (the bench's coupled
        # leg, its counts set to 0 just before it), 3h's coupled model hour
        # and 3x (v)'s bundle-form coupled hour
        "launches_coupled_hour": cp["graph_launches"],
        "launches_coupled_model_hour": mp["coupled"]["graph_launches"],
        "launches_bundle_coupled_hour": gx["bundle_coupled"]["graph_launches"],
        # launches in 3v's partitioned hours on 2 x 2 blocks of the card
        # (each counted from 0 just before its hour, after its capture) and
        # in 3w's mesh leg, the bundle hour on a (1, 1) mesh
        "launches_mesh_hours": {k: h["graph_launches"] for k, h in vp["hours"].items()},
        "capture_s_mesh_hours": {k: h["capture_s"] for k, h in vp["hours"].items()},
        # 3v's hours on the same 2 x 2 blocks split into machines, run by the
        # rounds driver (c3d_switch_build's segment graphs, c3d_rounds) in a
        # process of their own: its launches are batches of at most
        # UNITS_PER_LAUNCH rounds
        "launches_mesh_machines_hours": {
            f"{k} {''.join(map(str, m))}": r["graph_launches"]
            for k, h in vp["hours"].items() for m, r in h.get("machines", {}).items()},
        "rounds_mesh_machines_hours": {
            f"{k} {''.join(map(str, m))}": r["rounds"]
            for k, h in vp["hours"].items() for m, r in h.get("machines", {}).items()},
        # the rounds enqueued in them (a batch stops once machine 0's code,
        # copied to the host every POLL_EVERY rounds, reads no segment)
        "rounds_enqueued_mesh_machines_hours": {
            f"{k} {''.join(map(str, m))}": r["rounds_enqueued"]
            for k, h in vp["hours"].items() for m, r in h.get("machines", {}).items()},
        # 3x (v)'s bundle-form coupled hour on 2 x 2 blocks, one machine
        # (graph) and split into machines (batches of rounds), in the same
        # process
        "launches_bundle_coupled_machines_hours": {
            k: r["graph_launches"] for k, r in vp["bundle_coupled"].items()},
        "rounds_bundle_coupled_machines_hours": {
            k: r["rounds"] for k, r in vp["bundle_coupled"].items()},
        "launches_bench_mesh_leg": wp["mesh"]["graph_launches"],
        # launches of the fixed points' machines: hour 13's hydrall_hour
        # (2 calls, 3m) and hour 12's vine canopy fluxes (4 calls, 3o)
        "launches_hydrall_fixed_points": sp["hydrall"]["drivers"]["launches"],
        "launches_vine_fixed_points": sp["vine"]["drivers"]["launches"],
        # one fixed-point iteration's bound (its inputs read once, its
        # carries read and written once, over the card's rate) for each
        # call, and the graph-driven wall over the calls' iterations
        "iteration_bound_ms_hydrall": sp["hydrall"]["drivers"]["iteration_bound_ms"],
        "iteration_bound_ms_vine": sp["vine"]["drivers"]["iteration_bound_ms"],
        "ms_per_iteration_hydrall": sp["hydrall"]["drivers"]["graph_ms_per_iteration"],
        "ms_per_iteration_vine": sp["vine"]["drivers"]["graph_ms_per_iteration"],
        # heads of the graph-driven bundle hour against the eager driver's
        "max_abs_err": gx["bundle"]["dh_max"],
        "ms": gm_ms,
        "plain_ms": gm_plain_ms,
        # each unit reads the 8-byte phase twice and writes two 4-byte
        # handles and a 4-byte count
        "bound_ms": 28 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "units_per_launch": device_loop.UNITS_PER_LAUNCH,
        "capture_s": graph_main["capture_s"],
        "capture_s_coupled": cp["capture_s"],
    })
    kernels.append({
        "name": "assemble_fast",
        "route": "cuda",
        "source": "criteria3d_tpu_torch/csrc/assemble_fast.cu",
        # no TPU kernel: XLA fused the plain jnp function
        "replaces": "none: XLA's fusion of criteria3d_tpu/solver/water.py assemble_fast",
        # kernel pairs in 3b's CG-line hour (the water cell's) and 3e's
        # coupled hour, each counted from 0 just before it: one an
        # assemble unit plus one a restore
        "launches": asm["hours"]["cg_line"]["launches"],
        "launches_coupled_hour": asm["hours"]["coupled"]["launches"],
        "assemble_units": {k: h["units"] for k, h in asm["hours"].items()},
        "restores": {k: h["restores"] for k, h in asm["hours"].items()},
        # 2b: the pair against the chain at the storm box, bit for bit
        "max_abs_err": asm["max_abs_err"],
        "differing_values": asm["differing"],
        "ms": asm["ms"],
        "ms_in_hour": asm["hours"]["cg_line"]["ms_per_unit"],
        "ms_in_coupled_hour": asm["hours"]["coupled"]["ms_per_unit"],
        "plain_ms": asm["plain_ms"],
        "bound_ms": asm["bound_ms"],
        "bound_by": "bytes",
        "bytes_read": asm["bytes_read"],
        "bytes_written": asm["bytes_written"],
        "library_ms": None,
    })
    print(f"# per simulated hour ({card}): bundle stats={list(stats)} mbr={mbr} "
          f"wall_s={wall} host_syncs={syncs}; CG line stats={list(stats_cg)} "
          f"mbr={mbr_cg} wall_s={wall_cg} host_syncs={syncs_cg}; f64 "
          f"stats={list(stats64)} mbr={mbr64} wall_s={wall64} "
          f"host_syncs={syncs64}; coupled (768 box) counts={cp['counts']} "
          f"mbr={cp['mbr']} heat_mbr={cp['heat_mbr']} wall_s={cp['wall_s']} "
          f"host_syncs={cp['syncs']}; model cycle ({mp['box']}) walls={mp['walls']} "
          f"host_syncs={mp['syncs']} peak_gib={mp['peak_gib']:.2f}; coupled model hour "
          f"counts={mp['coupled']['counts']} mbr={mp['coupled']['mbr']} "
          f"heat_mbr={mp['coupled']['heat_mbr']} wall_s={mp['coupled']['wall_s']}; "
          f"bundle model hour stats={list(mp['stats_bundle'])} "
          f"launches={mp['launches_bundle']}; model day card/CPU walls={mp['walls_day']}; "
          f"phases 3g-3j {mp['seconds']:.1f} s; project 768 walls={pp['full']['walls']} "
          f"host_reads={pp['full']['syncs']} peak_gib={pp['full']['peak_gib']:.2f} "
          f"bundle_launches={pp['full']['launches']}; project day card/CPU "
          f"walls={pp['small']['walls_day']}; coupled project hours card/CPU "
          f"walls={pp['small']['walls_heat']}; phases 3k-3l {pp['seconds']:.1f} s; "
          f"hydrall model walls={sp['hydrall']['walls']} host_reads={sp['hydrall']['syncs']} "
          f"fixed-point iterations={sp['hydrall']['iterations']} c3d.hydrall share="
          f"{sp['hydrall']['hydrall_s'] / sp['hydrall']['busy_s']}; hydrall period card/CPU "
          f"walls={sp['hydrall_small']['walls']}; vine 768 walls={sp['vine']['walls']} "
          f"host_reads={sp['vine']['syncs']} fixed-point iterations={sp['vine']['iterations']} "
          f"c3d.vine share={sp['vine']['vine_s'] / sp['vine']['busy_s']} c3d.diseases share="
          f"{sp['vine']['diseases_s'] / sp['vine']['busy_s']} peak_gib={sp['vine']['peak_gib']:.2f}; "
          f"vine day card/CPU walls={sp['vine_small']['walls']}; phases 3m-3p "
          f"{sp['seconds']:.1f} s; shell 768 script_s={shp['shell']['script_s']} "
          f"hour walls={shp['shell']['hours']} host_reads={shp['shell']['syncs']} "
          f"writer written={shp['shell']['written']} errors={shp['shell']['errors']} "
          f"peak_gib={shp['shell']['peak_gib']:.2f}; grid 768 walls={shp['grid']['walls']} "
          f"host_reads={shp['grid']['syncs']} c3d.interpolation share (100 stations)="
          f"{shp['grid']['interpolation_s'] / shp['grid']['busy_s']} (3k, 20 stations: "
          f"{pp['full']['interpolation_s'] / pp['full']['busy_s']}); shell and grid "
          f"32 box card/CPU walls={shp['small']['walls']} {shp['small']['walls_grid']}; "
          f"phases 3q-3s {shp['seconds']:.1f} s; graph vs eager (3x) " + "; ".join(
              f"{form} reads {g['graph_reads']} / {g['eager_reads']} peak GiB "
              f"{g['graph_peak_gib']:.3f} / {g['eager_peak_gib']:.3f} capture "
              f"{g['capture_s']:.3f} s" for form, g in gx.items()) + "; "
          f"library 768 local map "
          f"{lp['full']['records']['local_detrending_map'][0]} s (c3d.detrending "
          f"{lp['full']['detrending_s']} s of device time), window card/CPU "
          f"walls={lp['small']['walls']} differing cells={lp['small']['differ']}; host library "
          f"walls={lp['host']['walls']}; phases 3t-3u {lp['seconds']:.1f} s; mesh 2 x 2 "
          f"partitioned storm hours " + "; ".join(
              f"{form} ({h['driver']}) stats={list(h['stats'])} mbr={h['mbr']} "
              f"wall_s={h['wall_s']} host_reads={h['host_reads']} launches={h['launches']} "
              f"graph_launches={h['graph_launches']} capture_s={h['capture_s']} "
              f"peak_gib={h['peak_gib']}" + "".join(
                  f", machines {''.join(map(str, m))}: wall_s={r['wall_s']} "
                  f"host_reads={r['host_reads']} graph_launches={r['graph_launches']} "
                  f"rounds={r['rounds']} rounds_enqueued={r['rounds_enqueued']} "
                  f"capture_s={r['capture_s']} peak_gib={r['peak_gib']}"
                  for m, r in h.get("machines", {}).items())
              for form, h in vp["hours"].items()) + "; 3x on 2 x 2 blocks " + "; ".join(
              f"{form} reads {g['graph_reads']} / {g['eager_reads']} walls "
              f"{g['graph_wall_s']} / {g['eager_wall_s']} s peak GiB {g['graph_peak_gib']} / "
              f"{g['eager_peak_gib']}" for form, g in vp["small"].items())
          + "; exact-mode f32 coupled " + "; ".join(
              f"{e['n']} box counts={e['counts']} reads {e['graph_reads']} / "
              f"{e['eager_reads']}" for e in exact)
          + f"; fixed points: hydrall_hour reads {sp['hydrall']['drivers']['graph_reads']} / "
          f"{sp['hydrall']['drivers']['eager_reads']}, vine canopy fluxes reads "
          f"{sp['vine']['drivers']['graph_reads']} / {sp['vine']['drivers']['eager_reads']} "
          f"walls {sp['vine']['drivers']['graph_wall_s']} / "
          f"{sp['vine']['drivers']['eager_wall_s']} s; vine hour 14 {sp['vine']['hour14']}; "
          f"coupled model hour peak GiB {mp['coupled']['peak_gib']} / "
          f"{mp['coupled']['eager_peak_gib']}" + "; scaling legs " + "; ".join(
              f"{k} {v['step_s']} s/step efficiency {v['efficiency']}"
              for k, v in vp["scaling"]["devices"].items()) + "; phase 3v "
          f"{vp['seconds']:.1f} s; bench day leg {wp['day']['wall_s']} s mbr="
          f"{wp['day']['mbr']}; bench mesh leg ({wp['mesh']['driver']}) "
          f"stats={list(wp['mesh']['stats'])} wall_s={wp['mesh']['wall_s']} "
          f"host_reads={wp['mesh']['host_reads']}; phase 3w {wp['seconds']:.1f} s; script "
          f"{time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
