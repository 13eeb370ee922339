#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``criteria3d_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py [--seed 0] [--timed-hours 3]

Phases (any failed check exits non-zero before the last line):

1. card and build: prints the card's name and power limit, builds the CUDA
   library from ``criteria3d_tpu_torch/csrc``;
2. kernel against plain version: the CUDA ``jacobi_bundle`` (the tiled
   design) against ``jacobi_bundle_reference`` on seeded float32 inputs, at
   the main-path shape (7, 768, 768), at (5, 37, 45), at a box smaller than
   a tile and at one a cell past two tiles a side (x bit-equal, the norm to
   rel 1e-5); and against the per-sweep design ``jacobi_bundle_per_sweep``
   at the main-path shape (x and norm bit-equal);
3. the main path: one simulated hour of a 20 mm/h storm on a synthetic
   catchment at the scale of the Ravone benchmark (768 x 768 box of 4 m
   cells, a disc of 420,836 valid cells, 7 layers, ~2.95M nodes) through
   ``compute_period_stats`` under ``SolverParameters.fast_f32(use_pallas=True)``,
   with the kernel's launch count read from that run (at ``--seed 0`` the
   stats must be (91, 92, 193, 1640), the per-sweep design's); then the same hour
   timed ``--timed-hours`` times, and once more under torch.profiler for
   the device-time breakdown; then a small locked-dt hour on the card
   against the same hour on the CPU (the plain twin);
4. the ``kernels`` line: one JSON object per ported kernel with its
   launches, error, times and bound, and for the tiled bundle its tile, the
   sweeps it keeps on chip, its modelled bytes and rate, and the per-sweep
   design's time in the same run;
5. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 operations per node: one sweep (10 multiplies, 10 adds, the mask
# multiply) and the last sweep's norm (sub, 2 abs, compare, divide,
# 2 multiplies, add)
FLOPS_PER_NODE_SWEEP = 21
FLOPS_PER_NODE_NORM = 8


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


def compare_bundle(shape, seed: int):
    """Kernel vs plain version on one seeded input; returns (max_abs_err,
    norm_rel_err, inputs). x must be bit-equal (the build disables FMA
    contraction and the kernel adds the terms in the plain order); the norm
    sums in another order and is held to rel 1e-5."""
    import torch
    from criteria3d_tpu_torch.bench_jacobi import bundle_inputs
    from criteria3d_tpu_torch.solver import jacobi_bundle as JB
    inputs = bundle_inputs(shape, seed, "cuda")
    x_k, n_k = JB.jacobi_bundle(*inputs)
    x_p, n_p = JB.jacobi_bundle_reference(*inputs)
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    n_k, n_p = float(n_k), float(n_p)
    rel = abs(n_k - n_p) / max(abs(n_p), 1e-30)
    check(err == 0.0, f"jacobi_bundle x differs from the plain version at {shape}: "
                      f"max abs err {err}")
    check(rel <= 1e-5, f"jacobi_bundle norm differs at {shape}: kernel "
                       f"{n_k} plain {n_p} (rel {rel})")
    print(f"# jacobi_bundle vs plain at {shape} ({JB.tiled_variant(*inputs)} kernel): "
          f"max_abs_err={err} norm_rel={rel}", flush=True)
    return err, rel, inputs


def synthetic_catchment(seed: int, n: int = 768, cell: float = 4.0,
                        radius: float = 366.0):
    """A tilted V valley in the form of tests/test_catchment3d.py's
    valley_dem (5 % down-valley, 8 % across, per metre) plus a smooth seeded
    perturbation, inside a disc of valid cells centred in an n x n box."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:n, 0:n].astype(np.float64)
    z = 100.0 + (n - 1 - rows) * 0.05 * cell + np.abs(cols - n // 2) * 0.08 * cell
    for _ in range(4):
        kr, kc = rng.uniform(-1, 1, 2) * 2 * np.pi / (100.0 * cell)
        z += rng.uniform(0.5, 2.0) * np.sin(kr * rows * cell + kc * cols * cell
                                            + rng.uniform(0, 2 * np.pi))
    c0 = (n - 1) / 2.0
    disc = (rows - c0) ** 2 + (cols - c0) ** 2 <= radius ** 2
    return np.where(disc, z, -9999.0)


def build_problem(dem, cell, params, device, *, total_depth=0.8,
                  min_thickness=0.04, max_thickness=0.25,
                  max_thickness_depth=0.6, soil=None, psi0=-2.0, rain=0.020):
    """Grid + initial state + rain, as bench.py builds its storm hour
    (clay-loam soil of the Ravone study by default)."""
    import torch
    from criteria3d_tpu_torch import Grid, SoilFields, WaterState
    from criteria3d_tpu_torch.solver.step import initialize_balance
    soil = soil or dict(vg_alpha=1.0, vg_n=1.35, vg_he=0.02, theta_s=0.44,
                        theta_r=0.06, k_sat=2e-6)
    grid = Grid.build(dem, cell, SoilFields.uniform(dem.shape, device=device, **soil),
                      total_depth=total_depth, min_thickness=min_thickness,
                      max_thickness=max_thickness,
                      max_thickness_depth=max_thickness_depth, device=device)
    state = WaterState.initialize(grid, params, matric_potential=psi0, device=device)
    state = initialize_balance(grid, params, state)
    sink = torch.zeros_like(state.sink_source)
    sink[0] = torch.where(grid.mask[0], rain * float(grid.area) / 3600.0, 0.0)
    return grid, dataclasses.replace(state, sink_source=sink)


def tensors_of(obj):
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


def breakdown(grid, params, state, wall_s: float) -> float:
    """One more hour under torch.profiler: device time by kernel, the
    bundled-Jacobi kernels' share, and the device's idle share.

    Busy time is the union of the device activity intervals (kernels,
    copies, fills) of the exported trace; host-op annotations, which the
    trace also places on the device timeline, are left out. The idle share
    is given against the unprofiled median wall time ``wall_s`` (the
    profiler slows the host, not the kernels) and against the profiled
    hour's own wall time. Returns the bundled-Jacobi kernels' device
    seconds in the hour (0.0 when the profiler saw no device activity)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from criteria3d_tpu_torch.solver.step import compute_period_stats
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        compute_period_stats(grid, params, state, 3600.0)
        torch.cuda.synchronize()
        prof_wall_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, per_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((ts, ts + dur))
            per_name[e["name"]] = per_name.get(e["name"], 0.0) + dur
    if not spans:
        print("# breakdown: the profiler saw no device activity (not measured)")
        return 0.0
    spans.sort()
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, t in spans[1:]:
        if s > hi:
            busy_us, lo, hi = busy_us + (hi - lo), s, t
        else:
            hi = max(hi, t)
    busy_s = (busy_us + (hi - lo)) * 1e-6
    jacobi_s = sum(v for k, v in per_name.items()
                   if any(name in k for name in JACOBI_KERNELS)) * 1e-6
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"# breakdown: {len(spans)} device activities per hour, device busy "
          f"{busy_s} s; idle share {1.0 - busy_s / wall_s} of the unprofiled "
          f"{wall_s} s, {1.0 - busy_s / prof_wall_s} of the profiled "
          f"{prof_wall_s} s; jacobi_bundle kernels {jacobi_s} s "
          f"({jacobi_s / busy_s} of device busy); top: "
          + "; ".join(f"{k[:70]} {v * 1e-6:.4f} s" for k, v in top), flush=True)
    return jacobi_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timed-hours", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from criteria3d_tpu_torch import SolverParameters
        from criteria3d_tpu_torch.bench_jacobi import cuda_ms
        from criteria3d_tpu_torch.device import host_read
        from criteria3d_tpu_torch.solver import jacobi_bundle as JB
        from criteria3d_tpu_torch.solver.step import compute_period_stats
    except ImportError as e:
        print(f"chip_smoke: the criteria3d_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2
    check("jax" not in sys.modules and "criteria3d_tpu" not in sys.modules,
          "the port imported JAX or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.time()
    lib = JB.build_library(verbose=True)
    print(f"# built {lib} in {time.time() - t0:.1f} s", flush=True)

    # ---- 2. kernel against plain version, on the card --------------------
    main_shape = (7, 768, 768)
    K = JB.SWEEPS_PER_BUNDLE
    TI, S = JB.plan_tiles(main_shape[0], K)
    err_main, _, inputs = compare_bundle(main_shape, args.seed)
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

    JB.jacobi_bundle.launches = 0
    host_read.count = 0
    t0 = time.time()
    out, stats = compute_period_stats(grid, params, state0, 3600.0)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = JB.jacobi_bundle.launches
    syncs = host_read.count
    mbr = float(out.balance_whole.mbr)
    print(f"# hour: stats (steps, attempts, approximations, sweeps) = {stats} "
          f"whole-period MBR={mbr} first run {first_s:.3f} s "
          f"bundle launches={launches} host syncs={syncs}", flush=True)
    for name, t in tensors_of(out):
        check(t.device.type == "cuda", f"output {name} is on {t.device}")
    check(bool(torch.isfinite(out.h).all()), "non-finite heads after the hour")
    check(abs(mbr) < 2e-3, f"|whole-period MBR| {mbr} >= 2e-3")
    check(launches > 0, "the main path launched no jacobi_bundle kernel")
    check(launches * K == stats[3], f"launches {launches} x K != sweeps {stats[3]}")
    if args.seed == 0:   # the per-sweep design's trajectory: x and norm are bit-equal
        check(tuple(stats) == (91, 92, 193, 1640),
              f"seed 0 hour gave stats {stats}, not (91, 92, 193, 1640)")

    walls = []
    for _ in range(args.timed_hours):
        torch.cuda.synchronize()
        t0 = time.time()
        out_t, stats_t = compute_period_stats(grid, params, state0, 3600.0)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        check(stats_t == stats, f"a repeated hour gave other stats {stats_t}")
    wall = statistics.median(walls) if walls else first_s
    print(f"# wall s per simulated hour: median {wall} of {walls}; "
          f"host syncs per hour {syncs}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    jacobi_s = breakdown(grid, params, state0, wall)
    check(jacobi_s > 0.0, f"{launches} bundles per hour, but the profiled "
                          "jacobi_bundle kernel time reads 0")
    del out, state0

    # small locked-dt hour: the card against the port's CPU path
    import numpy as np
    n = 16
    rows, cols = np.mgrid[0:n, 0:n]
    small = (100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 0.8).astype(np.float64)
    p_lock = SolverParameters.fast_f32(use_pallas=True, delta_t_min=60.0,
                                       delta_t_max=60.0)
    soil = dict(vg_alpha=1.2, vg_n=1.5, vg_he=0.02, theta_s=0.41, theta_r=0.04,
                k_sat=5e-6)
    res = {}
    for dev in ("cuda", "cpu"):
        g, s = build_problem(small, 10.0, p_lock, dev, total_depth=0.6,
                             min_thickness=0.02, max_thickness=0.1,
                             max_thickness_depth=0.4, soil=soil, psi0=-1.5,
                             rain=0.015)
        o, st = compute_period_stats(g, p_lock, s, 3600.0)
        res[dev] = (o.h.cpu(), st, float(o.balance_whole.mbr))
    dh = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    print(f"# small locked hour: card {res['cuda'][1]} MBR {res['cuda'][2]}; "
          f"cpu {res['cpu'][1]} MBR {res['cpu'][2]}; max |dh| {dh} m", flush=True)
    check(res["cuda"][1][:3] == res["cpu"][1][:3],
          "small hour: steps/attempts/approximations differ between card and CPU")
    check(dh < 1e-4, f"small hour: heads differ by {dh} m between card and CPU")

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
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "ms_per_sweep_design": ms_per_sweep,
        # device time per bundle in the profiled hour, on the catchment's own
        # systems (whose all-masked tiles the kernel skips)
        "ms_in_hour": jacobi_s / launches * 1e3,
        "variant": JB.tiled_variant(*inputs),
        "tile": TI,
        "sweeps_on_chip": S,
        "modelled_bytes": modelled_bytes,
        "achieved_tb_s": modelled_bytes / (ms * 1e-3) * 1e-12,
    }]
    print(f"# per simulated hour: n_nodes={grid.n_nodes} stats={list(stats)} "
          f"mbr={mbr} wall_s={wall} host_syncs={syncs} card={card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
