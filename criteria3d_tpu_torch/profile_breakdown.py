"""Where the storm hour's device time goes: assembly, inner solve, balance.

    python -m criteria3d_tpu_torch.profile_breakdown [coarsen]

Counterpart of ``scripts/profile_breakdown.py``, on the CUDA card: on the
bench's grid (``bench.build_grid(coarsen)``, default 1) under
``SolverParameters.fast_f32()``, CUDA events time one ``assemble_fast``,
one float32 Jacobi sweep, one iteration of the CG-line solve (the
solver's own ``step.cg_iteration``, without its host read), one balance
evaluation and one ``jacobi_bundle`` (K sweeps in one memory pass), each
the median of batches of back-to-back calls on the storm's initial state.
The counters that weigh them are the port's own CG-line hour's, run here:
its approximations (assemblies), attempts (balance evaluations) and CG
iterations; that hour runs as the bench's storm leg runs it (the graph
driver on the card) and the line gives its driver, units per launch,
capture seconds, wall and host reads. The rates: a sweep reads b, the 10 coefficient arrays and x
and writes x (13 float32 arrays of the box); a bundle reads its 13 inputs
once and writes x once (the single pass of its bound). Each rate is also
given as a share of the card's 3.35 TB/s. Prints one JSON line with the
card's name and power limit. With ``device="cpu"`` the same calls are timed
on the host clock and the rates are left out.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from criteria3d_tpu_torch import bench, problems
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import host_read, resolve_device
from criteria3d_tpu_torch.solver import jacobi_bundle as JB
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.step import (cg_iteration, cg_operators, cg_start,
                                              compute_period_stats)
from criteria3d_tpu_torch.utils.profiling import HBM_BYTES_PER_S

__all__ = ["seconds_per_call", "profile", "main"]


def seconds_per_call(fn, dev: torch.device, reps: int) -> float:
    """Seconds of one ``fn()``: on the card CUDA events around ``reps``
    back-to-back calls (the median of 5 batches, after 3 warm-up calls); on
    the CPU the host clock around them."""
    if dev.type == "cuda":
        from criteria3d_tpu_torch.bench_jacobi import cuda_ms
        return cuda_ms(fn, reps) * 1e-3
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def profile(coarsen: int = 1, device=None, dem=None) -> dict:
    """The breakdown on the bench's grid at ``coarsen`` (on ``dem``,
    ``bench.load_dem()`` when None); the JSON object the script prints."""
    dev = resolve_device(device)
    dem = dem or bench.load_dem()
    grid = bench.build_grid(coarsen, dev, dem)
    params = SolverParameters.fast_f32()
    state = problems.storm_state(grid, params)
    # the hour itself, as the bench's storm leg runs it: its driver (graph
    # on the card), capture seconds, wall and host reads
    driver = bench.prepare_driver(grid, params, state)
    host_read.count = 0
    t0 = time.perf_counter()
    _, stats = compute_period_stats(grid, params, state, 3600.0)
    bench.sync(dev)
    hour_wall_s, hour_reads = time.perf_counter() - t0, host_read.count
    _, attempts, approximations, cg_iters = stats
    sd = params.sweep_dtype
    psi0 = torch.where(grid.mask, state.h - grid.z, 0.0).to(sd)
    se0 = W.compute_se_psi(grid, params, psi0)
    dt = 300.0

    def assembly():
        return W.assemble_fast(grid, params, psi0, psi0, se0, state.sink_source,
                               state.pond, 0, dt)

    system = assembly()[0]

    def balance():
        se = W.compute_se_psi(grid, params, psi0)
        return W.current_mass_balance_psi(grid, params, psi0, se, torch.zeros_like(psi0),
                                          state.balance_prev.storage, dt)

    # the solve's own operators and loop body (step.cg_iteration), from
    # the first system's start; the solve's one host read an iteration
    # is left out
    ops = cg_operators(system, grid, params, True, sd)
    s0, p0, rho0, norm0 = cg_start(ops, psi0)
    tol = torch.full((), 1e-7, dtype=sd, device=dev)
    best = torch.maximum(norm0, tol)
    mask_f = grid.mask.to(sd)
    t_assembly = seconds_per_call(assembly, dev, 10)
    t_sweep = seconds_per_call(lambda: W.jacobi_sweep_psi(system, psi0, grid, grid.n_nodes),
                               dev, 50)
    t_cg_iter = seconds_per_call(
        lambda: cg_iteration(ops, psi0, s0, p0, rho0, best, tol), dev, 50)
    t_balance = seconds_per_call(balance, dev, 20)
    t_bundle = seconds_per_call(lambda: JB.jacobi_bundle(
        system.b, system.c_up, system.c_down, system.c_lat, mask_f, psi0), dev, 20)
    K = JB.SWEEPS_PER_BUNDLE
    box = grid.mask.numel()
    total = t_assembly * approximations + t_cg_iter * cg_iters + t_balance * attempts
    out = {
        "coarsen": coarsen,
        "n_nodes": grid.n_nodes,
        "box_cells": box,
        "t_assembly_s": t_assembly,
        "t_sweep_s": t_sweep,
        "t_cg_iter_s": t_cg_iter,
        "t_balance_s": t_balance,
        "est_hour_s": total,
        "share_assembly": t_assembly * approximations / total,
        "share_cg_iters": t_cg_iter * cg_iters / total,
        "share_balance": t_balance * attempts / total,
        "t_pallas_bundle_s": t_bundle,
        "pallas_sweep_equiv_s": t_bundle / K,
        "pallas_vs_xla_sweep": t_sweep * K / t_bundle,
        "hour_stats": list(stats),
        "hour_wall_s": hour_wall_s,
        "hour_host_reads": hour_reads,
        "driver": driver["driver"],
        "units_per_launch": driver["units_per_launch"],
        "capture_s": driver["capture_s"],
        "assemblies": approximations,
        "balances": attempts,
        "cg_iters": cg_iters,
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "dem": dem.name,
    }
    if dev.type == "cuda":
        sweep_bytes = 13 * 4 * box
        bundle_bytes = (14 * box + 1) * 4
        out.update(sweep_hbm_gb_per_s=sweep_bytes / t_sweep / 1e9,
                   sweep_hbm_share=sweep_bytes / t_sweep / HBM_BYTES_PER_S,
                   bundle_hbm_gb_per_s=bundle_bytes / t_bundle / 1e9,
                   bundle_hbm_share=bundle_bytes / t_bundle / HBM_BYTES_PER_S,
                   bundle_bound_s=bundle_bytes / HBM_BYTES_PER_S)
    return out


def main() -> int:
    coarsen = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"profile_breakdown: {e}", file=sys.stderr)
        return 2
    out = profile(coarsen, dev)
    out["card"], out["power_limit_w"] = bench.card_info()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
