"""Scaling harness: grid nodes per second of the water step on one device
and on a mesh of blocks.

    python -m criteria3d_tpu_torch.scaling_bench [n_rows] [n_cols] [--blocks N]

Counterpart of ``scripts/scaling_bench.py``, on the CUDA card: the same
sloped DEM, a warm-up step and then 4 timed steps, and the same legs
under the same JSON keys. Leg ``"1"`` runs ``SolverParameters()`` (the
float64 path) on one device and leg ``"<n>"`` the same step partitioned
over a mesh of n blocks (``--blocks`` blocks on one card, or one block per
card where there are several); leg ``"<n>_pallas"`` runs
``fast_f32(use_pallas=True)`` on that mesh, and leg ``"1_pallas"``, which
the JAX script has not, the bundle on one device. The whole step runs on
the blocks, as JAX's GSPMD partitions it. ``efficiency`` is the speed-up
over the one-device leg of the same parameters per card of the mesh, so
blocks sharing one card measure what the decomposition costs. The card's
name and power limit are printed with the numbers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import resolve_device
from criteria3d_tpu_torch.parallel.sharding import (gather_pytree, make_mesh,
                                                    shard_pytree)
from criteria3d_tpu_torch.problems import SMALL_SOIL, build_problem
from criteria3d_tpu_torch.solver.step import compute_period_stats, compute_step

def sloped_dem(nr: int, nc: int) -> np.ndarray:
    rows, cols = np.mgrid[0:nr, 0:nc]
    return (100.0 + (nr - 1 - rows) * 0.5
            + np.abs(cols - nc // 2) * 0.8).astype(np.float64)


def build_case(nr: int, nc: int, dev, rain: float = 0.015, psi0: float = -1.5):
    """The sloped DEM of ``nr`` x ``nc`` 10 m cells, 0.6 m of soil, the
    initial state under ``SolverParameters()`` and ``rain`` [m/h] on the
    surface, as the JAX script builds it: ``(grid, state)`` on ``dev``."""
    return build_problem(sloped_dem(nr, nc), 10.0, SolverParameters(), dev,
                         total_depth=0.6, min_thickness=0.02, max_thickness=0.1,
                         max_thickness_depth=0.4, soil=SMALL_SOIL, psi0=psi0,
                         rain=rain)


def _sync(state) -> None:
    float(state.balance_current.mbr)     # waits for the step's last kernels


def time_steps(grid, params, state, n_steps: int = 4) -> float:
    """Seconds per ``compute_step`` (dt up to an hour): one warm-up step,
    then ``n_steps`` chained steps from ``state``, synchronised on the
    balance read."""
    s, _ = compute_step(grid, params, state, 3600.0)
    _sync(s)
    t0 = time.perf_counter()
    s = state
    for _ in range(n_steps):
        s, _ = compute_step(grid, params, s, 3600.0)
    _sync(s)
    return (time.perf_counter() - t0) / n_steps


def leg_mesh(blocks: int, dev: torch.device):
    """The mesh of the ``"<n>_pallas"`` leg: one block per card where
    ``dev`` is a CUDA device and there are several, else ``blocks`` blocks
    on ``dev``."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return make_mesh(blocks, devices=[dev] * blocks)


def scaling(nr: int, nc: int, blocks: int, dev) -> dict:
    """The four legs on ``dev``; the JSON object the script prints."""
    dev = torch.device(dev)
    grid, state = build_case(nr, nc, dev)
    n_nodes = grid.n_nodes
    mesh = leg_mesh(blocks, dev)
    n = mesh.devices.size
    cards = len({str(d) for d in mesh.devices.flat})
    grid_s, state_s = shard_pytree(grid, mesh), shard_pytree(state, mesh)
    results = {}
    for suffix, make in (("", SolverParameters),
                         ("_pallas", lambda **kw: SolverParameters.fast_f32(
                             use_pallas=True, **kw))):
        t1 = time_steps(grid, make(), state)
        results["1" + suffix] = dict(step_s=t1, nodes_per_s=n_nodes / t1,
                                     efficiency=1.0)
        tn = time_steps(grid_s, make(mesh=mesh), state_s)
        results[f"{n}{suffix}"] = dict(step_s=tn, nodes_per_s=n_nodes / tn,
                                       efficiency=(t1 / tn) / cards,
                                       mesh=mesh.shape, devices=cards)
    out = {"metric": "scaling_node_steps_per_s", "grid": [grid.n_layers, nr, nc],
           "n_nodes": n_nodes, "devices": results,
           "platform": "gpu" if dev.type == "cuda" else dev.type}
    if dev.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    return out


def dryrun_mesh(n_blocks: int, dev) -> dict:
    """One ``compute_period`` hour of ``fast_f32(use_pallas=True)`` on a mesh
    of ``n_blocks`` blocks on ``dev``, on the sloped DEM at a box of at least
    128 cells that divides the mesh, with 10 mm/h of rain: the counterpart
    of the ``shard_map`` leg of ``__graft_entry__.dryrun_multichip``.
    Returns the stats, the whole-period MBR and the wall."""
    mesh = make_mesh(n_blocks, devices=[torch.device(dev)] * n_blocks)
    mr, mc = mesh.devices.shape
    n = int(np.lcm(np.lcm(mr, mc), 128))
    params = SolverParameters.fast_f32(use_pallas=True, mesh=mesh)
    grid, state = build_problem(sloped_dem(n, n), 10.0, params, dev,
                                total_depth=0.6, min_thickness=0.02,
                                max_thickness=0.1, max_thickness_depth=0.4,
                                soil=SMALL_SOIL, psi0=-1.0, rain=0.010)
    t0 = time.perf_counter()
    out, stats = compute_period_stats(shard_pytree(grid, mesh), params,
                                      shard_pytree(state, mesh), 3600.0)
    out = gather_pytree(out)
    mbr = float(out.balance_whole.mbr)
    wall = time.perf_counter() - t0
    if not (stats[0] > 0 and stats[3] > 0 and abs(mbr) < 1e-2):
        raise RuntimeError(f"dryrun_mesh: stats {stats}, whole-period MBR {mbr}")
    print(f"dryrun_mesh: {n_blocks} blocks on {dev}, mesh {mesh.shape}, grid "
          f"{grid.shape}: 1 h in {stats[0]} steps / {stats[2]} approximations / "
          f"{stats[3]} sweeps, MBR={mbr:.2e}, wall {wall:.1f} s", flush=True)
    return dict(stats=stats, mbr=mbr, wall_s=wall, shape=grid.shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_rows", type=int, nargs="?", default=64)
    ap.add_argument("n_cols", type=int, nargs="?", default=64)
    ap.add_argument("--blocks", type=int, default=4,
                    help="blocks of the mesh leg on one card")
    args = ap.parse_args()
    dev = resolve_device(None)
    print(json.dumps(scaling(args.n_rows, args.n_cols, args.blocks, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
