"""Whether the float32 bundle path's drainage hours at dt = 1 s are the
port's or the JAX package's: the bench's day under ``BENCH_PALLAS=1``
(``fast_f32(use_pallas=True)``, the bundled Jacobi solver) on the bench's
synthetic catchment coarsened 16 times (a 48 box, 11,536 nodes), on the
CPU.

    JAX_PLATFORMS=cpu python -m tests.bundle_drainage [hours]

The port runs the storm's 3 hours from the storm's initial state; its
state at the end of the storm is carried into the JAX package, and both
then run the next ``hours`` hours (default 2: the rain stopped, 6 periods
of 600 s each, the plain twin of the bundle on the port's side and the
Pallas kernel in interpret mode on JAX's). For each hour it prints every
period's (steps, attempts, approximations, sweeps) in both packages, the
dt they end on, the largest head difference and the whole-period MBRs.
It takes about ten minutes, most of it the second drainage hour.
"""

import dataclasses
import sys
import time

import jax.numpy as jnp
import numpy as np
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver.step import compute_period_stats as j_period_stats
from criteria3d_tpu_torch import bench, problems
from criteria3d_tpu_torch.solver.step import compute_period_stats as t_period_stats
from tests.test_torch_bench import jax_grid

COARSEN = 16
STORM_HOURS = 3


def jax_state(ts):
    """The port's WaterState as the JAX package's, field by field."""
    def balance(b):
        return J.BalanceData(*(jnp.asarray(getattr(b, f).numpy())
                               for f in ("storage", "sink_source", "mbe", "mbr")))
    return J.WaterState(**{
        f.name: (balance(getattr(ts, f.name)) if f.name.startswith("balance_")
                 else jnp.asarray(getattr(ts, f.name).numpy()))
        for f in dataclasses.fields(ts)})


def hour(period_stats, grid, params, state):
    """An hour of 6 periods of 600 s: (state, each period's stats, wall)."""
    t0, stats = time.time(), []
    for _ in range(6):
        state, st = period_stats(grid, params, state, 600.0)
        stats.append(tuple(int(s) for s in st))
    return state, stats, time.time() - t0


def main() -> int:
    hours = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    torch.set_num_threads(2)
    dem = bench.load_dem()
    tg = bench.build_grid(COARSEN, "cpu", dem)
    jg = jax_grid(bench.coarsen_dem(dem.values, dem.nodata, COARSEN), dem.cell * COARSEN)
    assert int(jg.n_nodes) == tg.n_nodes
    tp = bench.storm_params({"BENCH_PALLAS": "1"})
    jp = J.SolverParameters.fast_f32(use_pallas=True, inner_solver="jacobi")
    ts = problems.storm_state(tg, tp)
    for h in range(STORM_HOURS):
        ts, stats, wall = hour(t_period_stats, tg, tp, ts)
        print(f"storm hour {h} (port, {wall:.1f} s): {stats}", flush=True)
    ts = dataclasses.replace(ts, sink_source=torch.zeros_like(ts.sink_source))
    js = jax_state(ts)
    print(f"{dem.name} coarsened {COARSEN} ({tg.n_nodes} nodes); both packages from "
          f"the port's state after hour {STORM_HOURS - 1}, the rain stopped", flush=True)
    for h in range(STORM_HOURS, STORM_HOURS + hours):
        js, jstats, jwall = hour(j_period_stats, jg, jp, js)
        ts, tstats, twall = hour(t_period_stats, tg, tp, ts)
        dh = float(np.abs(ts.h.numpy() - np.asarray(js.h)).max())
        print(f"hour {h}:\n  jax  {jstats} sum {[sum(c) for c in zip(*jstats)]} dt "
              f"{float(js.dt_curr)} s ({jwall:.1f} s)\n  port {tstats} sum "
              f"{[sum(c) for c in zip(*tstats)]} dt {float(ts.dt_curr)} s ({twall:.1f} s)"
              f"\n  max |dh| {dh} m; whole-period MBR jax {float(js.balance_whole.mbr)} "
              f"port {float(ts.balance_whole.mbr)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
