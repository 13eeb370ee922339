"""Device-time roll-up of the coupled water + heat storm hour, on the card.

    python -m criteria3d_tpu_torch.trace_coupled [coarsen]

Counterpart of ``scripts/trace_coupled.py``: the coupled leg of the port's
bench (``bench.coupled_setup``: the storm hour with soil heat, vapor,
chunk-frozen properties) on the bench's DEM coarsened ``coarsen`` times
(default 4), once warm (graph-driven on the card, as the bench runs it),
then once under ``torch.profiler`` under the eager driver
(``device_loop.forced_eager``: a replayed CUDA graph shows the profiler its
kernels but not the units' ranges, so the layers need the same kernels
launched from Python). The device time is rolled up by the port's layer
ranges (water assembly, water inner solve, heat assembly, heat solve,
other) where the JAX script buckets HLO names; the top 30 kernels with
their counts, the device total and the idle share of the warm run follow.
The sub-step and sweep counts come from the coupled step's own counters
(``coupled.counts()``). The last line is one JSON object with the roll-up,
the counts, the profiled hour's driver and the card's name and power
limit.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from criteria3d_tpu_torch import bench
from criteria3d_tpu_torch.device import host_read, resolve_device
from criteria3d_tpu_torch.solver import coupled as C
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver.heat import HEAT_ASSEMBLE_RANGE, HEAT_SOLVE_RANGE
from criteria3d_tpu_torch.solver.step import ASSEMBLE_RANGE, SOLVE_RANGE
from criteria3d_tpu_torch.utils.profiling import device_activity, roll_up

__all__ = ["LAYERS", "traced_hour", "trace", "main"]

# the roll-up's layers and the host range each one reads
LAYERS = {"water assembly": ASSEMBLE_RANGE, "water inner solve": SOLVE_RANGE,
          "heat assembly": HEAT_ASSEMBLE_RANGE, "heat solve": HEAT_SOLVE_RANGE}


def traced_hour(inputs, wall_s: float | None = None) -> dict:
    """One coupled hour of ``inputs`` (``bench.coupled_setup``'s) under the
    eager driver (``device_loop.forced_eager``) and torch.profiler, its
    counts set to 0 just before: the busy time, idle share (against
    ``wall_s``, else the profiled wall), device time by layer
    (:data:`LAYERS` and "other", summing to the busy time; the activities'
    own durations summed in ``durations_s``, what they add beyond the busy
    time in ``overlap_s``, whether any activity was charged to a layer's
    range in ``matched``), the top 30 kernels as ``[name, seconds,
    count]``, the coupled step's counts and host reads, the hour's
    ``(water, heat)`` (``out``) and its peak device memory (``peak_gib``;
    None off the card). On the CPU the hour runs unprofiled (there is no
    device activity to record): every time is 0."""
    from torch.profiler import ProfilerActivity, profile
    hparams, grid, water, heat, boundary = inputs
    dev = grid.device
    box = {}

    def hour():
        C.reset_counts()
        host_read.count = 0
        t0 = time.perf_counter()
        box["out"] = C.compute_period_coupled(grid, hparams, water, heat, boundary, 3600.0)
        bench.sync(dev)
        return time.perf_counter() - t0

    with device_loop.forced_eager():
        if dev.type == "cuda":
            bench.sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                prof_wall_s = hour()
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            events = device_activity(prof, tuple(LAYERS.values()))
        else:
            prof_wall_s, events, peak = hour(), ([], {}, []), None
    counts, reads = C.counts(), host_read.count
    r = roll_up(*events, wall_s or prof_wall_s)
    layers = {k: r.layers.get(v, 0.0) for k, v in LAYERS.items()}
    layers["other"] = r.layers.get("other", 0.0)
    top = sorted(r.per_name.items(), key=lambda kv: -kv[1][0])[:30]
    return dict(busy_s=r.busy_s, overlap_s=r.overlap_s, idle_share=r.idle_share,
                durations_s=sum(v[0] for v in r.per_name.values()), matched=r.matched,
                wall_s=wall_s, profiled_wall_s=prof_wall_s, activities=r.n, layers=layers,
                top=[[k, s, n] for k, (s, n) in top], counts=counts, host_reads=reads,
                driver="eager", out=box["out"], peak_gib=peak)


def trace(coarsen: int = 4, device=None, dem=None) -> dict:
    """The coupled hour on the bench's grid at ``coarsen`` (on ``dem``,
    ``bench.load_dem()`` when None): once warm, after a zero-length period
    (the graphs' capture on the card), its wall the idle share's reference;
    then :func:`traced_hour`."""
    dev = resolve_device(device)
    grid = bench.build_grid(coarsen, dev, dem)
    inputs = bench.coupled_setup(grid, bench.storm_params({}), {})
    hparams, hgrid, water, heat, boundary = inputs
    C.compute_period_coupled(hgrid, hparams, water, heat, boundary, 0.0)
    bench.sync(dev)
    t0 = time.perf_counter()
    C.compute_period_coupled(hgrid, hparams, water, heat, boundary, 3600.0)
    bench.sync(dev)
    warm_s = time.perf_counter() - t0
    out = traced_hour(inputs, warm_s)
    del out["out"]
    out.update(coarsen=coarsen, n_nodes=grid.n_nodes,
               platform="gpu" if dev.type == "cuda" else dev.type)
    return out


def main() -> int:
    coarsen = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    try:
        dev = resolve_device(None)
    except RuntimeError as e:
        print(f"trace_coupled: {e}", file=sys.stderr)
        return 2
    out = trace(coarsen, dev)
    out["card"], out["power_limit_w"] = bench.card_info()
    counts = out["counts"]
    print(f"coupled hour, coarsen {coarsen} ({out['n_nodes']} nodes) on {out['card']}: "
          f"warm {out['wall_s']} s, traced (eager-driven) {out['profiled_wall_s']} s; "
          f"water stats "
          f"({counts['steps']}, {counts['attempts']}, {counts['approximations']}, "
          f"{counts['inner_iterations']}), heat chunks {counts['chunks']}, sub-steps "
          f"{counts['substeps_accepted']} + {counts['substeps_rejected']} rejected, heat "
          f"sweeps {counts['heat_sweeps']}, host reads {out['host_reads']}")
    busy = out["busy_s"]
    print(f"\ndevice total: {busy} s busy in {out['activities']} activities (overlaps "
          f"{out['overlap_s']} s); idle share {out['idle_share']} of the warm run")
    print("\n-- layers --")
    for k, v in out["layers"].items():
        print(f"  {k:18s} {v:9.4f} s  {100 * v / max(busy, 1e-30):5.1f}%")
    print("\n-- top 30 kernels --")
    for name, s, n in out["top"]:
        print(f"  {s:8.4f} s  x{n:<7d} {name[:90]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
