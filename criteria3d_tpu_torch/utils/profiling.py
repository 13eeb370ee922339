"""Device-time roll-ups of torch.profiler runs, and the card's peaks.

:func:`roll_up` is the arithmetic, a pure function of plain tuples: the
busy time as the union of the device activities, the idle share against a
wall time, and each activity's layer, found through its launch's
correlation id in the innermost host range around the launch.
:func:`device_activity` reads those tuples from a finished profiler run's
Kineto events (no trace file), and :func:`breakdown` profiles one call and
prints its roll-up.
"""

from __future__ import annotations

import dataclasses
import time

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS", "FLOPS_PER_NODE_SWEEP",
           "FLOPS_PER_NODE_NORM", "RollUp", "roll_up", "device_activity",
           "busy_by_device", "layer_ranges", "breakdown"]

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 non-tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 operations per node: one sweep (10 multiplies, 10 adds, the mask
# multiply) and the last sweep's norm (sub, 2 abs, compare, divide,
# 2 multiplies, add)
FLOPS_PER_NODE_SWEEP = 21
FLOPS_PER_NODE_NORM = 8


@dataclasses.dataclass
class RollUp:
    """What :func:`roll_up` gives: ``busy_s`` the union of the device
    activities, ``idle_share`` 1 - busy / wall, ``per_name`` {activity
    name: (seconds, count)}, ``layers`` {range name or "other": seconds},
    ``matched`` whether any activity was charged to a range, ``n`` the
    number of activities, ``overlap_s`` the parts of their durations that
    earlier activities already covered."""
    busy_s: float
    idle_share: float | None
    per_name: dict
    layers: dict
    matched: bool
    n: int
    overlap_s: float


def roll_up(device, launches, ranges, wall_s: float | None = None) -> RollUp:
    """Roll device activities up by name and by layer.

    ``device``: ``(start, end, name, correlation)`` of each device
    activity [ns]; ``launches``: {correlation: the host launch call's start
    [ns]}; ``ranges``: ``(start, end, name)`` of the host ranges that name
    layers [ns], nested or disjoint as one thread opens them. An activity
    is charged to the innermost range open at its launch, else to "other".
    A layer's time is the busy time its activities cover: where activities
    overlap, the one that started first keeps the overlap, so the layers
    sum to the busy time (the union of the activities, merged apart);
    ``overlap_s`` is the sum of the parts that earlier activities covered,
    so the durations less it are the busy time too. ``wall_s`` gives the
    idle share (None without it)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(device)),
                   key=lambda i: launches.get(device[i][3], float("-inf")))
    layer_of = ["other"] * len(device)
    stack, j, matched = [], 0, False
    for i in order:
        ts = launches.get(device[i][3])
        if ts is None:
            continue
        while j < len(ranges) and ranges[j][0] <= ts:
            stack.append(ranges[j])
            j += 1
        # launches come in time order, so a range closed before this one
        # is closed for every later launch too
        while stack and stack[-1][1] < ts:
            stack.pop()
        if stack:
            layer_of[i], matched = stack[-1][2], True
    per_name, layers = {}, {}
    covered_ns = 0
    hi = None
    for i in sorted(range(len(device)), key=lambda i: device[i][:2]):
        t0, t1, name, _ = device[i]
        s, n = per_name.get(name, (0.0, 0))
        per_name[name] = (s + (t1 - t0) * 1e-9, n + 1)
        # the part of this activity no earlier one covered
        own = max(0, t1 - (t0 if hi is None else max(t0, hi)))
        hi = t1 if hi is None else max(hi, t1)
        layers[layer_of[i]] = layers.get(layer_of[i], 0.0) + own * 1e-9
        covered_ns += (t1 - t0) - own
    # the busy union, merged apart from the own parts above (the layers
    # and the durations less the overlaps are held against it)
    busy_ns, lo, hi = 0, None, None
    for t0, t1 in sorted(d[:2] for d in device):
        if hi is None or t0 > hi:
            busy_ns += 0 if hi is None else hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    busy_ns += 0 if hi is None else hi - lo
    busy_s = busy_ns * 1e-9
    idle = None if not wall_s else 1.0 - busy_s / wall_s
    return RollUp(busy_s, idle, per_name, layers, matched, len(device),
                  covered_ns * 1e-9)


def device_activity(prof, range_names) -> tuple:
    """The raw tuples of a finished torch.profiler run, read from its
    Kineto events: ``(device, launches, ranges)`` in :func:`roll_up`'s
    form. Device activities are the kernels, copies and fills (the
    device-side copies of the host annotations left out); launches are the
    host ``cu*`` calls (cudaLaunchKernel, cudaMemcpyAsync, ...); ranges the
    host annotations named in ``range_names``."""
    from torch.autograd import DeviceType
    ranges, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                if e.name() in range_names:
                    ranges.append((e.start_ns(), e.end_ns(), e.name()))
            elif e.name().startswith("cu"):
                launches[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    return device, launches, ranges


def busy_by_device(prof) -> dict:
    """{card index: its busy seconds} of a finished torch.profiler run: the
    union of each card's own device activities (:func:`roll_up` on them),
    for a run over several cards."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            per.setdefault(e.device_index(), []).append(
                (e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
    return {card: roll_up(acts, {}, ()).busy_s for card, acts in sorted(per.items())}


def layer_ranges() -> tuple:
    """The record_function ranges that name the layers of an hour: the
    water step's assembly and inner solve, the heat sub-steps' assembly and
    solve, and the model cycle's radiation, snow, ET0 and sinks."""
    from criteria3d_tpu_torch.model import ET0_RANGE
    from criteria3d_tpu_torch.physics.crop import SINKS_RANGE
    from criteria3d_tpu_torch.physics.radiation import RADIATION_RANGE
    from criteria3d_tpu_torch.physics.snow import SNOW_RANGE
    from criteria3d_tpu_torch.solver.heat import HEAT_ASSEMBLE_RANGE, HEAT_SOLVE_RANGE
    from criteria3d_tpu_torch.solver.step import ASSEMBLE_RANGE, SOLVE_RANGE
    return (ASSEMBLE_RANGE, SOLVE_RANGE, HEAT_ASSEMBLE_RANGE, HEAT_SOLVE_RANGE,
            RADIATION_RANGE, SNOW_RANGE, ET0_RANGE, SINKS_RANGE)


def breakdown(label, run, wall_s: float, ranges=None):
    """``run()`` (one more hour) under torch.profiler: device time by
    kernel, by layer (the kernels launched inside the ranges of
    :func:`layer_ranges`, or of ``ranges``) and the device's idle share;
    prints them and returns ``(busy_s, {kernel name: seconds}, {layer:
    seconds})`` (0.0, {} and {} when the profiler saw no device activity).

    The idle share is given against the unprofiled median wall time
    ``wall_s`` (the profiler slows the host, not the kernels) and against
    the profiled hour's own wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        prof_wall_s = time.time() - t0
    r = roll_up(*device_activity(prof, ranges or layer_ranges()), wall_s)
    if not r.n:
        print(f"# {label} breakdown: the profiler saw no device activity "
              "(not measured)")
        return 0.0, {}, {}
    per_name = {k: v[0] for k, v in r.per_name.items()}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    by_layer = ("; ".join(f"{k} {v} s ({v / r.busy_s:.3f})"
                          for k, v in sorted(r.layers.items()))
                if r.matched else "not measured (no launch matched a range)")
    print(f"# {label} breakdown: {r.n} device activities per hour, device "
          f"busy {r.busy_s} s (overlaps {r.overlap_s} s); idle share {r.idle_share} of the unprofiled "
          f"{wall_s} s, {1.0 - r.busy_s / prof_wall_s} of the profiled "
          f"{prof_wall_s} s; device time by layer: " + by_layer
          + "; top: "
          + "; ".join(f"{k[:90]} {v:.4f} s ({v / r.busy_s:.3f})" for k, v in top),
          flush=True)
    return r.busy_s, per_name, r.layers
