"""Device busy time and idle gaps from a torch.profiler run, and CUDA-event
timing of a call: the arithmetic of the port's ``utils/profiling.roll_up``
(busy as the union of a card's device activities) and of its kernel timing
(``bench_jacobi.cuda_ms``), copied so that the yardstick does not move with
the program."""

from __future__ import annotations

import statistics


def union_s(spans) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` spans."""
    busy, lo, hi = 0, None, None
    for t0, t1 in sorted(spans):
        if hi is None or t0 > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = t0, t1
        else:
            hi = max(hi, t1)
    busy += 0 if hi is None else hi - lo
    return busy * 1e-9


def gaps(spans, top: int):
    """The ``top`` longest idle gaps between the union of ``spans``:
    ``(seconds, start_ns, end_ns)``, longest first."""
    out, hi = [], None
    for t0, t1 in sorted(spans):
        if hi is not None and t0 > hi:
            out.append(((t0 - hi) * 1e-9, hi, t0))
        hi = t1 if hi is None else max(hi, t1)
    return sorted(out, reverse=True)[:top]


def read_profile(prof, top: int = 10) -> dict:
    """Of a finished torch.profiler run over the cards: each card's busy
    seconds, the device operations that took most time (summed over the
    cards) and the longest idle gaps of the first card, each named by the
    host call that ended it (the launch or copy the card waited for)."""
    from torch.autograd import DeviceType
    per_card, by_name = {}, {}
    launches = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            per_card.setdefault(e.device_index(), []).append((e.start_ns(), e.end_ns()))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) * 1e-9
        elif e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            launches.append((e.start_ns(), e.name()))
    busy = {card: union_s(spans) for card, spans in sorted(per_card.items())}
    launches.sort()
    idle = []
    if per_card:
        first = per_card[min(per_card)]
        for sec, _, end in gaps(first, top):
            # the last host runtime call that started before the gap ended
            name = "nothing on the host"
            lo, hi = 0, len(launches)
            while lo < hi:
                mid = (lo + hi) // 2
                if launches[mid][0] <= end:
                    lo = mid + 1
                else:
                    hi = mid
            if lo:
                name = f"host: {launches[lo - 1][1]}"
            idle.append([name, sec])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy, device_ops=[[k, v] for k, v in ops], idle_gaps=idle)


def cuda_seconds(fn, reps: int, batches: int = 5, warmup: int = 3) -> float:
    """Seconds of one ``fn()`` on the current card: CUDA events around a
    batch of ``reps`` back-to-back calls, divided by ``reps``; the median
    of ``batches`` batches, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / reps)
    return statistics.median(times)
