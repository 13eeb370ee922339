"""The comparison that decides ``correct``: the program's last timed hour
against the plain reference's hour on the same DEM.

Each number is a gap between two readings and has a limit of its own, set
in the configuration file (``limits``) from readings on the card: the
largest of sound runs (the program over a dozen seeds or more, and the
reference on the catchment turned to each of its other orientations, which
changes only the order of its float32 sums) and the smallest of the
control (:func:`benchmark.reference.precision.lowered`). PERF.md gives the
readings behind each limit.

The heads are compared by their 99th percentile gap, not their largest: any
change in the order of the float32 sums moves the adaptive steps, and with
them the wetting fronts, so sound runs move a few heads by centimetres, as
far as the control does; the bulk of the field they leave within a few
hundredths of a millimetre, where the control moves it by millimetres. A
single wrong head the storage gap sees: the reference counts the water the
program's heads hold and holds it to the storage the program reports.
"""

from __future__ import annotations

import math

import torch

WATER = ("h_p99_m", "se_p99", "storage_gap_m3")
HEAT = ("heat_sink_rel",)


def p99(gap: torch.Tensor) -> float:
    """The nearest-rank 99th percentile of a 1-d tensor."""
    k = max(1, math.ceil(0.99 * gap.numel()))
    return float(torch.kthvalue(gap, k).values)


def gaps(program: dict, reference: dict, storage: float) -> dict:
    """The numbers compared: the 99th percentile head and saturation gaps
    over the reference's valid nodes; the gap between the water storage
    the program reports and ``storage``, the water its heads hold as the
    reference counts it (:func:`benchmark.reference.storm.storage_of`);
    and, with soil heat, the gap of the hour's boundary heat sinks over
    the reference's (at least 1 W s)."""
    mask = reference["mask"]
    out = {
        "h_p99_m": p99((program["h"].double() - reference["h"]).abs()[mask]),
        "se_p99": p99((program["se"].double() - reference["se"]).abs()[mask]),
        "storage_gap_m3": abs(program["storage"] - storage),
    }
    if "t" in reference:
        out["heat_sink_rel"] = (abs(program["heat_sink"] - reference["heat_sink"])
                                / max(abs(reference["heat_sink"]), 1.0))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every number
    is finite and at most its limit; a number without a limit fails."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name) if limits else None
        table[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and math.isfinite(value) and value <= limit
    return ok, table
