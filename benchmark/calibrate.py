"""The readings that the comparison's limits are set from, on the card:

    python3 -m benchmark.calibrate --workload <cell> [--seeds 0,1,...]
        [--orientations 1,2,...] [--control-orientations 0,1,2]

One JSON line a reading on standard output, each with the compared numbers
(:func:`benchmark.check.gaps`), their verdict under the configuration's
limits (:func:`benchmark.check.judge`) and, for the record, numbers that
are not compared (the largest head and temperature gaps, the temperature
gap's 99th percentile and the gap of the whole-period water MBRs):

- ``program``: for each seed, the cell's set-up and one timed hour of the
  program (the window's own call) against the plain reference on the same
  DEM (lower readings);
- ``witness``: for each orientation (1-7: quarter turns, then mirrored), the
  reference on the catchment turned so and its outputs turned back, against
  the reference on the catchment as it is: a sound run that differs from it
  only in the order of its float32 sums (lower readings too);
- ``control``: for each orientation, the control (the reference with its
  float64 accumulations in float32, :func:`benchmark.reference.precision.
  lowered`) against the reference on the same turned catchment (upper
  readings).

Every count of the heads' water (:func:`benchmark.reference.storm.
storage_of`) is made on the grid that a reference period built: the
program's heads and a witness's on the grid of the reference on the
catchment as it is, the control's on its own. Between counts the kept
grid waits in host memory, so that the card holds one period at a time.
Runs on the first visible card; on a host of several cards, one process a
card (``CUDA_VISIBLE_DEVICES``) reads its share of the orientations.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import check, spec
from benchmark.catchment import catchment_dem


def turn(dem: np.ndarray, k: int) -> np.ndarray:
    """The DEM in orientation ``k`` (0-7): ``k % 4`` quarter turns, mirrored
    for ``k >= 4``."""
    a = dem[:, ::-1] if k >= 4 else dem
    return np.ascontiguousarray(np.rot90(a, k % 4))


def turn_back(x: torch.Tensor, k: int) -> torch.Tensor:
    """A (layers, rows, cols) output of orientation ``k`` in the DEM's own."""
    x = torch.rot90(x, -(k % 4), dims=(-2, -1))
    return x.flip(-1) if k >= 4 else x


def _record(run: dict, ref: dict, storage: float, limits: dict) -> dict:
    gaps = check.gaps(run, ref, storage)
    correct, _ = check.judge(gaps, limits)
    mask = ref["mask"]
    also = {"h_max_m": float((run["h"].double() - ref["h"]).abs()[mask].max()),
            "water_mbr_gap": abs(run["mbr"] - ref["mbr"])}
    if "t" in ref:
        soil = mask.clone()
        soil[0] = False
        t = (run["t"].double() - ref["t"]).abs()[soil]
        also.update(t_max_K=float(t.max()), t_p99_K=check.p99(t))
    return dict(gaps=gaps, correct=correct, also=also, stats=run["stats"],
                ref_stats=ref["stats"], storage=run["storage"], heads_storage=storage)


def readings(workload: str, seeds=(), orientations=(), control_orientations=(),
             device=None, root: str = spec.ROOT):
    """Yield one dict a reading (see the module's text)."""
    from benchmark.reference.device import map_tensors
    from benchmark.reference.storm import run_period, storage_of
    cell = spec.cell(workload, root)
    limits = cell.config.get("limits")
    device = device or torch.device("cuda", 0)
    dem = catchment_dem(cell.config, 0)
    refs = {}

    def period(k, lowered=False):
        """The reference (the control if ``lowered``) on orientation ``k``,
        on a card cleared of the blocks the run before it cached: at 4352 a
        period fills ~73 of the card's 80 GB, and a second one ran out of
        memory in the first one's fragments."""
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return run_period(cell.config, cell.traffic, turn(dem, k), device, lowered=lowered)

    def reference(k):
        if k not in refs:
            out = period(k)
            grid = out.pop("grid")
            if k == 0:
                out["grid"] = map_tensors(grid, lambda t: t.to("cpu"))
            refs[k] = out
        return refs[k]

    def counted(h):
        """``h``'s water on the grid of the reference on the catchment as
        it is."""
        return storage_of(cell.config, map_tensors(reference(0)["grid"],
                                                   lambda t: t.to(device)), h)

    for seed in seeds:
        from benchmark.system import System
        d = catchment_dem(cell.config, seed)
        system = System(cell.config, cell.traffic, d, device)
        system.capture()
        rec, out = system.hour()
        program = dict(system.outputs(out), stats=rec["stats"])
        del out
        system.free()
        yield dict(kind="program", seed=seed, hour_s=rec["wall_s"],
                   **_record(program, reference(0), counted(program["h"]), limits))
    for k in orientations:
        t0 = time.perf_counter()
        turned = dict(reference(k))
        for key in ("h", "se", "t"):
            if key in turned:
                turned[key] = turn_back(turned[key], k)
        storage = counted(turned["h"])
        yield dict(kind="witness", orientation=k, reference_s=time.perf_counter() - t0,
                   **_record(turned, reference(0), storage, limits))
    for k in control_orientations:
        t0 = time.perf_counter()
        control = period(k, lowered=True)
        storage = storage_of(cell.config, control.pop("grid"), control["h"])
        yield dict(kind="control", orientation=k, control_s=time.perf_counter() - t0,
                   **_record(control, reference(k), storage, limits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--orientations", default="")
    ap.add_argument("--control-orientations", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card is available", file=sys.stderr)
        return 3
    ints = lambda s: [int(x) for x in s.split(",") if x]   # noqa: E731
    for r in readings(args.workload, ints(args.seeds), ints(args.orientations),
                      ints(args.control_orientations)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
