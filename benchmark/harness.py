"""One run of one cell: set-up, the measured window, the traced readings,
the comparison with the reference, and the result line.

The run is a closed loop with one simulation at a time, as a hydrologist
runs a period or an ensemble member: the window replays the cell's
simulated period (the traffic's ``period_s``; "hour" below) from the same
initial inputs, each ended by synchronising the card and reading its
whole-period water MBR, until the first that ends at or after ``seconds``.
Every period is the same work; the readings are per simulated hour of it
(:attr:`Run.sim_hours`).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

from benchmark import check, spec
from benchmark.catchment import catchment_dem
from benchmark.peaks import roofline_share
from benchmark.trace import cuda_seconds, read_profile

# |whole-period water MBR| at or above this fails an hour: the reference's
# mass gate (tests/test_fast_f32.py)
MASS_GATE = 2e-3
# seconds of warm hours in set-up: on the card the first 4-22 s of
# sustained hours ran ~5 % slower than the rest (the card's clocks
# settling), so the window starts after them
WARM_S = 30.0
# simulated seconds of the profiled stretch after the window: the first
# ten minutes of the cell's period
PROFILE_PERIOD_S = 600.0
# the same on a mesh: the profiler slows the rounds' host enqueue ~24 x,
# so a mesh cell profiles only the period's first minute
MESH_PROFILE_PERIOD_S = 60.0
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "criteria3d_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``criteria3d_tpu_torch`` is not ``criteria3d_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_info() -> tuple[str, str]:
    """The first card's name and power limit as ``nvidia-smi`` reads them
    (``not read`` where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = out.rsplit(",", 1)
        return name.strip(), limit.strip()
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return "not read", "not read"


class Run:
    """What the metric readers read: the window's hours and walls, set-up,
    capture, each card's peak memory, the system (for the per-layer calls),
    the profiled stretch and the card's power limit."""

    def __init__(self, cell, system, on_card: bool, power_limit: str):
        self.cell, self.system, self.on_card = cell, system, on_card
        self.power_limit = power_limit
        self.hours: list = []
        self.window_s = self.setup_s = self.capture_s = 0.0
        # each card's peak over the window, in the order of system.devices
        self.peaks: list = []
        self.profile = None

    @property
    def peak_bytes(self) -> int:
        """The fullest card's peak over the window (0 off the card)."""
        return max(self.peaks, default=0)

    def profiled(self) -> dict | None:
        """The profiled stretch (:func:`_profiled_stretch`), run once, on
        the card alone; None on the CPU."""
        if self.profile is None and self.on_card:
            self.profile = _profiled_stretch(self.system)
        return self.profile

    @property
    def sim_hours(self) -> float:
        """The simulated hours the window's periods cover (exactly their
        number for a 3,600 s period)."""
        return len(self.hours) * self.system.period_s / 3600.0

    def per_hour(self, key: str) -> float:
        """The window's count ``key`` per simulated hour."""
        return sum(h[key] for h in self.hours) / self.sim_hours

    def roofline(self, call) -> float | None:
        """The share [%] of its roofline of one call of a ``benchmark/
        roofline`` module on the cell's own state: CUDA events around
        batches of back-to-back calls, against the module's count of bytes
        and operations. None off the card."""
        if not self.on_card:
            return None
        c = call.prepare(self.system)
        seconds = cuda_seconds(c.fn, c.reps)
        share, bound = roofline_share(seconds, c.read_bytes + c.write_bytes, c.flops)
        log(f"# roofline {call.__name__.rsplit('.', 1)[-1]}: {seconds * 1e3} ms a call; "
            f"reads {c.read_bytes} B, writes {c.write_bytes} B, {c.flops} flops; bound by "
            f"{bound}; {share} % of it (card power limit {self.power_limit})")
        return share


def _hour_line(i: int, rec: dict) -> str:
    extra = "".join(f" {k} {rec[k]}" for k in ("chunks", "substeps", "heat_sweeps", "rounds",
                                               "rounds_enqueued") if k in rec)
    return (f"# hour {i}: wall {rec['wall_s']} s; MBR {rec['mbr']}; (steps, attempts, "
            f"approximations, inner iterations) {rec['stats']};{extra} host reads "
            f"{rec['host_reads']}; launches {rec['launches']}")


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: str = spec.ROOT, device: torch.device | None = None) -> tuple[int, dict | None]:
    """One run; ``(exit code, result)``, the result None when the run
    cannot give one. ``device`` None is the card (cuda:0, and the cards
    the cell asks for); the tests pass the CPU. ``t_start``: the process's
    start on ``time.time()``'s clock."""
    cell = spec.cell(workload, root)
    if device is None:
        if not torch.cuda.is_available():
            log("benchmark: no CUDA card is available")
            return 3, None
        if torch.cuda.device_count() < cell.chips:
            log(f"benchmark: {workload} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible")
            return 3, None
        device = torch.device("cuda", 0)
    on_card = device.type == "cuda"
    from benchmark.system import System
    name, limit = card_info() if on_card else ("cpu", "none")
    log(f"# {workload}: seed {seed}, {seconds} s window, trace {int(trace)}; "
        f"card {name}, power limit {limit}")
    dem = catchment_dem(cell.config, seed)
    system = System(cell.config, cell.traffic, dem, device)
    log(f"# built: {system.n_nodes} nodes on {len(system.devices)} device(s); "
        f"{time.time() - t_start} s since the process started")
    r = Run(cell, system, on_card, limit)
    r.capture_s = system.capture()
    t_warm, n_warm = time.perf_counter(), 0
    while n_warm == 0 or (on_card and time.perf_counter() - t_warm < WARM_S):
        warm, out = system.hour()
        del out
        n_warm += 1
        log("# warm-up " + _hour_line(n_warm, warm)[2:])
    cards = [d for d in system.devices if d.type == "cuda"]
    system.sync()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    r.setup_s = time.time() - t_start
    while True:
        rec, out = system.hour()
        r.hours.append(rec)
        log(_hour_line(len(r.hours), rec))
        if time.perf_counter() - t0 >= seconds:
            break
        del out
    r.window_s = time.perf_counter() - t0
    r.peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    found = forbidden_modules()
    if found:
        log(f"benchmark: forbidden modules loaded: {found}")
        return 4, None
    log(f"# window: {len(r.hours)} hours in {r.window_s} s; set-up {r.setup_s} s; "
        f"capture {r.capture_s} s; peak {r.peak_bytes} B (each card {r.peaks})")
    metrics = {}
    readers = [(m, spec.reader(m, root)) for m in (cell.per_layer if trace else cell.end_to_end)]
    # the profiler slows the CUDA calls after it: its readers come last
    readers.sort(key=lambda mr: bool(getattr(mr[1], "PROFILE", False)))
    for m, rd in readers:
        value = rd.read(r)
        if value is not None:
            metrics[m] = {"value": value, "unit": rd.UNIT}
    result = {"correct": False, "attempted": len(r.hours),
              "failed": sum(1 for h in r.hours
                            if not math.isfinite(h["mbr"]) or abs(h["mbr"]) >= MASS_GATE),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": cell.chips,
                         "memory_peak_bytes": r.peak_bytes}}
    if system.mesh is not None:
        result["device"]["memory_peak_bytes_per_card"] = r.peaks
    if trace and r.profiled() is not None:
        p = r.profile
        # averaged over the cards the period runs on, a card the profiler
        # saw nothing on counting 0
        busy = [p["busy_s"].get(d.index, 0.0) for d in cards]
        result["device"].update(busy_s=sum(busy) / len(busy), window_s=p["wall_s"])
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    program = system.outputs(out)
    del out
    system.free()
    from benchmark.reference.storm import run_period, storage_of
    t_ref = time.perf_counter()
    reference = run_period(cell.config, cell.traffic, dem, device)
    t_count = time.perf_counter()
    # the program's heads counted on the grid the reference ran on
    storage = storage_of(cell.config, reference.pop("grid"), program["h"])
    log(f"# reference: {t_count - t_ref} s, its count of the heads' water "
        f"{time.perf_counter() - t_count} s; stats {reference['stats']}; "
        f"MBR {reference['mbr']}; program's last hour stats {r.hours[-1]['stats']}; "
        f"storage reported {program['storage']} m3, its heads' {storage} m3")
    correct, table = check.judge(check.gaps(program, reference, storage),
                                 cell.config.get("limits"))
    result["correct"] = correct
    for k, v in table.items():
        log(f"check {k}: {v['value']} limit {v['limit']}")
    result["checks"] = table
    return 0, result


def _profiled_stretch(system) -> dict:
    """The first ``PROFILE_PERIOD_S`` simulated seconds of the cell's
    period (``MESH_PROFILE_PERIOD_S`` on a mesh) once more under
    torch.profiler, after every other reading of the program (the profiler
    slows the host's CUDA calls in it and after it). Returns each card's
    busy seconds, the top device operations, the longest idle gaps and the
    profiled stretch's wall (``wall_s``)."""
    from torch.profiler import ProfilerActivity, profile
    stretch = min(MESH_PROFILE_PERIOD_S if system.mesh is not None else PROFILE_PERIOD_S,
                  system.period_s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rec, out = system.hour(stretch)
        wall = time.perf_counter() - t0
    del out
    log(f"# profiled stretch: wall {wall} s; reading the trace")
    p = read_profile(prof)
    p.update(wall_s=wall, hour=rec)
    log(f"# profiled stretch: each card's busy {p['busy_s']} s of the same stretch's "
        f"wall {wall} s")
    return p


def result_line(result: dict) -> str:
    """The result as the last line of standard output (``checks``, added
    last, comes last)."""
    return json.dumps(result)
