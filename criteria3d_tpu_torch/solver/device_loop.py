"""The two drivers of the water period's state machine.

Counterpart of the JAX package's execution model: ``compute_period_stats``
(criteria3d_tpu/solver/step.py:639-700) and ``compute_period_coupled``
(criteria3d_tpu/solver/coupled.py:225) are each one ``jax.jit`` over nested
``lax.while_loop``s whose scalar carries stay on the device. The port flattens
each nest into one state machine (solver/step.py's ``_Machine``, and
solver/coupled.py's ``_CoupledMachine``, which adds the heat sub-stepping's
units to it): its carries are 0-d tensors on the device and a ``phase``
among them names the unit of work that runs next. This module runs the
units.

- **The graph driver** (a CUDA device, no mesh). Each unit is
  captured as a CUDA graph of its own (one memory pool shared by all, so the
  temporaries of one unit reuse another's); ``csrc/graph_machine.cu`` joins
  them into one graph, a WHILE node over a SWITCH on the phase, that runs up
  to :data:`UNITS_PER_LAUNCH` units per launch and returns when the phase
  reads DONE. The host reads the machine's status (the phase, the period's
  stats and the counts kept on the card) once per launch. The captured
  machine is kept for the next period of the same key (the kind of
  machine, grid, parameters and shapes; one at a time: a new key drops the
  old machine first); a period's inputs are copied into its buffers.
- **The eager driver** runs the same units in Python. It reads the
  machine's int carries after each unit that decides its next phase from
  data (an assembly's Courant test, an iteration's stop, a balance, an
  attempt's end); after the others it takes the next phase from
  ``_Machine.follows`` without a read. It serves the CPU and a mesh
  (``bmap`` over blocks, which stays host-driven until its own slice);
  :func:`forced_eager` asks for it on the card (to compare the drivers).

There is no fallback between them: on the card without a mesh the graph
driver runs or raises (a failed capture, a host synchronisation inside a
unit, a toolkit without CUDA 12.8's SWITCH nodes).

``UNITS_PER_LAUNCH`` is 1024: a storm hour of the main path runs 1,100-2,200
units (CG iterations, sweeps or bundles, and the step's own units), so it
takes 2-3 launches and as many host reads, and a launch of CG-line units
(~2 ms each on an H100) returns to the host within ~2 s; the coupled storm
hour, with its 5,513 heat sweeps, takes 8 launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time

import torch

from criteria3d_tpu_torch.device import host_array, tallies_on_device
from criteria3d_tpu_torch.utils import buildcache

__all__ = ["UNITS_PER_LAUNCH", "run_period", "driver_for", "forced_eager",
           "counts", "reset_counts", "clear", "build_library", "SOURCE"]

UNITS_PER_LAUNCH = 1024

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graph_machine.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_force_eager = [False]
_cache: list = []     # at most one (key, _GraphMachine)
_COUNT_NAMES = ("graph_periods", "eager_periods", "launches", "eager_units",
                "eager_reads", "captures", "capture_s")
_counts = dict.fromkeys(_COUNT_NAMES, 0)


def reset_counts() -> None:
    """Set the drivers' counts to 0 (see :func:`counts`)."""
    _counts.update(dict.fromkeys(_COUNT_NAMES, 0))


def counts() -> dict:
    """Since the last :func:`reset_counts`: periods (and steps) run by each
    driver, the graph driver's launches, the eager driver's units and host
    reads, the captures made and their seconds, plus
    ``units_per_launch``."""
    return dict(_counts, units_per_launch=UNITS_PER_LAUNCH)


@contextlib.contextmanager
def forced_eager():
    """Within the block every period runs under the eager driver, on the
    card too (the graph driver's reference in the card's checks)."""
    _force_eager[0] = True
    try:
        yield
    finally:
        _force_eager[0] = False


def driver_for(device: torch.device, mesh) -> tuple[str, str]:
    """``("graph", "")`` where the graph driver runs (the water and the
    coupled period alike), else ``("eager", why)``."""
    if _force_eager[0]:
        return "eager", "asked for (device_loop.forced_eager)"
    if device.type != "cuda":
        return "eager", f"a {device.type} device: CUDA graphs run on the card only"
    if mesh is not None:
        return "eager", "a mesh: the blocks' step stays host-driven until its own slice"
    return "graph", ""


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/graph_machine.cu`` into ``build/`` (keyed as
    ``jacobi_bundle.build_library`` keys its library) and return its path."""
    return buildcache.build_cuda_library(BUILD_DIR, "graph_machine", SOURCE, NVCC_FLAGS,
                                         verbose)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.c3d_machine_build.argtypes = [I, P, P, LL, P, I, P]
    lib.c3d_machine_build.restype = I
    lib.c3d_machine_launch.argtypes = [P, P]
    lib.c3d_machine_launch.restype = I
    lib.c3d_machine_destroy.argtypes = [P]
    lib.c3d_machine_destroy.restype = I
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph machine: {what} failed: CUDA error {err}")


class _GraphMachine:
    """A machine with its units captured and joined into one executable
    graph over the machine's own buffers."""

    def __init__(self, machine):
        self.machine = machine
        self.lib = _library()
        device = machine.home
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        machine.prepare_capture()
        pool = torch.cuda.graph_pool_handle()
        self.graphs = {}
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        slots = {(fn, attr): machine.status[k] for fn, attr, k in machine.tallies()}
        with torch.cuda.stream(stream), tallies_on_device(slots):
            for code, (name, unit) in machine.units().items():
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                graph.capture_begin(pool=pool)
                try:
                    unit()
                except Exception as e:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise RuntimeError(
                        f"graph machine: capturing unit {name!r} failed; a unit may "
                        f"not read the device from the host ({e})") from e
                graph.capture_end()
                self.graphs[code] = graph
        torch.cuda.current_stream(device).wait_stream(stream)
        n_cases = max(self.graphs) + 1
        raw = (ctypes.c_void_p * n_cases)(
            *[self.graphs[c].raw_cuda_graph() if c in self.graphs else None
              for c in range(n_cases)])
        self.count = torch.zeros(1, dtype=torch.int32, device=device)
        exec_ = ctypes.c_void_p()
        _check(self.lib.c3d_machine_build(
            n_cases, raw, machine.status[0].data_ptr(), machine.DONE,
            self.count.data_ptr(), UNITS_PER_LAUNCH, ctypes.byref(exec_)),
            "building the graph (SWITCH and WHILE nodes need CUDA 12.8)")
        self.exec = exec_
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def run(self):
        """Launch until the phase reads DONE; the status read after the last
        launch, with the counts kept on the card folded into the host's."""
        m = self.machine
        stream = torch.cuda.current_stream(m.home).cuda_stream
        while True:
            _check(self.lib.c3d_machine_launch(self.exec, stream), "a launch")
            _counts["launches"] += 1
            status = host_array(m.status)
            if status[0] == m.DONE:
                break
        for fn, attr, k in m.tallies():
            setattr(fn, attr, getattr(fn, attr) + int(status[k]))
        return status

    def close(self) -> None:
        if self.exec is not None:
            _check(self.lib.c3d_machine_destroy(self.exec), "destroying the graph")
            self.exec = None


def clear() -> None:
    """Drop the kept graph machine (its buffers and memory pool)."""
    while _cache:
        _, gm = _cache.pop()
        gm.close()


def _read_ints(machine):
    _counts["eager_reads"] += 1
    return host_array(machine.i.buffer)


def _run_eager(machine):
    units, follows = machine.units(), machine.follows()
    phase, ints = machine.first_phase, None
    while True:
        # after a decision from data, and at the end (the period's counts)
        if phase is None or phase == machine.DONE:
            ints = _read_ints(machine)
            phase = int(ints[0])
            if phase == machine.DONE:
                return ints[:len(machine.status)]
        units[phase][1]()
        _counts["eager_units"] += 1
        nxt = follows.get(phase)
        phase = (None if nxt is None else nxt if isinstance(nxt, int)
                 else int(ints[machine.i.index[nxt]]))


def run_period(key, build, load, device: torch.device, mesh=None):
    """Run one period (or step) of the machine to DONE and return
    ``(machine, status)``: ``build()`` makes the machine (under the graph
    driver only when ``key`` has none kept), ``load(machine)`` copies the
    period's inputs into its buffers."""
    driver, _ = driver_for(device, mesh)
    if driver == "eager":
        machine = build()
        load(machine)
        _counts["eager_periods"] += 1
        return machine, _run_eager(machine)
    if not (_cache and _cache[0][0] == key):
        clear()
        gm = _GraphMachine(build())
        _counts["captures"] += 1
        _counts["capture_s"] += gm.capture_s
        _cache.append((key, gm))
    gm = _cache[0][1]
    load(gm.machine)
    _counts["graph_periods"] += 1
    return gm.machine, gm.run()
