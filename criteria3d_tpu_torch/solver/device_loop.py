"""The two drivers of the port's state machines.

Counterpart of the JAX package's execution model: ``compute_period_stats``
(criteria3d_tpu/solver/step.py:639-700) and ``compute_period_coupled``
(criteria3d_tpu/solver/coupled.py:225) are each one ``jax.jit`` over nested
``lax.while_loop``s whose scalar carries stay on the device (on a mesh one
``jax.jit`` under GSPMD), and HYDRALL's and the vine's assimilation fixed
points are one ``lax.while_loop`` each. The port flattens each loop nest
into one state machine (solver/step.py's ``_Machine``, solver/coupled.py's
``_CoupledMachine``, which adds the heat sub-stepping's units to it, and
physics/fixed_point.py's ``FixedPoint``): its carries are 0-d tensors on the
device and a ``phase`` among them names the unit of work that runs next.
This module runs the units.

- **The graph driver** (a CUDA device: one tensor or the blocks of a mesh
  whose blocks all lie on its home card). Each unit is captured as a CUDA
  graph of its own; ``csrc/graph_machine.cu`` joins them into one graph, a
  WHILE node over a SWITCH on the phase, that runs up to
  :data:`UNITS_PER_LAUNCH` units per launch and returns when the phase reads
  DONE. The host reads the machine's status (the phase, the stats and the
  counts kept on the card) once per launch. Captured machines are kept for
  the next run of the same key (the kind of machine, grid, parameters and
  shapes), at most :data:`MAX_MACHINES` of them, the least recently run
  dropped first; a run's inputs are copied into the machine's buffers.
- **The eager driver** runs the same units in Python. It reads the
  machine's int carries after each unit that decides its next phase from
  data (an assembly's Courant test, an iteration's stop, a balance, an
  attempt's end); after the others it takes the next phase from the
  machine's ``follows()`` without a read. It serves the CPU and a mesh over
  several cards (a capture on the home card does not take the other cards'
  work); :func:`forced_eager` asks for it on the card (to compare the
  drivers).

There is no fallback between them: where :func:`driver_for` names the graph
driver it runs or raises (a failed capture, a host synchronisation inside a
unit, a toolkit without CUDA 12.8's SWITCH nodes).

Memory: every kept machine holds its buffers (about what one run's inputs
and carries take: a water or coupled machine's state, system and solver
vectors, a fixed point's inputs and per-cell carries), and all of them share
one graph memory pool per card, which holds the temporaries of the largest
unit once (every value a unit hands on lives in a buffer, so one unit's
temporaries may reuse another's, in any machine). A model hour keeps 2-4
machines: the water or coupled period's and one for each shape of a fixed
point.

``UNITS_PER_LAUNCH`` is 1024: a storm hour of the main path runs 1,100-2,200
units (CG iterations, sweeps or bundles, and the step's own units), so it
takes 2-3 launches and as many host reads, and a launch of CG-line units
(~2 ms each on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §5) returns to
the host within ~2 s; the coupled storm hour, with its 5,513 heat sweeps,
takes 8 launches; a fixed point of up to 4,096 iterations, 4 a unit,
takes one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import os
import time

import torch

from criteria3d_tpu_torch.device import host_array, tallies_on_device
from criteria3d_tpu_torch.utils import buildcache

__all__ = ["UNITS_PER_LAUNCH", "MAX_MACHINES", "Slots", "run_period", "driver_for",
           "forced_eager", "counts", "reset_counts", "clear", "build_library", "SOURCE"]

UNITS_PER_LAUNCH = 1024
# the kept graph machines (see the module docstring for their memory)
MAX_MACHINES = 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graph_machine.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_force_eager = [False]
_cache: collections.OrderedDict = collections.OrderedDict()   # key -> _GraphMachine
_pools: dict = {}     # card -> the graph memory pool every kept machine shares
_COUNT_NAMES = ("graph_periods", "eager_periods", "graph_fixed_points",
                "eager_fixed_points", "launches", "eager_units", "eager_reads",
                "captures", "capture_s")
_counts = dict.fromkeys(_COUNT_NAMES, 0)


class Slots:
    """Named 0-d views of one buffer on the device (a machine's scalar
    carries)."""

    def __init__(self, names, dtype, device):
        self.buffer = torch.zeros(len(names), dtype=dtype, device=device)
        self.index = {name: k for k, name in enumerate(names)}
        for k, name in enumerate(names):
            setattr(self, name, self.buffer[k])

    def span(self, first: str, n: int) -> torch.Tensor:
        """The ``n`` slots from ``first`` on, as one view."""
        k = self.index[first]
        return self.buffer[k:k + n]


def reset_counts() -> None:
    """Set the drivers' counts to 0 (see :func:`counts`)."""
    _counts.update(dict.fromkeys(_COUNT_NAMES, 0))


def counts() -> dict:
    """Since the last :func:`reset_counts`: periods (and steps) and fixed
    points run by each driver, the graph driver's launches, the eager
    driver's units and host reads, the captures made and their seconds,
    plus ``units_per_launch`` and the machines kept now."""
    return dict(_counts, units_per_launch=UNITS_PER_LAUNCH, kept=len(_cache))


@contextlib.contextmanager
def forced_eager():
    """Within the block every machine runs under the eager driver, on the
    card too (the graph driver's reference in the card's checks)."""
    _force_eager[0] = True
    try:
        yield
    finally:
        _force_eager[0] = False


def _card(d: torch.device) -> int:
    """A CUDA device's index (the current card for ``cuda``)."""
    if d.index is not None:
        return d.index
    return torch.cuda.current_device() if torch.cuda.is_available() else 0


def driver_for(device: torch.device, mesh) -> tuple[str, str]:
    """``("graph", "")`` where the graph driver runs (a period, a step or a
    fixed point on a CUDA device: a whole box, or a mesh whose blocks all
    lie on ``device``'s card), else ``("eager", why)``."""
    if _force_eager[0]:
        return "eager", "asked for (device_loop.forced_eager)"
    if device.type != "cuda":
        return "eager", f"a {device.type} device: CUDA graphs run on the card only"
    if mesh is not None and any(d.type != "cuda" or _card(d) != _card(device)
                                for d in mesh.devices.flat):
        return "eager", ("a mesh over several cards: a capture on the home card does "
                         "not take the other cards' work")
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


def _pool(device: torch.device):
    """The graph memory pool of ``device``'s card, made at its first
    capture and shared by every machine kept there."""
    card = _card(device)
    if card not in _pools:
        _pools[card] = torch.cuda.graph_pool_handle()
    return _pools[card]


class _GraphMachine:
    """A machine with its units captured and joined into one executable
    graph over the machine's own buffers."""

    def __init__(self, machine):
        self.machine = machine
        self.exec = None
        self.lib = _library()
        device = machine.home
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        machine.prepare_capture()
        pool = _pool(device)
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
    """Drop every kept graph machine (their buffers and graphs) and the
    cards' shared memory pools."""
    while _cache:
        _, gm = _cache.popitem()
        gm.close()
    _pools.clear()


def _read_ints(machine):
    _counts["eager_reads"] += 1
    return host_array(machine.i.buffer)


def _run_eager(machine):
    units, follows = machine.units(), machine.follows()
    phase, ints = machine.first_phase, None
    while True:
        # after a decision from data, and at the end (the run's counts)
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


def run_period(key, build, load, device: torch.device, mesh=None,
               what: str = "periods"):
    """Run one period (or step, or fixed point: ``what`` names the count
    it adds to) of a machine to DONE and return ``(machine, status)``:
    ``build()`` makes the machine (under the graph driver only when ``key``
    has none kept), ``load(machine)`` copies the run's inputs into its
    buffers."""
    driver, _ = driver_for(device, mesh)
    if driver == "eager":
        machine = build()
        load(machine)
        _counts[f"eager_{what}"] += 1
        return machine, _run_eager(machine)
    gm = _cache.get(key)
    if gm is None:
        while len(_cache) >= MAX_MACHINES:
            _cache.popitem(last=False)[1].close()
        gm = _GraphMachine(build())
        _counts["captures"] += 1
        _counts["capture_s"] += gm.capture_s
        _cache[key] = gm
    _cache.move_to_end(key)
    load(gm.machine)
    _counts[f"graph_{what}"] += 1
    return gm.machine, gm.run()
