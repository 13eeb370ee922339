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
- **The rounds driver** (a water or coupled period on a mesh whose blocks
  several machines run: one per card of a mesh over several cards, or the
  explicit grouping of ``make_mesh``'s ``machines``, which may put one
  card's blocks into several). Each machine holds its blocks' part of
  every buffer and its own scalars on its own device, and the machines
  meet at every join (a sum, a maximum, a ring refresh:
  ``sharding.Join``), where each posts its blocks' partials and ring
  strips and reads every other machine's. A unit is thus cut at its joins
  into *segments*; every machine runs one
  segment a *round*, and between rounds each machine copies the others'
  posts into its own board. On the card each segment is a CUDA graph
  captured on the machine's own stream and pool, and a SWITCH on a code on
  the machine's card selects its segment, one graph a machine.
  ``csrc/graph_machine.cu``'s ``c3d_rounds`` enqueues up to
  :data:`UNITS_PER_LAUNCH` rounds at a time from the host, on one card or
  several alike (each machine's graph on its own stream, then the copies,
  ordered by CUDA events between the streams: a copy waits for the segment
  that wrote its source, the next segment for every copy out of its
  board). No kernel waits on memory another machine writes. Every
  :data:`POLL_EVERY` rounds machine 0's segment code is copied to pinned
  host memory, and the host stops enqueuing once a copy that has landed
  says no segment is left (it never waits for one: it looks between
  rounds). The host reads the machines' status once per batch of rounds.
  On the CPU the machines are threads that meet at the same rounds, and
  a batch ends when machine 0 has no segment left.
- **The eager driver** runs the same units in Python. It reads the
  machine's int carries after each unit that decides its next phase from
  data (an assembly's Courant test, an iteration's stop, a balance, an
  attempt's end); after the others it takes the next phase from the
  machine's ``follows()`` without a read. It serves the CPU's one-machine
  runs; :func:`forced_eager` asks for it on the card (to compare the
  drivers: it then runs one machine over all the blocks).

There is no fallback between them: where :func:`driver_for` names the graph
or rounds driver it runs or raises (a failed capture or join, a host
synchronisation inside a unit, a toolkit without CUDA 12.8's SWITCH
nodes, machines that disagree).

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
takes 8 launches (in rounds, 4 machines: 16,192 rounds, one a join and
one a unit's end, in 16 batches); a fixed point of up to 4,096
iterations, 4 a unit, takes one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import os
import threading
import time

import numpy as np
import torch

from criteria3d_tpu_torch.device import host_array, tallies_on_device
from criteria3d_tpu_torch.parallel.sharding import Join, joining, machine_groups
from criteria3d_tpu_torch.utils import buildcache

__all__ = ["UNITS_PER_LAUNCH", "POLL_EVERY", "MAX_MACHINES", "Slots", "run_period",
           "driver_for", "forced_eager", "counts", "reset_counts", "clear",
           "build_library", "SOURCE"]

UNITS_PER_LAUNCH = 1024
# the rounds between two looks at machine 0's segment code (rounds driver)
POLL_EVERY = 16
# the kept graph machines (see the module docstring for their memory)
MAX_MACHINES = 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "graph_machine.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_force_eager = [False]
_cache: collections.OrderedDict = collections.OrderedDict()   # key -> _GraphMachine
_pools: dict = {}     # (card, k) -> the graph memory pool the kept machines' k-th share
_COUNT_NAMES = ("graph_periods", "eager_periods", "graph_fixed_points",
                "eager_fixed_points", "launches", "eager_units", "eager_reads",
                "captures", "capture_s", "rounds_periods", "rounds", "rounds_enqueued")
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
    points run by each driver, the graph driver's launches (the rounds
    driver's batches of rounds among them), the rounds driver's rounds
    (those in which the machines ran a segment) and rounds enqueued (those
    and the empty ones enqueued before the host saw the end), the eager
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
    """The driver of a machine on ``device`` (over ``mesh``) and why:
    ``("rounds", "")`` for a water or coupled period (or step) on a mesh
    whose blocks several machines run
    (:func:`~criteria3d_tpu_torch.parallel.sharding.machine_groups`: a
    mesh over several cards, or an explicit grouping), on the card or the
    CPU; ``("graph", "")`` on a CUDA device, for a whole box or a mesh of
    one machine (its blocks all on ``device``'s card); else ``("eager",
    why)``."""
    if _force_eager[0]:
        return "eager", "asked for (device_loop.forced_eager)"
    if mesh is not None and len(machine_groups(mesh)) > 1:
        return "rounds", ""
    if device.type != "cuda":
        return "eager", f"a {device.type} device: CUDA graphs run on the card only"
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
    lib.c3d_switch_build.argtypes = [I, P, P, P, P]
    lib.c3d_switch_build.restype = I
    lib.c3d_event_create.argtypes = [I, P]
    lib.c3d_event_create.restype = I
    lib.c3d_event_destroy.argtypes = [P]
    lib.c3d_event_destroy.restype = I
    lib.c3d_peer.argtypes = [I, I]
    lib.c3d_peer.restype = I
    lib.c3d_rounds.argtypes = [I, I, P, P, P, P, P, I, P, P, P, P, I, I, P, P, P, I, P, P,
                               P, P]
    lib.c3d_rounds.restype = I
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph machine: {what} failed: CUDA error {err}")


def _pool(device: torch.device, k: int = 0):
    """The ``k``-th graph memory pool of ``device``'s card, made at its
    first capture and shared by the machines kept there (the machines of one
    rounds run, which replay side by side, take pools 0, 1, ... each)."""
    key = (_card(device), k)
    if key not in _pools:
        with torch.cuda.device(device):
            _pools[key] = torch.cuda.graph_pool_handle()
    return _pools[key]


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
        with torch.cuda.device(device), torch.cuda.stream(stream), \
                tallies_on_device(slots):
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
        with torch.cuda.device(device):
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
        _add_tallies(m, status)
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


def _fold(machines, rows: np.ndarray) -> np.ndarray:
    """The status of machines run side by side (``rows``, one a machine):
    the first machine's, the counts kept on the cards summed over the
    machines (each counts its own blocks' launches; what happens once for
    the whole mesh, a restore or a heat sweep, only the machine holding
    block (0, 0) counts). Machines that disagree on anything else
    (the period's stats, chunks, sub-steps) raise."""
    tally = [k for _, _, k in machines[0].tallies()]
    rest = [k for k in range(rows.shape[1]) if k not in tally]
    if not (rows[:, rest] == rows[0, rest]).all():
        raise RuntimeError(f"the rounds driver's machines disagree: status {rows.tolist()}")
    status = rows[0].copy()
    status[tally] = rows[:, tally].sum(axis=0)
    return status


def _add_tallies(machine, status) -> None:
    for fn, attr, k in machine.tallies():
        setattr(fn, attr, getattr(fn, attr) + int(status[k]))


def _peer_access(a: torch.device, b: torch.device) -> bool:
    """Whether card ``a`` reads and writes card ``b``'s memory directly
    (``torch.cuda.can_device_access_peer``); enabled here when it can, so
    the rounds' copies between them go peer to peer, else through the
    host."""
    if _card(a) == _card(b):
        return True
    if not torch.cuda.can_device_access_peer(_card(a), _card(b)):
        return False
    _check(_library().c3d_peer(_card(a), _card(b)), "enabling peer access")
    return True


class _SegmentCapture:
    """The capture of one machine's units cut at their joins: the driver's
    ``Join.cut``. Segment codes run from 0 in capture order; a unit's last
    segment sets the code of the first segment of the unit its phase
    names (``table``), the others the next code."""

    def __init__(self, machine, pool):
        self.machine, self.pool = machine, pool
        self.seg = torch.zeros((), dtype=torch.int64, device=machine.home)
        # the launches of the machine's graph that ran a segment
        self.ran = torch.zeros((), dtype=torch.int64, device=machine.home)
        n_phases = max(machine.units()) + 1
        self.table = torch.full((n_phases,), -1, dtype=torch.int64, device=machine.home)
        self.first, self.graphs = {}, []
        self.graph = None

    def _begin(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.graph.capture_begin(pool=self.pool)

    def _end(self):
        self.graph.capture_end()
        self.graphs.append(self.graph)
        self.graph = None

    def cut(self):
        self.seg.fill_(len(self.graphs) + 1)
        self._end()
        self._begin()

    def unit(self, code, name, fn):
        self.first[code] = len(self.graphs)
        self._begin()
        try:
            fn()
            phase = self.machine.i.phase
            self.seg.copy_(self.table.index_select(0, phase.view(1))[0])
        except Exception as e:
            with contextlib.suppress(Exception):
                self.graph.capture_end()
            raise RuntimeError(f"rounds driver: capturing unit {name!r} failed; a unit "
                               f"may not read the device from the host ({e})") from e
        self._end()

    def done(self):
        """Fill the phase -> first segment table (DONE and the phases
        without a unit select no segment)."""
        table = torch.full(self.table.shape, -1, dtype=torch.int64)
        for code, first in self.first.items():
            table[code] = first
        self.table.copy_(table)


class _Rounds:
    """The machines of one mesh run side by side in rounds on the card or
    cards: each machine's units captured as segments on its own stream and
    pool, and a graph a machine that selects its segment by a SWITCH on
    its code (``c3d_switch_build``); the host enqueues the rounds
    (``c3d_rounds``)."""

    def __init__(self, machines, joins):
        # the joins' boards stay alive with the machine: the rounds copy
        # between them by address
        self.machines, self.joins = machines, joins
        self.lib = _library()
        self.execs, self.events, self.streams, self.caps = [], [], [], []
        t0 = time.perf_counter()
        devices = [m.home for m in machines]
        cards = sorted({_card(d) for d in devices})
        for d in cards:
            torch.cuda.synchronize(d)
        for a in devices:          # the copies between cards peer to peer where they can
            for b in devices:
                _peer_access(a, b)
        P = ctypes.c_void_p
        for g, (m, join) in enumerate(zip(machines, joins)):
            dev = m.home
            m.prepare_capture()
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            cap = _SegmentCapture(m, _pool(dev, g))
            join.cut = cap.cut
            slots = {(fn, attr): m.status[k] for fn, attr, k in m.tallies()}
            with torch.cuda.device(dev), torch.cuda.stream(stream), \
                    tallies_on_device(slots), joining(join):
                for code, (name, unit) in m.units().items():
                    cap.unit(code, name, unit)
            join.cut = None
            torch.cuda.current_stream(dev).wait_stream(stream)
            cap.done()
            self.streams.append(stream)
            self.caps.append(cap)
            raw = (P * len(cap.graphs))(*[gr.raw_cuda_graph() for gr in cap.graphs])
            exec_ = P()
            with torch.cuda.device(dev):
                _check(self.lib.c3d_switch_build(len(cap.graphs), raw, cap.seg.data_ptr(),
                                                 cap.ran.data_ptr(), ctypes.byref(exec_)),
                       "building a machine's segment graph (SWITCH nodes need CUDA 12.8)")
            self.execs.append(exec_)
        G = len(machines)
        home = machines[0].home
        n_polls = UNITS_PER_LAUNCH // POLL_EVERY
        # each machine's done and free events, then the polls' on machine 0's card
        for card in [_card(d) for d in devices for _ in range(2)] + [_card(home)] * n_polls:
            ev = P()
            _check(self.lib.c3d_event_create(card, ctypes.byref(ev)), "creating an event")
            self.events.append(ev)
        # machine 0's segment code after every POLL_EVERY-th round of a batch
        self.polled = torch.zeros(n_polls, dtype=torch.int64, pin_memory=True)
        # the copies of every round: machine g pulls each other machine's
        # rows of the boards into its own
        copies = [(g, h) for g in range(G) for h in range(G) if h != g]
        rec = joins[0].record
        S = len(machines[0].status)
        # each machine's status, segment code and segments run, read once a batch
        self.gathered = torch.zeros((G, S + 2), dtype=torch.int64, device=home)
        gather = [(self.gathered[g].data_ptr() + 8 * k, src.data_ptr(), 8 * n)
                  for g, (m, cap) in enumerate(zip(machines, self.caps))
                  for k, src, n in ((0, m.status, S), (S, cap.seg, 1), (S + 1, cap.ran, 1))]
        self.enqueued = ctypes.c_int(0)
        LLs = ctypes.c_longlong
        self.args = (
            UNITS_PER_LAUNCH, G, (ctypes.c_int * G)(*[_card(d) for d in devices]),
            (P * G)(*[e.value for e in self.execs]),
            (P * G)(*[s.cuda_stream for s in self.streams]),
            (P * G)(*[self.events[2 * g].value for g in range(G)]),
            (P * G)(*[self.events[2 * g + 1].value for g in range(G)]),
            len(copies), (ctypes.c_int * len(copies))(*[g for g, _ in copies]),
            (P * len(copies))(*[joins[g].board.data_ptr() + joins[g].rows[h][0] * rec
                                for g, h in copies]),
            (P * len(copies))(*[joins[h].board.data_ptr() + joins[h].rows[h][0] * rec
                                for g, h in copies]),
            (LLs * len(copies))(*[(joins[h].rows[h][1] - joins[h].rows[h][0]) * rec
                                  for g, h in copies]),
            POLL_EVERY, n_polls, self.caps[0].seg.data_ptr(), self.polled.data_ptr(),
            (P * n_polls)(*[e.value for e in self.events[2 * G:]]),
            len(gather), (P * len(gather))(*[d for d, _, _ in gather]),
            (P * len(gather))(*[s for _, s, _ in gather]),
            (LLs * len(gather))(*[n for _, _, n in gather]), ctypes.byref(self.enqueued))
        for d in cards:
            torch.cuda.synchronize(d)
        self.capture_s = time.perf_counter() - t0

    def run(self):
        ms = self.machines
        S = len(ms[0].status)
        for m, cap, stream in zip(ms, self.caps, self.streams):
            cap.seg.copy_(cap.table[m.first_phase])
            cap.ran.zero_()
            stream.wait_stream(torch.cuda.current_stream(m.home))
        home = ms[0].home
        ran = 0
        while True:
            _check(self.lib.c3d_rounds(*self.args), "a batch of rounds")
            torch.cuda.current_stream(home).wait_stream(self.streams[0])
            rows = host_array(self.gathered)
            _counts["launches"] += 1
            _counts["rounds_enqueued"] += self.enqueued.value
            _counts["rounds"] += int(rows[0, S + 1]) - ran
            ran = int(rows[0, S + 1])
            ended = rows[:, S] < 0
            if ended.all():
                break
            if ended.any():
                raise RuntimeError("the rounds driver's machines disagree: segment codes "
                                   f"{rows[:, S].tolist()}")
        for m, stream in zip(ms, self.streams):
            torch.cuda.current_stream(m.home).wait_stream(stream)
        if not (rows[:, 0] == ms[0].DONE).all():
            raise RuntimeError("the rounds driver's machines stopped at phases "
                               f"{rows[:, 0].tolist()}, not DONE")
        status = _fold(ms, rows)[:S]
        _add_tallies(ms[0], status)
        return status

    def close(self) -> None:
        for e in self.execs:
            _check(self.lib.c3d_machine_destroy(e), "destroying a rounds graph")
        for e in self.events:
            _check(self.lib.c3d_event_destroy(e), "destroying an event")
        self.execs, self.events = [], []


class _Stop(Exception):
    pass


def _run_rounds_threads(machines, joins):
    """The rounds on the CPU: each machine a thread that runs its units and
    stops at each join (a segment's end). A round lets every machine run
    one segment, one machine after the other (no two threads hold Python
    at once), then the main thread makes every machine's copies of the
    others' posts. A batch ends after :data:`UNITS_PER_LAUNCH` rounds or
    when machine 0 has no segment left (a unit's last segment ran and the
    phase it set has no unit: the card's code -1), and the status is read
    once a batch, as the card's driver does."""
    G = len(machines)
    go = [threading.Semaphore(0) for _ in range(G)]
    ended = threading.Semaphore(0)
    flags = dict(stop=False)
    errors = [None] * G
    where = [None] * G
    # whether the machine's last segment ended a unit and left no segment
    last = [False] * G

    def worker(g):
        m, join = machines[g], joins[g]
        units = m.units()
        step = [None, 0]

        def cut(ends_unit=False):
            where[g] = tuple(step)
            last[g] = ends_unit and int(m.i.phase) == m.DONE
            step[1] += 1
            ended.release()
            go[g].acquire()
            if flags["stop"]:
                raise _Stop
        join.cut = cut
        try:
            go[g].acquire()
            with joining(join):
                while not flags["stop"]:
                    # the phase, read as the card's SWITCH reads it
                    phase = int(m.i.phase)
                    step[:] = [phase, 0]
                    if phase != m.DONE:
                        units[phase][1]()
                        if g == 0:
                            _counts["eager_units"] += 1
                    cut(ends_unit=True)
        except _Stop:
            pass
        except BaseException as e:     # noqa: BLE001 - handed to the main thread
            errors[g] = e
            ended.release()
        finally:
            join.cut = None

    threads = [threading.Thread(target=worker, args=(g,), daemon=True) for g in range(G)]
    for t in threads:
        t.start()
    try:
        while not flags["stop"]:
            for r in range(UNITS_PER_LAUNCH):
                for g in range(G):
                    go[g].release()
                    ended.acquire()
                    if errors[g] is not None:
                        raise RuntimeError(f"a machine of the rounds driver failed: "
                                           f"{errors[g]!r}") from errors[g]
                if len(set(where)) != 1:
                    raise RuntimeError("the rounds driver's machines are out of step: "
                                       f"(phase, join) {where}")
                for g in range(G):
                    for h in range(G):
                        if h != g:
                            lo, hi = joins[h].rows[h]
                            joins[g].board[lo:hi].copy_(joins[h].board[lo:hi])
                _counts["rounds_enqueued"] += 1
                if where[0][0] != machines[0].DONE:
                    _counts["rounds"] += 1
                if last[0]:
                    break
            _counts["launches"] += 1
            rows = host_array(torch.stack([m.status for m in machines]))
            if any(last) and not all(last):
                raise RuntimeError(f"the rounds driver's machines disagree: ended {last}")
            flags["stop"] = all(last)
        if not (rows[:, 0] == machines[0].DONE).all():
            raise RuntimeError("the rounds driver's machines stopped at phases "
                               f"{rows[:, 0].tolist()}, not DONE")
    finally:
        flags["stop"] = True
        for g in range(G):
            go[g].release()
        for t in threads:
            t.join(timeout=60)
    status = _fold(machines, rows)
    _add_tallies(machines[0], status)
    return status


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


def _build_rounds(build, mesh):
    groups = machine_groups(mesh)
    machines = [build(g) for g in groups]
    like = machines[0].join_like()
    joins = [Join(mesh, groups, k, like) for k in range(len(groups))]
    return machines, joins


def run_period(key, build, load, device: torch.device, mesh=None,
               what: str = "periods"):
    """Run one period (or step, or fixed point: ``what`` names the count
    it adds to) of a machine to DONE and return ``(machine, status)``:
    ``build()`` makes the machine (under the graph driver only when ``key``
    has none kept), ``load(machine)`` copies the run's inputs into its
    buffers. Under the rounds driver ``build(blocks)`` makes the machine of
    the mesh's blocks ``blocks`` (one a ``machine_groups`` entry; it names
    the field its joins exchange with ``join_like()``), ``load`` runs on
    each, and the machine returned is the list of them."""
    driver, _ = driver_for(device, mesh)
    if driver == "rounds":
        _counts["rounds_periods"] += 1
        if device.type != "cuda":
            machines, joins = _build_rounds(build, mesh)
            for m in machines:
                load(m)
            return machines, _run_rounds_threads(machines, joins)
        gm = _cache.get(key)
        if gm is None:
            while len(_cache) >= MAX_MACHINES:
                _cache.popitem(last=False)[1].close()
            gm = _Rounds(*_build_rounds(build, mesh))
            _counts["captures"] += 1
            _counts["capture_s"] += gm.capture_s
            _cache[key] = gm
        _cache.move_to_end(key)
        for m in gm.machines:
            load(m)
        return gm.machines, gm.run()
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
