"""The model hour's per-cell fixed points as state machines on the device.

Counterpart of the ``lax.while_loop``s of HYDRALL's and the vine's
assimilation fixed points (criteria3d_tpu/physics/hydrall.py:302,
criteria3d_tpu/physics/vine_photosynthesis.py:411): JAX iterates while
``it < max_iter`` and some cell is not done; a done cell keeps its values.

:class:`FixedPoint` holds the loop's inputs and per-cell carries in
buffers on the device and ``it``, the phase and the status in int64 slots.
Its unit runs :data:`CHECK_EVERY` iterations of the caller's ``body``, which
updates the carries in place (each a select of the old and the new value,
so a done cell keeps its own); a second unit runs the
``(max_iter - first_it) % CHECK_EVERY`` iterations left before ``max_iter``,
so no iteration past ``max_iter`` runs. After each unit the phase reads DONE
once every cell is done or ``max_iter`` is reached, and the status holds the
last cell's stop iteration (-1 while a cell is not done). Iterations after
every cell is done change no carry, so each cell's stop and values are
JAX's. solver/device_loop.py runs the machine: as CUDA graphs on the card
(one host read a launch: one for a loop of up to 4,096 iterations), unit by
unit on the CPU and under ``forced_eager()`` (a host read after each unit,
as the host loop it replaces read ``all(done)`` every ``CHECK_EVERY``
iterations).
"""

from __future__ import annotations

import torch

from criteria3d_tpu_torch.solver import device_loop

__all__ = ["FixedPoint", "run", "iteration_bytes", "CHECK_EVERY"]

# iterations of a unit (the eager driver reads the host once a unit)
CHECK_EVERY = 4

DONE = 0
ITERATE = 1     # CHECK_EVERY iterations
REST = 2        # the iterations left before max_iter, fewer than CHECK_EVERY


class FixedPoint:
    """One fixed point's loop as a machine of units over buffers:
    ``inputs`` (tensors the body reads) and ``carries`` (tensors it updates
    in place, among them ``done`` and ``stop``, each cell's stop iteration)
    are copied into buffers of their own by :meth:`load`; ``consts``
    (Python values the body reads) are fixed at build.
    ``body(c, s, it)`` runs one iteration: ``c`` maps the names of inputs
    and consts to their buffers and values, ``s`` the carries' names to
    their buffers, ``it`` is the iteration's 0-d int64 slot."""

    DONE = DONE

    def __init__(self, body, inputs: dict, carries: dict, consts: dict,
                 max_iter: int, first_it: int):
        self.body, self.max_iter, self.first_it = body, int(max_iter), int(first_it)
        self.home = home = carries["done"].device
        self.c = dict(consts, **{k: torch.empty_like(v) for k, v in inputs.items()})
        self.s = {k: torch.empty_like(v) for k, v in carries.items()}
        self.i = device_loop.Slots(("phase", "last", "it"), torch.int64, home)
        self.status = self.i.buffer[:2]
        self.rest = max(self.max_iter - self.first_it, 0) % CHECK_EVERY

    # -- what a driver needs ------------------------------------------------

    def units(self) -> dict:
        units = {ITERATE: ("iterate", self._iterate)}
        if self.rest:
            units[REST] = ("rest", self._rest)
        return units

    def follows(self) -> dict:
        return {}

    def tallies(self) -> list:
        return []

    def prepare_capture(self) -> None:
        pass

    def _phase_from(self, left: int) -> int:
        return DONE if left <= 0 else ITERATE if left >= CHECK_EVERY else REST

    def load(self, inputs: dict, carries: dict) -> None:
        """Copy one call's inputs and first carries into the buffers and set
        ``it`` to the first iteration."""
        for k, v in inputs.items():
            self.c[k].copy_(v)
        for k, v in carries.items():
            self.s[k].copy_(v)
        self.first_phase = self._phase_from(self.max_iter - self.first_it)
        self.i.phase.fill_(self.first_phase)
        self.i.last.fill_(-1)
        self.i.it.fill_(self.first_it)

    # -- the units ----------------------------------------------------------

    def _iterate(self):
        self._run(CHECK_EVERY)

    def _rest(self):
        self._run(self.rest)

    def _run(self, n: int):
        i, s = self.i, self.s
        for _ in range(n):
            self.body(self.c, s, i.it)
            i.it.add_(1)
        all_done = torch.all(s["done"])
        i.last.copy_(torch.where(all_done, torch.max(s["stop"]).to(torch.int64), -1))
        left = self.max_iter - i.it
        i.phase.copy_(torch.where(all_done | (left <= 0), DONE,
                                  torch.where(left >= CHECK_EVERY, ITERATE, REST)))


def iteration_bytes(inputs: dict, carries: dict) -> int:
    """The least bytes one iteration of a fixed point moves through device
    memory: every input read once, every per-cell carry read once and
    written once (an iteration's bytes bound, whatever its kernels read
    again)."""
    def size(d):
        return sum(v.numel() * v.element_size() for v in d.values())
    return size(inputs) + 2 * size(carries)


def _key(kind: str, inputs: dict, carries: dict, consts: dict, max_iter: int,
         first_it: int) -> tuple:
    def shapes(d):
        return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(d.items()))
    return (kind, shapes(inputs), shapes(carries), tuple(sorted(consts.items())),
            int(max_iter), int(first_it))


def run(kind: str, body, inputs: dict, carries: dict, consts: dict, max_iter: int,
        first_it: int = 0) -> tuple[dict, int]:
    """Run the fixed point ``body`` from ``first_it`` to its end (see
    :class:`FixedPoint`) by the driver ``device_loop.driver_for`` names;
    returns ``(carries, last)``: copies of the final carries and the last
    cell's stop iteration (-1 when ``max_iter`` ended the loop first)."""
    device = carries["done"].device
    m, status = device_loop.run_period(
        _key(kind, inputs, carries, consts, max_iter, first_it),
        lambda: FixedPoint(body, inputs, carries, consts, max_iter, first_it),
        lambda m: m.load(inputs, carries), device, what="fixed_points")
    return {k: v.clone() for k, v in m.s.items()}, int(status[1])
