"""The benchmark's counts of a timed call's bytes and operations, one file
per call: each module's ``prepare(system)`` builds the call on the cell's
own state and returns a :class:`Call`. The bytes count each input byte of
the call read once and each output byte written once, from the shapes and
dtypes of the call's arguments and results; the operations are the call's
float32 arithmetic per box node, counted by hand from its code."""

from __future__ import annotations

from typing import Callable, NamedTuple


class Call(NamedTuple):
    fn: Callable
    read_bytes: int
    write_bytes: int
    flops: float
    reps: int


def nbytes(*tensors) -> int:
    """The bytes of ``tensors``, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)
