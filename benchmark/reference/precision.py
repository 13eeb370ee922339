"""The precision of the reference's float64 accumulations: the balance
sums of water and heat storage and flow, and CG's D-weighted dot products,
which the configurations state in float64 over float32 terms.

:func:`lowered` runs them in float32 instead, the nearest precision below
the stated one: that is the benchmark's control, the step that a fused
float32 reduction would take, and the comparison must call it not correct.
"""

from __future__ import annotations

import contextlib

import torch

_ACCUMULATOR = [torch.float64]


def accumulator() -> torch.dtype:
    """The dtype the reference's float64 sums accumulate in now."""
    return _ACCUMULATOR[0]


@contextlib.contextmanager
def lowered():
    """Within the block the float64 accumulations run in float32."""
    _ACCUMULATOR[0] = torch.float32
    try:
        yield
    finally:
        _ACCUMULATOR[0] = torch.float64
