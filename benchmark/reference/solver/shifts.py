"""Stencil shift helpers over the (..., R, C) plan dimensions.

``shift2d(x, di, dj)`` returns ``y`` with ``y[..., i, j] = x[..., i+di, j+dj]``
and a fill value outside the grid (criteria3d_tpu/solver/shifts.py).
"""

from __future__ import annotations

import torch

from benchmark.reference.core.grid import LATERAL_OFFSETS

__all__ = ["shift2d", "LATERAL_OFFSETS"]

def shift2d(x: torch.Tensor, di: int, dj: int, fill=0.0) -> torch.Tensor:
    """y[..., i, j] = x[..., i+di, j+dj]; `fill` outside the grid (a filled
    tensor plus one slice assignment, so bool tensors shift too)."""
    if di == 0 and dj == 0:
        return x
    R, C = x.shape[-2:]
    y = torch.full_like(x, fill)
    src_r = slice(max(di, 0), R + min(di, 0))
    dst_r = slice(max(-di, 0), R + min(-di, 0))
    src_c = slice(max(dj, 0), C + min(dj, 0))
    dst_c = slice(max(-dj, 0), C + min(-dj, 0))
    y[..., dst_r, dst_c] = x[..., src_r, src_c]
    return y


