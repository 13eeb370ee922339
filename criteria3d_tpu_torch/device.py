"""Device placement, dataclass-of-tensor helpers and the host-read counter.

The port's entry points build on the CUDA card unless the caller names
another device; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["resolve_device", "map_tensors", "scalar", "host_read"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``None`` means the CUDA card,
    and raises when there is none (pass ``device="cpu"`` explicitly to run
    on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to build "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def map_tensors(obj, fn):
    """Copy of a frozen dataclass with ``fn`` applied to every tensor field,
    recursing into nested dataclasses; other fields are kept as they are."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = map_tensors(v, fn)
    return dataclasses.replace(obj, **changes)


def scalar(v, dtype, device) -> torch.Tensor:
    """``v`` (a Python number or a 0-d tensor) as a 0-d tensor of ``dtype``
    on ``device``; a number becomes a fill kernel, with no host->device
    copy and no synchronisation."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def host_read(t: torch.Tensor):
    """A 0-d tensor's value as a Python number.

    Every scalar decision of the host-driven solver loops goes through
    here, so ``host_read.count`` is the number of device->host
    synchronisations a run made (reset it to 0 before the run)."""
    host_read.count += 1
    return t.item()


host_read.count = 0
