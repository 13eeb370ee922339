"""Device placement, dataclass-of-tensor helpers, the host-read counter
and the counts a CUDA graph keeps on the card.

The port's entry points build on the CUDA card unless the caller names
another device; they never fall back to the CPU on their own.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "input_device", "map_tensors", "scalar",
           "host_read", "host_array", "tally", "tallies_on_device"]


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


def input_device(device, *inputs) -> torch.device:
    """The device a function of arrays computes on: ``device`` when given;
    else the device of the first tensor among ``inputs`` (tensors stay
    where they are); else the CUDA card, as :func:`resolve_device` gives it
    (raising when there is none)."""
    if device is not None:
        return torch.device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return resolve_device(None)


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


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host. Like
    :func:`host_read` it adds one to ``host_read.count``: on the card the
    copy waits for the work that makes ``t``."""
    host_read.count += 1
    return t.detach().cpu().numpy()


# (function, attribute) -> the 0-d int64 tensor on the card that counts for
# it while a CUDA graph captures (tallies_on_device)
_DEVICE_TALLIES: dict = {}


def tally(fn, attr: str, device: torch.device) -> None:
    """Add one to the host count ``fn.<attr>`` (a kernel's launches, a
    rare branch's calls). While a CUDA graph captures on ``device`` the
    addition is captured instead, onto the count on the card that
    :func:`tallies_on_device` installed for it, so that every replay adds
    one; capturing with none installed raises."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        slot = _DEVICE_TALLIES.get((fn, attr))
        if slot is None:
            raise RuntimeError(f"{fn.__name__} was captured into a CUDA graph with "
                               f"no count on the card for its {attr!r}")
        slot.add_(1)
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def tallies_on_device(slots: dict):
    """Within the block, :func:`tally` of ``(fn, attr)`` under a capture adds
    to ``slots[(fn, attr)]``, a 0-d int64 tensor on the card (a view of a
    CUDA graph's own buffer, which the graph's driver reads and folds into
    ``fn.<attr>`` after its replays)."""
    _DEVICE_TALLIES.update(slots)
    try:
        yield
    finally:
        for key in slots:
            _DEVICE_TALLIES.pop(key, None)
