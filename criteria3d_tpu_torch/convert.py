"""Carry a grid, a water state and the heat state and forcing across from
plain arrays.

The JAX package's ``Grid``, ``WaterState``, ``HeatState`` and
``HeatBoundary`` become numpy arrays and
Python scalars on the caller's side (``np.asarray`` of every field); these
functions turn them into the port's objects without importing JAX, so that
both implementations can run from exactly the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import SoilFields
from criteria3d_tpu_torch.core.state import BalanceData, WaterState
from criteria3d_tpu_torch.device import resolve_device
from criteria3d_tpu_torch.solver.heat import HeatBoundary, HeatState

__all__ = ["grid_from_arrays", "state_from_arrays", "heat_state_from_arrays",
           "heat_boundary_from_arrays", "GRID_META"]

# the Grid fields that are Python scalars, not tensors
GRID_META = ("has_prescribed", "has_culvert", "cell_size", "n_layers",
             "n_nodes", "n_surface_nodes", "layer_depth", "layer_thickness")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def grid_from_arrays(arrays: dict, meta: dict, *, device=None) -> Grid:
    """A :class:`Grid` from ``arrays`` (every tensor field of the grid by
    name, with ``arrays["soil"]`` a dict of the SoilFields arrays) and
    ``meta`` (the scalar fields named in :data:`GRID_META`). Dtypes are
    kept. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    soil = SoilFields(**{f.name: _tensor(arrays["soil"][f.name], dev)
                         for f in dataclasses.fields(SoilFields)})
    tensors = {f.name: _tensor(arrays[f.name], dev)
               for f in dataclasses.fields(Grid)
               if f.name not in GRID_META and f.name != "soil"}
    m = {k: meta[k] for k in GRID_META}
    m["layer_depth"] = tuple(m["layer_depth"])
    m["layer_thickness"] = tuple(m["layer_thickness"])
    return Grid(soil=soil, **tensors, **m)


def state_from_arrays(arrays: dict, *, device=None) -> WaterState:
    """A :class:`WaterState` from ``arrays``: every field by name, with the
    four balances (``balance_prev`` ...) as dicts of their scalars. Dtypes
    are kept. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(WaterState):
        v = arrays[f.name]
        if f.name.startswith("balance_"):
            fields[f.name] = BalanceData(**{b.name: _tensor(v[b.name], dev)
                                            for b in dataclasses.fields(BalanceData)})
        else:
            fields[f.name] = _tensor(v, dev)
    return WaterState(**fields)


def heat_state_from_arrays(arrays: dict, *, device=None) -> HeatState:
    """A :class:`HeatState` from ``arrays`` (every field by name). Dtypes
    are kept. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return HeatState(**{f.name: _tensor(arrays[f.name], dev)
                        for f in dataclasses.fields(HeatState)})


def heat_boundary_from_arrays(arrays: dict, *, device=None) -> HeatBoundary:
    """A :class:`HeatBoundary` from ``arrays`` (every (R, C) map by name).
    Dtypes are kept. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return HeatBoundary(**{f.name: _tensor(arrays[f.name], dev)
                           for f in dataclasses.fields(HeatBoundary)})
