"""Carry a grid, a water state, the heat state and forcing, a whole hourly
model (with HYDRALL and RothC), a project's running model, a whole
VINE3D model and a fitted detrending or variogram model across from plain
arrays.

The JAX package's ``Grid``, ``WaterState``, ``HeatState``, ``HeatBoundary``,
``SnowState``, ``HydrallMaps``, ``RothCState``, ``GrapevineState``, the two
mildew states, ``Criteria3DModel`` and ``Vine3DModel`` become numpy arrays
and Python scalars on the caller's side (``np.asarray`` of every field,
nested dataclasses as dicts); these functions turn them into the port's
objects without importing JAX, so that both implementations can run from
exactly the same inputs (also from the same mid-run state).
:func:`trend_model_arrays` goes the other way for a fitted ``TrendModel``,
so that a model the port fits can be carried into the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import SoilFields
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import host_array, resolve_device
from criteria3d_tpu_torch.model import Criteria3DModel, HourlyForcing, ModelConfig
from criteria3d_tpu_torch.physics import grapevine as gv
from criteria3d_tpu_torch.physics.crop import CropParameters
from criteria3d_tpu_torch.physics.detrending import TrendModel
from criteria3d_tpu_torch.physics.downy_mildew import DownyMildewState
from criteria3d_tpu_torch.physics.hydrall import HydrallMaps, HydrallPlantState
from criteria3d_tpu_torch.physics.kriging import VariogramModel
from criteria3d_tpu_torch.physics.powdery_mildew import PowderyMildewState
from criteria3d_tpu_torch.physics.rothc import RothCState
from criteria3d_tpu_torch.physics.snow import SnowState
from criteria3d_tpu_torch.physics.vine_photosynthesis import WangLeuningParameters
from criteria3d_tpu_torch.solver.heat import HeatBoundary, HeatState
from criteria3d_tpu_torch.vine3d import FieldBookEntry, Vine3DModel

__all__ = ["grid_from_arrays", "state_from_arrays", "heat_state_from_arrays",
           "heat_boundary_from_arrays", "snow_state_from_arrays",
           "forcing_from_arrays", "model_from_arrays",
           "project_model_from_arrays", "hydrall_maps_from_arrays",
           "rothc_state_from_arrays", "grapevine_state_from_arrays",
           "downy_state_from_arrays", "powdery_state_from_arrays",
           "vine_model_from_arrays", "trend_model_from_arrays",
           "trend_model_arrays", "variogram_model_from_fields",
           "GRID_META", "MODEL_MAPS",
           "MODEL_ACCUMULATORS", "VINE_MAPS", "VINE_ACCUMULATORS"]

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


# ----------------------------------------------------------------------
# the hourly model cycle
# ----------------------------------------------------------------------

def _state(cls, arrays: dict, device):
    """A dataclass of tensors ``cls`` from ``arrays`` (every field by name);
    dtypes are kept. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    return cls(**{f.name: _tensor(arrays[f.name], dev)
                  for f in dataclasses.fields(cls)})


def snow_state_from_arrays(arrays: dict, *, device=None) -> SnowState:
    """A :class:`SnowState` from ``arrays`` (every (R, C) map by name).
    Dtypes are kept. ``device=None`` means the CUDA card."""
    return _state(SnowState, arrays, device)


def hydrall_maps_from_arrays(arrays: dict, *, device=None) -> HydrallMaps:
    """:class:`HydrallMaps` from ``arrays``: every map by name, ``plant`` a
    dict of the HydrallPlantState maps. ``device=None`` means the CUDA
    card."""
    dev = resolve_device(device)
    fields = {f.name: _tensor(arrays[f.name], dev)
              for f in dataclasses.fields(HydrallMaps) if f.name != "plant"}
    return HydrallMaps(plant=_state(HydrallPlantState, arrays["plant"], dev),
                       **fields)


def rothc_state_from_arrays(arrays: dict, *, device=None) -> RothCState:
    """A :class:`RothCState` from ``arrays`` (every pool by name)."""
    return _state(RothCState, arrays, device)


def grapevine_state_from_arrays(arrays: dict, *,
                                device=None) -> gv.GrapevineState:
    """A :class:`GrapevineState` from ``arrays`` (every map by name)."""
    return _state(gv.GrapevineState, arrays, device)


def downy_state_from_arrays(arrays: dict, *, device=None) -> DownyMildewState:
    """A :class:`DownyMildewState` from ``arrays``; the float32 maps, the
    int32 stages and the bool flags keep their dtypes."""
    return _state(DownyMildewState, arrays, device)


def powdery_state_from_arrays(arrays: dict, *,
                              device=None) -> PowderyMildewState:
    """A :class:`PowderyMildewState` from ``arrays`` (dtypes kept: after a
    step part of the state is float64, as in JAX)."""
    return _state(PowderyMildewState, arrays, device)


def forcing_from_arrays(arrays: dict, *, device=None) -> HourlyForcing:
    """:class:`HourlyForcing` with every field a float64 tensor on
    ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    return HourlyForcing(**{
        f.name: torch.as_tensor(np.asarray(arrays[f.name], dtype=np.float64),
                                device=dev)
        for f in dataclasses.fields(HourlyForcing)})


# the model's map fields carried by model_from_arrays (None stays None)
MODEL_MAPS = ("lai", "degree_days", "canopy_storage", "slope_deg", "aspect_deg",
              "forest_mask")
MODEL_ACCUMULATORS = ("total_evaporation_mm", "total_transpiration_mm",
                      "total_precipitation_m3")


def _number_or_tensor(v, device):
    """A Python number stays a number (JAX's weakly typed scalar); an
    array becomes a tensor."""
    if isinstance(v, (int, float)):
        return v
    return _tensor(v, device)


def model_from_arrays(arrays: dict, meta: dict, params: SolverParameters,
                      *, device=None) -> Criteria3DModel:
    """A :class:`Criteria3DModel` rebuilt from a model's fields as numpy.

    ``arrays`` holds ``grid`` and ``water`` (as :func:`grid_from_arrays` and
    :func:`state_from_arrays` take them), ``heat`` and ``snow`` (dicts of
    arrays, or None), ``hydrall`` and ``rothc`` (as
    :func:`hydrall_maps_from_arrays` and :func:`rothc_state_from_arrays`
    take them, or None), ``config`` and ``crop`` (``dataclasses.asdict`` of
    the model's ModelConfig and CropParameters; ``crop`` may be None), the
    maps named in :data:`MODEL_MAPS` (arrays or None), the accumulators
    named in :data:`MODEL_ACCUMULATORS` (numbers or 0-d arrays) and
    ``_rothc_litter`` (the RothC litter: the number 0.0, the default, or a
    map); ``meta`` is the grid's scalar fields. ``device=None`` means the
    CUDA card."""
    dev = resolve_device(device)
    heat, snow, crop = arrays.get("heat"), arrays.get("snow"), arrays.get("crop")
    hydrall, rothc = arrays.get("hydrall"), arrays.get("rothc")
    fields = {name: (None if arrays.get(name) is None
                     else _tensor(arrays[name], dev)) for name in MODEL_MAPS}
    fields.update({name: _tensor(arrays[name], dev)
                   for name in MODEL_ACCUMULATORS})
    fields["_rothc_litter"] = _number_or_tensor(
        arrays.get("_rothc_litter", 0.0), dev)
    fields.update(
        hydrall=None if hydrall is None else hydrall_maps_from_arrays(hydrall, device=dev),
        rothc=None if rothc is None else rothc_state_from_arrays(rothc, device=dev))
    return Criteria3DModel(
        grid=grid_from_arrays(arrays["grid"], meta, device=dev),
        params=params, config=ModelConfig(**arrays["config"]),
        water=state_from_arrays(arrays["water"], device=dev),
        heat=None if heat is None else heat_state_from_arrays(heat, device=dev),
        snow=None if snow is None else snow_state_from_arrays(snow, device=dev),
        crop=None if crop is None else CropParameters(**crop), **fields)


def project_model_from_arrays(project, arrays: dict, meta: dict, *,
                              station_trans: dict | None = None) -> None:
    """Carry a running model into an initialised port project (a
    ``Criteria3DProject``), so that the project goes on from another
    run's state: ``arrays`` and ``meta`` as :func:`model_from_arrays` takes
    them, on the project's device with the project's solver parameters;
    the project's grid becomes the model's. ``station_trans`` is the
    stations' last transmissivity (``{station id: value}``), which the
    project carries through the night hours."""
    project.model = model_from_arrays(arrays, meta, project.params,
                                      device=project.device)
    project.grid = project.model.grid
    if station_trans is not None:
        project._station_trans = {k: float(v) for k, v in station_trans.items()}


# ----------------------------------------------------------------------
# the VINE3D model
# ----------------------------------------------------------------------

# the Vine3DModel's maps carried by vine_model_from_arrays (None stays None)
VINE_MAPS = ("vineyard_mask", "vine_root_density", "grass_root_density",
             "harvested", "stress", "_rain_mm", "_wet_hours", "_rh_sum",
             "_assim_gm2")
# the daily accumulators and running mean: numbers until the first hour
# (the first day) makes them maps
VINE_ACCUMULATORS = ("_tsum", "_tmin", "_tmax", "_t30_avg")


def vine_model_from_arrays(arrays: dict, meta: dict, params: SolverParameters,
                           *, device=None) -> Vine3DModel:
    """A :class:`Vine3DModel` rebuilt from a model's fields as numpy.

    ``arrays`` holds ``grid`` and ``water`` (as :func:`grid_from_arrays` and
    :func:`state_from_arrays` take them); ``vine``, ``downy`` and
    ``powdery`` (dicts of arrays); ``config``, ``vine_params``,
    ``vine_crop``, ``grass_crop``, ``training`` and ``wang_leuning``
    (``dataclasses.asdict`` of each, the last two may be None);
    ``field_map`` (an int array); ``field_book`` (a list of (date,
    field_index, operation, quantity)); the maps of :data:`VINE_MAPS`
    (arrays or None); the accumulators of :data:`VINE_ACCUMULATORS`
    (numbers or arrays); and the scalars ``max_irrigation_rate``,
    ``grass_lai``, ``compute_diseases``, ``water_stress_threshold``,
    ``_nhours`` and ``_irrigation_hours`` (a dict). ``meta`` is the grid's
    scalar fields. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    training, wl = arrays.get("training"), arrays.get("wang_leuning")
    fields = {name: (None if arrays.get(name) is None
                     else _tensor(arrays[name], dev)) for name in VINE_MAPS}
    fields.update({name: _number_or_tensor(arrays[name], dev)
                   for name in VINE_ACCUMULATORS})
    return Vine3DModel(
        grid=grid_from_arrays(arrays["grid"], meta, device=dev),
        params=params, config=ModelConfig(**arrays["config"]),
        water=state_from_arrays(arrays["water"], device=dev),
        vine_params=gv.GrapevineParameters(**arrays["vine_params"]),
        vine=grapevine_state_from_arrays(arrays["vine"], device=dev),
        vine_crop=CropParameters(**arrays["vine_crop"]),
        grass_crop=CropParameters(**arrays["grass_crop"]),
        field_map=np.array(arrays["field_map"], copy=True),
        field_book=[FieldBookEntry(*e) for e in arrays["field_book"]],
        downy=downy_state_from_arrays(arrays["downy"], device=dev),
        powdery=powdery_state_from_arrays(arrays["powdery"], device=dev),
        max_irrigation_rate=float(arrays["max_irrigation_rate"]),
        grass_lai=float(arrays["grass_lai"]),
        training=None if training is None else gv.TrainingSystem(**training),
        wang_leuning=None if wl is None else WangLeuningParameters(**wl),
        compute_diseases=bool(arrays["compute_diseases"]),
        water_stress_threshold=float(arrays["water_stress_threshold"]),
        _nhours=int(arrays["_nhours"]),
        _irrigation_hours=dict(arrays.get("_irrigation_hours") or {}),
        **fields)


# ----------------------------------------------------------------------
# fitted detrending and variogram models
# ----------------------------------------------------------------------

def trend_model_from_arrays(arrays: dict, *, device=None) -> TrendModel:
    """A :class:`TrendModel` from ``arrays``: every array field by name
    (dtypes kept: the flags are bool) and ``elevation_function`` as a
    string or a 0-d string array. ``device=None`` means the CUDA card."""
    dev = resolve_device(device)
    fields = {f.name: _tensor(arrays[f.name], dev)
              for f in dataclasses.fields(TrendModel)
              if f.name != "elevation_function"}
    return TrendModel(elevation_function=str(arrays["elevation_function"]),
                      **fields)


def trend_model_arrays(model: TrendModel) -> dict:
    """Every field of a port :class:`TrendModel` as numpy arrays (and the
    function's name as a string): the arguments of JAX's ``TrendModel``."""
    out = {f.name: host_array(getattr(model, f.name))
           for f in dataclasses.fields(TrendModel)
           if f.name != "elevation_function"}
    out["elevation_function"] = model.elevation_function
    return out


def variogram_model_from_fields(fields: dict) -> VariogramModel:
    """A :class:`VariogramModel` from the fields of JAX's (its mode and
    Python floats; ``dataclasses.asdict`` of either package's model gives
    the other's arguments)."""
    return VariogramModel(int(fields["mode"]), float(fields["nugget"]),
                          float(fields["sill"]), float(fields["range_"]),
                          float(fields.get("slope", 0.0)))
