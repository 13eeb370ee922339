"""Grapevine powdery mildew (Erysiphe necator), the VINE3D disease model.

PyTorch counterpart of ``criteria3d_tpu/physics/powdery_mildew.py``
(src/grapevine/powderyMildew.cpp; Costantini 2013): degree-day driven
ascospore maturation, rain-triggered discharge onto leaves,
temperature / VPD-dependent infection and colony latency. Daily step on
arrays of any shape.

The state is float32 by default and the mean temperature is cast to it;
rain, leaf wetness and humidity keep their own dtype, so float64 maps
promote the step's products to float64 as they do in JAX, and numbers stay
weakly typed (rounded to the other operand's dtype).
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import div, rdiv, sq, where
from criteria3d_tpu_torch.physics.downy_mildew import vapour_pressure_deficit

__all__ = ["PowderyMildewState", "powdery_mildew_step"]

# model constants (powderyMildew.cpp:23-31)
DELTA = 0.969
LAMBDA = 0.0004
FI = 7.391
NU = 2.403
CSI = 0.892
UPSILON = 0.221
GAMMA = 44.7
PSI = 0.067
THETA = 3.244


def _ready_fraction_f64(degree_day: float) -> float:
    """:func:`ascospores_ready_fraction` of a number, in float64."""
    return float(ascospores_ready_fraction(
        torch.tensor(degree_day, dtype=torch.float64)))


@dataclasses.dataclass(frozen=True, eq=False)
class PowderyMildewState:
    degree_days: torch.Tensor
    aic: torch.Tensor                 # ascospores in chasmothecia (mature pool)
    current_colonies: torch.Tensor
    total_sporulating: torch.Tensor

    @staticmethod
    def initialize(shape=(), dtype=torch.float32,
                   device=None) -> "PowderyMildewState":
        """``device=None`` means the CUDA card."""
        dev = resolve_device(device)

        def z(v):
            return torch.full(tuple(shape), v, dtype=dtype, device=dev)

        return PowderyMildewState(
            degree_days=z(0.0), aic=z(_ready_fraction_f64(0.0)),
            current_colonies=z(0.0), total_sporulating=z(0.0))

    def to(self, device) -> "PowderyMildewState":
        return map_tensors(self, lambda t: t.to(device))


def compute_degree_day(t):
    """Base-10 degree day (powderyMildew.cpp:116-122)."""
    return torch.clamp_min(t - 10.0, 0.0)


def ascospores_ready_fraction(degree_day):
    """(powderyMildew.cpp:141-145)."""
    return torch.exp(-1.95 * torch.exp(div(-1.91 * degree_day, 100.0)))


def ascospore_discharge_rate(t, rain, leaf_wetness):
    """(powderyMildew.cpp:164-172)."""
    rate = 1.0 - DELTA * torch.exp(-LAMBDA * sq(t) * leaf_wetness)
    return where((t < 4) | (t > 30) | (rain < 2), 0.0, rate)


def infection_rate(t, vpd):
    """(powderyMildew.cpp:191-203)."""
    teq = torch.clamp(div(t - 5.0, 26.0), 1e-6, 1.0 - 1e-6)
    rate = power(FI * power(teq, NU) * (1.0 - teq), CSI) \
        * torch.exp(-UPSILON * vpd)
    return where((t < 5) | (t > 31), 0.0, rate)


def latency_progress(t):
    """(powderyMildew.cpp:221-225)."""
    return rdiv(1.0, GAMMA + PSI * sq(t) - THETA * t)


def powdery_mildew_step(state: PowderyMildewState, *, tavg, rain,
                        leaf_wetness, relative_humidity,
                        is_bud_break=False):
    """One daily step (powderyMildew, powderyMildew.cpp:34-97). Returns
    (new_state, outputs dict with aol / col / infection_rate /
    infection_risk / day_infection / day_sporulation)."""
    if is_bud_break:
        state = PowderyMildewState.initialize(
            state.degree_days.shape, state.degree_days.dtype,
            device=state.degree_days.device)

    tavg = torch.as_tensor(tavg, dtype=state.degree_days.dtype,
                           device=state.degree_days.device)
    dd_inc = compute_degree_day(tavg)
    vpd = vapour_pressure_deficit(tavg, relative_humidity)

    aic = state.aic + (ascospores_ready_fraction(state.degree_days + dd_inc)
                       - ascospores_ready_fraction(state.degree_days))

    inf_rate = infection_rate(tavg, vpd)
    infection_risk = inf_rate * aic

    aol = aic * ascospore_discharge_rate(tavg, rain, leaf_wetness)
    aic = aic - aol
    col = aol * inf_rate

    latency = latency_progress(tavg)
    daily_sporulating = state.current_colonies * latency
    total_sporulating = state.total_sporulating + daily_sporulating
    current_colonies = state.current_colonies + col - daily_sporulating

    new_state = PowderyMildewState(
        degree_days=state.degree_days + dd_inc, aic=aic,
        current_colonies=current_colonies,
        total_sporulating=total_sporulating)
    outputs = dict(aol=aol, col=col, infection_rate=inf_rate,
                   infection_risk=infection_risk,
                   day_infection=col > 0.001,
                   day_sporulation=daily_sporulating > 0.001)
    return new_state, outputs
