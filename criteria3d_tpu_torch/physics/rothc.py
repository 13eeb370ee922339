"""RothC soil organic carbon model (Rothamsted), element-wise on maps.

PyTorch counterpart of ``criteria3d_tpu/physics/rothc.py``
(src/rothCplusplus/rothCplusplus.cpp, Coleman & Jenkinson's RothC, monthly
step): the DPM/RPM/BIO/HUM/IOM carbon pools with temperature / moisture /
plant-cover rate modifiers and the clay-dependent CO2:(BIO+HUM) partition.
State is a dataclass of (R, C) float64 maps; one call is one monthly step.
Monthly forcing may be numbers, 0-d tensors or maps.
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import as_f64, div, rdiv, where

__all__ = ["RothCState", "rothc_monthly_step", "rmf_temperature",
           "rmf_moisture", "rmf_plant_cover"]

# decomposition rate constants [yr-1] (rothCplusplus.cpp:418-421)
K_DPM = 10.0
K_RPM = 0.3
K_BIO = 0.66
K_HUM = 0.02


@dataclasses.dataclass(frozen=True, eq=False)
class RothCState:
    """Carbon pools [t C/ha] + accumulated soil water deficit [mm]."""

    dpm: torch.Tensor     # decomposable plant material
    rpm: torch.Tensor     # resistant plant material
    bio: torch.Tensor     # microbial biomass
    hum: torch.Tensor     # humified organic matter
    iom: torch.Tensor     # inert organic matter
    swc: torch.Tensor     # [mm] soil moisture deficit (negative)

    @property
    def soc(self):
        return self.dpm + self.rpm + self.bio + self.hum + self.iom

    @staticmethod
    def initialize(shape, *, soc_total=50.0, iom=None, dtype=torch.float64,
                   device=None) -> "RothCState":
        """Typical pool split for an equilibrium arable soil; IOM by the
        Falloon equation when not given. ``device=None`` means the CUDA
        card."""
        dev = resolve_device(device)
        soc = torch.full(tuple(shape), soc_total, dtype=dtype, device=dev)
        if iom is None:
            iom = 0.049 * power(soc, 1.139)          # Falloon et al. 1998
        rest = soc - iom
        return RothCState(dpm=0.01 * rest, rpm=0.12 * rest, bio=0.03 * rest,
                          hum=0.84 * rest, iom=iom,
                          swc=torch.zeros(tuple(shape), dtype=dtype, device=dev))

    def to(self, device) -> "RothCState":
        return map_tensors(self, lambda t: t.to(device))


def rmf_temperature(temp_c):
    """Temperature rate modifier (RMF_Tmp, rothCplusplus.cpp:406-414)."""
    rm = rdiv(47.91, torch.exp(rdiv(106.06, temp_c + 18.27)) + 1.0)
    return where(temp_c < -5.0, 0.0, rm)


def rmf_moisture(swc, monthly_bic, clay_pct, depth_cm, plant_cover):
    """(new_swc, rate modifier): moisture factor from the accumulated soil
    water deficit (RMF_Moist, rothCplusplus.cpp:366-392).

    ``monthly_bic``: climatic water balance rain - 0.75 PET [mm];
    ``plant_cover``: a bool / 0-1 map or 0-d tensor; ``clay_pct`` and
    ``depth_cm`` are numbers."""
    smd_max = -(20.0 + 1.3 * clay_pct - 0.01 * clay_pct ** 2)
    smd_max_adj = smd_max * depth_cm / 23.0
    smd_1bar = 0.444 * smd_max_adj
    smd_bare = 0.556 * smd_max_adj

    min_swc_df = torch.clamp_max(swc + monthly_bic, 0.0)
    min_bare = torch.clamp_max(swc, smd_bare)
    covered = plant_cover > 0
    new_swc = torch.where(covered, torch.clamp_min(min_swc_df, smd_max_adj),
                          torch.maximum(min_bare, min_swc_df))

    rm = where(new_swc > smd_1bar, 1.0,
               0.2 + div(0.8 * (smd_max_adj - new_swc), smd_max_adj - smd_1bar))
    return new_swc, torch.clamp(rm, 0.2, 1.0)


def rmf_plant_cover(plant_cover):
    """Retainment factor: 1 bare, 0.6 covered, linear in between
    (RMF_plantCover, rothCplusplus.cpp:321-335)."""
    return -0.4 * torch.clamp(plant_cover, 0.0, 1.0) + 1.0


def rothc_monthly_step(state: RothCState, *, temp_c, monthly_bic,
                       clay_pct, depth_cm=23.0, plant_cover=0.0,
                       carbon_input=0.0, fym_input=0.0,
                       dpm_rpm_ratio=1.44) -> tuple[RothCState, dict]:
    """One monthly RothC step. Returns (new_state, diagnostics).

    Crit3DRothCplusplus::RothC + decomp (rothCplusplus.cpp:416-553,
    556-600): pool decay by exp(-abc k/12), partition of the decomposed flux
    into CO2 : BIO : HUM = x : 0.46 : 0.54 with
    x = 1.67 (1.85 + 1.60 exp(-0.0786 clay)), then plant / FYM inputs.
    ``clay_pct``, ``depth_cm``, ``fym_input`` and ``dpm_rpm_ratio`` are
    numbers; the forcing may be numbers or tensors.
    """
    dev = state.dpm.device
    temp_c = as_f64(temp_c, dev)
    plant_cover = as_f64(plant_cover, dev)
    rm_tmp = rmf_temperature(temp_c)
    swc, rm_moist = rmf_moisture(state.swc, as_f64(monthly_bic, dev),
                                 clay_pct, depth_cm, plant_cover)
    rm_pc = rmf_plant_cover(plant_cover)
    abc = rm_tmp * rm_moist * rm_pc

    tstep = 1.0 / 12.0
    dpm1 = state.dpm * torch.exp(-abc * K_DPM * tstep)
    rpm1 = state.rpm * torch.exp(-abc * K_RPM * tstep)
    bio1 = state.bio * torch.exp(-abc * K_BIO * tstep)
    hum1 = state.hum * torch.exp(-abc * K_HUM * tstep)

    d_dpm = state.dpm - dpm1
    d_rpm = state.rpm - rpm1
    d_bio = state.bio - bio1
    d_hum = state.hum - hum1
    total_decomposed = d_dpm + d_rpm + d_bio + d_hum

    # clay_pct is a number: the partition is host arithmetic, with the
    # exponential evaluated as a float64 tensor as JAX evaluates jnp.exp
    e = float(torch.exp(torch.tensor(-0.0786 * clay_pct, dtype=torch.float64)))
    x = 1.67 * (1.85 + 1.60 * e)
    to_co2 = x / (x + 1.0)
    to_bio = 0.46 / (x + 1.0)
    to_hum = 0.54 / (x + 1.0)

    bio_new = bio1 + total_decomposed * to_bio
    hum_new = hum1 + total_decomposed * to_hum
    co2 = total_decomposed * to_co2

    # plant / farmyard-manure inputs (rothCplusplus.cpp:467-479)
    carbon_input = as_f64(carbon_input, dev)
    pi_dpm = dpm_rpm_ratio / (dpm_rpm_ratio + 1.0) * carbon_input
    pi_rpm = 1.0 / (dpm_rpm_ratio + 1.0) * carbon_input
    dpm_new = dpm1 + pi_dpm + 0.49 * fym_input
    rpm_new = rpm1 + pi_rpm + 0.49 * fym_input
    hum_new = hum_new + 0.02 * fym_input

    new = RothCState(dpm=dpm_new, rpm=rpm_new, bio=bio_new, hum=hum_new,
                     iom=state.iom, swc=swc)
    diag = dict(co2=co2, rm_tmp=rm_tmp, rm_moist=rm_moist, rm_pc=rm_pc,
                soc=new.soc)
    return new, diag

