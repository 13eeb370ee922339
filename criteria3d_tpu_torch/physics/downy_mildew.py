"""Grapevine downy mildew (Plasmopara viticola), the VINE3D disease model.

PyTorch counterpart of ``criteria3d_tpu/physics/downy_mildew.py``
(src/grapevine/downyMildew.cpp; Costantini 2013, Rossi et al. model):
oospore dormancy breaking by hydrothermal time, then a cohort state machine
(germination, sporangia, zoospore release, leaf infection, oil-spot
symptoms). Cohorts live in a fixed pool of ``N_SLOTS`` slots (stage 0 =
free), so the whole map advances in one element-wise pass per hour.

The state is float32 by default, as in JAX (also under its x64), and every
input is cast to the state's dtype before the step. Arrays have shape
(..., N_SLOTS) or (...); shape () runs a single point.
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import div, rdiv, sq, where

__all__ = ["DownyMildewState", "DownyMildewInput", "downy_mildew_step",
           "hydrothermal_time", "dormancy_breaking", "vapour_pressure_deficit",
           "N_SLOTS"]

N_SLOTS = 16


@dataclasses.dataclass(frozen=True, eq=False)
class DownyMildewState:
    """Per-point model state; cohort arrays have a trailing slot axis."""

    htt: torch.Tensor            # hydrothermal time since Jan 1
    current_pmo: torch.Tensor    # physiologically mature oospores awaiting rain
    is_germination: torch.Tensor  # bool
    stage: torch.Tensor          # (..., N) int32: 0 free, 1..5 active stages
    cohort: torch.Tensor         # (..., N) spore fraction of the cohort
    rate: torch.Tensor           # (..., N)
    wet_duration: torch.Tensor   # (..., N)
    sum_t: torch.Tensor          # (..., N)
    nr_hours: torch.Tensor       # (..., N)
    seq: torch.Tensor            # (..., N) insertion order (newest = max)
    seq_counter: torch.Tensor    # next sequence number

    @staticmethod
    def initialize(shape=(), dtype=torch.float32,
                   device=None) -> "DownyMildewState":
        """``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        shape = tuple(shape)

        def z():
            return torch.zeros(shape, dtype=dtype, device=dev)

        def zn():
            return torch.zeros(shape + (N_SLOTS,), dtype=dtype, device=dev)

        return DownyMildewState(
            htt=z(), current_pmo=z(),
            is_germination=torch.zeros(shape, dtype=torch.bool, device=dev),
            stage=torch.zeros(shape + (N_SLOTS,), dtype=torch.int32, device=dev),
            cohort=zn(), rate=zn(), wet_duration=zn(), sum_t=zn(),
            nr_hours=zn(), seq=zn(), seq_counter=z())

    def to(self, device) -> "DownyMildewState":
        return map_tensors(self, lambda t: t.to(device))


@dataclasses.dataclass
class DownyMildewInput:
    tair: object                 # [degC]
    rain: object                 # [mm]
    leaf_wetness: object         # 0/1
    relative_humidity: object    # [%]


def _clip_number_or_tensor(x, lo: float, hi: float):
    if isinstance(x, torch.Tensor):
        return torch.clamp(x, lo, hi)
    return min(max(x, lo), hi)


def vapour_pressure_deficit(tair, rh):
    """[hPa] (physics.cpp vapourPressureDeficit). ``rh`` may be a number,
    which keeps JAX's weak typing: its term is formed in float64 and
    rounded once to the dtype of ``tair``."""
    es = 6.112 * torch.exp(17.67 * tair / (tair + 243.5))
    rh = _clip_number_or_tensor(rh, 0.0, 100.0)
    frac = 1.0 - (div(rh, 100.0) if isinstance(rh, torch.Tensor) else rh / 100.0)
    return es * frac


def leaf_litter_moisture(rain, vpd):
    """Dichotomic litter moisture (downyMildew.cpp:249-255), in the dtype
    of ``vpd``."""
    return where((rain > 0) | (vpd <= 4.5), 1.0, 0.0, vpd.dtype)


def hydrothermal_time(tair, llm):
    """(downyMildew.cpp:273-278)."""
    denom = 1330.1 - 116.19 * tair + 2.6256 * sq(tair)
    if not isinstance(llm, torch.Tensor):
        llm = torch.full_like(tair, llm)
    return where(tair <= 0.0, 0.0, llm / denom)


def dormancy_breaking(htt):
    """(downyMildew.cpp:295-298)."""
    return torch.exp(-15.891 * torch.exp(-0.653 * (htt + 1.0)))


def survival_rate_sporangia(tair, rh):
    """(downyMildew.cpp:316-324)."""
    rh = div(torch.clamp(rh, 1.0, 100.0), 100.0)
    x = tair * (1.0 - rh)
    return rdiv(1.0, 24.0 * (5.67 - 0.47 * x + 0.01 * sq(x)))


def incubation(tair):
    """(downyMildew.cpp:341-344)."""
    return rdiv(1.0, 24.0 * (45.1 - 3.45 * tair + 0.073 * sq(tair)))


def downy_mildew_step(state: DownyMildewState, inp: DownyMildewInput,
                      is_first_january=False):
    """One hourly step; returns (new_state, outputs dict): downyMildew
    (downyMildew.cpp:20-226) with the cohort vector as a fixed slot pool.
    Inputs may be numbers or tensors of any float dtype; each is cast to
    the state's dtype."""
    if is_first_january:
        state = DownyMildewState.initialize(state.htt.shape, state.htt.dtype,
                                            device=state.htt.device)
    dt, dev = state.htt.dtype, state.htt.device

    def cast(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    tair = cast(inp.tair)
    rain = cast(inp.rain)
    wet = cast(inp.leaf_wetness)
    rh = cast(inp.relative_humidity)

    vpd = vapour_pressure_deficit(tair, rh)
    llm = leaf_litter_moisture(rain, vpd)

    prev_pmo = dormancy_breaking(state.htt)
    htt = state.htt + hydrothermal_time(tair, llm)
    sum_pmo = dormancy_breaking(htt)
    hourly_pmo = torch.clamp_min(sum_pmo - prev_pmo, 0.0)

    # --- start a new germination cohort (downyMildew.cpp:64-83) ---
    can_germinate = ((htt >= 1.3) & (htt < 8.6) & (rain >= 0.2)
                     & (state.current_pmo >= 0.01) & ~state.is_germination)
    free = state.stage == 0
    has_free = torch.any(free, dim=-1)
    first_free = torch.argmax(free.to(torch.uint8), dim=-1)
    start = can_germinate & has_free

    slot_idx = torch.arange(N_SLOTS, device=dev)
    is_new = start[..., None] & (slot_idx == first_free[..., None])

    stage = torch.where(is_new, 1, state.stage)
    cohort = torch.where(is_new, state.current_pmo[..., None], state.cohort)
    rate = where(is_new, 0.0, state.rate)
    wet_dur = where(is_new, 0.0, state.wet_duration)
    sum_t = where(is_new, 0.0, state.sum_t)
    nr_hours = where(is_new, 0.0, state.nr_hours)
    seq_counter = torch.where(start, state.seq_counter + 1.0,
                              state.seq_counter)
    seq = torch.where(is_new, seq_counter[..., None], state.seq)

    current_pmo = where(start, 0.0, state.current_pmo)
    is_germ = start | state.is_germination
    # the first dry hour ends the germination event
    is_germ = is_germ & ~(llm == 0)
    current_pmo = current_pmo + hourly_pmo

    tair_b = tair[..., None]
    rain_b = rain[..., None]
    wet_b = wet[..., None]
    rh_b = rh[..., None]
    llm_b = llm[..., None]

    out_infection = torch.zeros_like(state.htt, dtype=torch.bool)
    out_rate = torch.zeros_like(state.htt)
    out_oil = torch.zeros_like(state.htt)

    # --- STAGE 1: germination in the litter ---
    s1 = stage == 1
    rate = torch.where(s1, rate + hydrothermal_time(tair_b, llm_b), rate)
    to_s2 = s1 & (rate >= 1.0)
    stage = torch.where(to_s2, 2, stage)
    rate = where(to_s2, 0.0, rate)
    wet_dur = where(to_s2, 0.0, wet_dur)
    sum_t = where(to_s2, 0.0, sum_t)
    nr_hours = where(to_s2, 0.0, nr_hours)

    # --- STAGE 2: sporangia survival / zoospore maturation ---
    s2 = (stage == 2) & ~to_s2
    rate = torch.where(s2, rate + survival_rate_sporangia(tair_b, rh_b), rate)
    dead2 = s2 & (rate > 1.0)
    active2 = s2 & ~dead2 & (wet_b > 0)
    nr_hours = torch.where(active2, nr_hours + 1, nr_hours)
    wet_dur = torch.where(active2, wet_dur + wet_b, wet_dur)
    sum_t = torch.where(active2, sum_t + tair_b, sum_t)
    avg_t = sum_t / torch.clamp_min(nr_hours, 1.0)
    zre_thresh = torch.exp(-1.022 + rdiv(19.634, torch.clamp_min(avg_t, 0.1)))
    to_s3 = active2 & (wet_dur >= zre_thresh)
    stage = torch.where(to_s3, 3, stage)
    wet_dur = where(to_s3, 0.0, wet_dur)
    nr_hours = where(to_s3, 0.0, nr_hours)

    # --- STAGE 3: zoospores released, need wetness + splash rain ---
    s3 = (stage == 3) & ~to_s3
    wet_dur = torch.where(s3, wet_dur + wet_b, wet_dur)
    nr_hours = torch.where(s3, nr_hours + 1, nr_hours)
    dead3 = s3 & ((nr_hours - wet_dur) > 1)
    to_s4 = s3 & ~dead3 & (rain_b > 0.2)
    stage = torch.where(to_s4, 4, stage)
    wet_dur = where(to_s4, 1.0, wet_dur)
    sum_t = torch.where(to_s4, tair_b, sum_t)
    nr_hours = where(to_s4, 1.0, nr_hours)

    # --- STAGE 4: zoospores on leaves -> infection ---
    s4 = (stage == 4) & ~to_s4
    wet_dur = torch.where(s4, wet_dur + wet_b, wet_dur)
    nr_hours = torch.where(s4, nr_hours + 1, nr_hours)
    dead4 = s4 & ((nr_hours - wet_dur) > 1)
    alive4 = s4 & ~dead4
    sum_t = torch.where(alive4, sum_t + tair_b, sum_t)
    avg_t4 = sum_t / torch.clamp_min(nr_hours, 1.0)
    wdtwd = avg_t4 * wet_dur
    infect = alive4 & (wdtwd >= 60.0)
    stage = torch.where(infect, 5, stage)
    rate = where(infect, 0.0, rate)
    out_infection = out_infection | torch.any(infect, dim=-1)
    out_rate = out_rate + torch.sum(where(infect, cohort, 0.0), dim=-1)

    # --- STAGE 5: incubation -> oil spots ---
    s5 = (stage == 5) & ~infect
    rate = torch.where(s5, rate + incubation(tair_b), rate)
    done5 = s5 & (rate > 1.0)
    # the reference assigns output.oilSpots = cohort (downyMildew.cpp:213),
    # so of several cohorts finishing in one hour only the newest (the
    # last pushed) is reported; oil_spots_total carries the sum
    oil_total = torch.sum(where(done5, cohort, 0.0), dim=-1)
    newest = torch.amax(where(done5, seq, -1.0), dim=-1, keepdim=True)
    out_oil = out_oil + torch.sum(
        where(done5 & (seq == newest), cohort, 0.0), dim=-1)
    out_rate = out_rate + torch.sum(where(s5 & ~done5, cohort, 0.0), dim=-1)

    # free dead / completed slots
    gone = dead2 | dead3 | dead4 | done5
    stage = torch.where(gone, 0, stage)

    new_state = DownyMildewState(
        htt=htt, current_pmo=current_pmo, is_germination=is_germ,
        stage=stage, cohort=cohort, rate=rate, wet_duration=wet_dur,
        sum_t=sum_t, nr_hours=nr_hours, seq=seq, seq_counter=seq_counter)
    outputs = dict(is_infection=out_infection, infection_rate=out_rate,
                   oil_spots=out_oil, oil_spots_total=oil_total,
                   mmo=1.0 - sum_pmo)
    return new_state, outputs
