"""Soil water retention and hydraulic conductivity (van Genuchten / Mualem).

PyTorch counterpart of ``criteria3d_tpu/core/soil.py``: soil parameters are
dense per-node fields (`SoilFields`), so every retention / conductivity
evaluation is element-wise tensor math. Each function evaluates the same
expression, in the same order, as its JAX twin.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from benchmark.reference.device import resolve_device

__all__ = ["WRCModel", "MeanType", "SoilFields", "se_from_psi",
           "theta_from_se", "mualem_conductivity", "compute_mean", "power"]


def _pow_elementwise(x: torch.Tensor, y) -> torch.Tensor:
    """float64 ``x ** y`` on the CPU through torch's element-by-element
    loop, which calls the C library's pow, as XLA:CPU does.

    torch's vectorised CPU pow (SLEEF, 1 ulp) differs from it in ~1.7% of
    elements, and a Python-number exponent takes other special paths
    (-0.5 becomes rsqrt). Operands that are stride-2 views of one buffer
    cannot take the vectorised loop, so both are copied into one."""
    shape = torch.broadcast_shapes(
        x.shape, y.shape if isinstance(y, torch.Tensor) else ())
    buf = torch.empty(tuple(shape) + (2,), dtype=x.dtype, device=x.device)
    buf[..., 0] = x
    buf[..., 1] = y
    return torch.pow(buf[..., 0], buf[..., 1])


def power(x: torch.Tensor, y) -> torch.Tensor:
    """``x ** y`` for a tensor ``x`` and a tensor or number ``y``.

    A float32 power is evaluated in float64 and rounded once to float32: a
    correctly rounded result in all but rare cases, as glibc's powf -- and so
    XLA:CPU, which runs the JAX reference in the tests -- returns it.
    torch's own float32 pow is off by up to an ulp in about 2% of
    elements, and the capacity secant (se_c - se_p) / dpsi of the assembly
    magnifies such an ulp a thousandfold. A number ``y`` is first rounded to
    the dtype of ``x``, as JAX rounds a weakly typed exponent.

    A float64 power on the CPU runs :func:`_pow_elementwise`: the f64
    capacity secant takes |se_c - se_p| / dh down to |dpsi| = 1e-12, where
    one ulp of se is a relative error of up to ~1e-4. On the card it is
    CUDA's pow.
    """
    if x.dtype == torch.float64:
        if x.device.type == "cpu":
            return _pow_elementwise(x, y)
        return torch.pow(x, y)
    if x.dtype != torch.float32:
        return torch.pow(x, y)
    if isinstance(y, torch.Tensor):
        y = y.to(torch.float64)
    else:
        y = float(np.float32(y))
    return torch.pow(x.to(torch.float64), y).to(torch.float32)


class WRCModel(enum.IntEnum):
    """Water retention curve model (reference types.h:135)."""

    VAN_GENUCHTEN = 0
    MODIFIED_VAN_GENUCHTEN = 1


class MeanType(enum.IntEnum):
    """Inter-node conductivity mean (reference types.h:36)."""

    ARITHMETIC = 0
    GEOMETRIC = 1
    LOGARITHMIC = 2


@dataclasses.dataclass(frozen=True, eq=False)
class SoilFields:
    """Dense per-node soil hydraulic parameters (soilData_t, types.h:104-121).

    Units follow the reference: alpha [m-1], he [m], k_sat [m s-1].
    ``mualem_den`` is the precomputed modified-VG Mualem denominator
    1 - [1 - Sc^(1/m)]^m.
    """

    vg_alpha: torch.Tensor
    vg_n: torch.Tensor
    vg_m: torch.Tensor
    vg_he: torch.Tensor
    vg_sc: torch.Tensor
    theta_s: torch.Tensor
    theta_r: torch.Tensor
    k_sat: torch.Tensor
    mualem_l: torch.Tensor
    mualem_den: torch.Tensor

    @staticmethod
    def uniform(shape, *, vg_alpha, vg_n, vg_he=0.0, theta_s, theta_r, k_sat,
                mualem_l=0.5, dtype=torch.float64, device=None) -> "SoilFields":
        """Spatially-uniform soil field; ``vg_m = 1 - 1/n`` and
        ``vg_sc = [1 + (alpha*he)^n]^(-m)`` as the reference pedology layer
        derives them. ``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        m = 1.0 - 1.0 / vg_n
        sc = (1.0 + (vg_alpha * vg_he) ** vg_n) ** (-m)

        def full(v):
            return torch.full(tuple(shape), v, dtype=dtype, device=dev)

        m_arr, sc_arr = full(m), full(sc)
        den = 1.0 - power(1.0 - power(sc_arr, 1.0 / m_arr), m_arr)
        return SoilFields(
            vg_alpha=full(vg_alpha), vg_n=full(vg_n), vg_m=m_arr,
            vg_he=full(vg_he), vg_sc=sc_arr,
            theta_s=full(theta_s), theta_r=full(theta_r),
            k_sat=full(k_sat), mualem_l=full(mualem_l),
            mualem_den=den,
        )


def se_from_psi(soil: SoilFields, psi: torch.Tensor,
                model: WRCModel) -> torch.Tensor:
    """Degree of saturation from the positive matric potential magnitude
    (computeNodeSe_fromPsi, soilPhysics.cpp:91-115)."""
    base = power(1.0 + power(soil.vg_alpha * psi, soil.vg_n), -soil.vg_m)
    if model == WRCModel.VAN_GENUCHTEN:
        return base
    return torch.where(psi <= soil.vg_he, 1.0, base / soil.vg_sc)


def theta_from_se(soil: SoilFields, se: torch.Tensor) -> torch.Tensor:
    """Volumetric water content from degree of saturation."""
    return se * (soil.theta_s - soil.theta_r) + soil.theta_r


def mualem_conductivity(soil: SoilFields, se: torch.Tensor,
                        model: WRCModel) -> torch.Tensor:
    """Unsaturated hydraulic conductivity K(Se) [m s-1]
    (computeMualemSoilConductivity, soilPhysics.cpp:181-214)."""
    inv_m = 1.0 / soil.vg_m
    se_c = torch.clamp(se, 1e-12, 1.0)
    if model == WRCModel.VAN_GENUCHTEN:
        num = 1.0 - power(1.0 - power(se_c, inv_m), soil.vg_m)
        temp = num
    else:
        sesc = torch.clamp_max(se_c * soil.vg_sc, 1.0)
        num = 1.0 - power(1.0 - power(sesc, inv_m), soil.vg_m)
        temp = num / soil.mualem_den
    k = soil.k_sat * power(se_c, soil.mualem_l) * temp * temp
    return torch.where(se >= 1.0, soil.k_sat, k)


def compute_mean(v1: torch.Tensor, v2: torch.Tensor,
                 mean_type: MeanType) -> torch.Tensor:
    """Two-value mean: arithmetic / geometric / logarithmic
    (otherFunctions.cpp:7-36).

    The logarithmic mean uses the well-conditioned symmetric form
    (hi-lo) / -log1p(-(hi-lo)/hi), with the ``finfo.tiny`` guard for
    equal values, exactly as the JAX package does.
    """
    if mean_type == MeanType.ARITHMETIC:
        return 0.5 * (v1 + v2)
    if mean_type == MeanType.GEOMETRIC:
        return torch.sign(v1) * torch.sqrt(v1 * v2)
    hi = torch.maximum(v1, v2)
    lo = torch.minimum(v1, v2)
    hi_safe = torch.where(hi == 0.0, 1.0, hi)
    d = (hi - lo) / hi_safe
    denom = -torch.log1p(-torch.clamp_max(d, 1.0))
    tiny = d <= torch.finfo(torch.result_type(v1, v2)).tiny
    denom = torch.where(tiny, 1.0, denom)
    return torch.where(tiny, hi, (hi - lo) / denom)
