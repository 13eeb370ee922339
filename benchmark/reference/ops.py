"""Arithmetic helpers that keep the JAX package's float semantics.

JAX (x64 on) and torch round some expressions differently; these helpers
spell out the JAX form:

- a tensor divided by a Python constant is a true division (:func:`div`):
  CUDA turns division by a host scalar into multiplication by its rounded
  reciprocal;
- a Python constant divided by a tensor is a true division (:func:`rdiv`):
  torch turns ``c / tensor`` into ``c * reciprocal(tensor)``;
- a float32 tensor times a 0-d float64 tensor is float64 in JAX but float32
  in torch (:func:`mul0` casts first);
- ``x ** n`` for a Python int ``n`` is JAX's ``integer_pow``, which XLA
  lowers to multiplications by binary exponentiation (:func:`ipow`);
- ``jnp.where`` with a Python number keeps the other operand's dtype
  (:func:`where`; ``torch.where`` of two numbers is float32);
- ``jnp.asarray(x, jnp.float64)`` takes numbers, arrays and tensors
  (:func:`as_f64`);
- ``jnp.linspace`` is a jitted program that XLA:CPU rewrites into fused
  multiply-adds; :func:`linspace` evaluates the same fused forms (with an
  exact :func:`fma`), where ``torch.linspace`` fills from both ends.

Other powers go through :func:`benchmark.reference.core.soil.power`.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["const", "div", "rdiv", "mul0", "sq"]


@functools.lru_cache(maxsize=None)
def const(v: float, dtype, device) -> torch.Tensor:
    """A cached 0-d tensor holding the Python number ``v``."""
    return torch.full((), v, dtype=dtype, device=device)


def div(a: torch.Tensor, v: float) -> torch.Tensor:
    """``a / v`` for a Python number ``v``, as a true division."""
    return a / const(float(v), a.dtype, a.device)


def rdiv(v: float, a: torch.Tensor) -> torch.Tensor:
    """``v / a`` for a Python number ``v``, as a true division."""
    return const(float(v), a.dtype, a.device) / a


def mul0(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``a * s`` for a 0-d tensor ``s`` with JAX's promotion (a float32
    field times a float64 0-d array is float64)."""
    return a.to(torch.promote_types(a.dtype, s.dtype)) * s


def sq(x: torch.Tensor) -> torch.Tensor:
    return x * x


