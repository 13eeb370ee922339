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

Other powers go through :func:`criteria3d_tpu_torch.core.soil.power`.
"""

from __future__ import annotations

import torch

__all__ = ["const", "div", "rdiv", "mul0", "sq", "ipow", "where", "as_f64",
           "fma", "linspace"]


def const(v: float, dtype, device) -> torch.Tensor:
    """A 0-d tensor holding the Python number ``v``: cached, except while a
    CUDA graph captures on ``device``. A tensor made there is filled only
    when its graph replays, so a cached one would hold no value for code
    that runs before that replay (another graph, or eager code); under a
    capture the fill is captured with the graph that reads it."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        cached = _CONSTS.get((v, dtype, device))
        return torch.full((), v, dtype=dtype, device=device) if cached is None else cached
    key = (v, dtype, device)
    if key not in _CONSTS:
        _CONSTS[key] = torch.full((), v, dtype=dtype, device=device)
    return _CONSTS[key]


_CONSTS: dict = {}


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


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for a positive Python int ``n`` as XLA lowers
    ``integer_pow``: binary exponentiation by multiplications."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def where(cond: torch.Tensor, a, b, dtype=torch.float64) -> torch.Tensor:
    """``jnp.where(cond, a, b)`` where ``a`` or ``b`` may be Python numbers:
    a number takes the dtype of the other operand, or ``dtype`` when both
    are numbers, as a weakly typed JAX scalar does under x64."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full(cond.shape, a, dtype=dtype, device=cond.device)
    return torch.where(cond, a, b)


def as_f64(x, device=None) -> torch.Tensor:
    """``jnp.asarray(x, jnp.float64)``: a tensor cast to float64 where it
    lies; a number or array as a float64 tensor on ``device`` (the CPU when
    None)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, t) with s = fl(a + b) and a + b = s + t exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a: torch.Tensor):
    """Veltkamp's split of float64 ``a`` into 26- and 27-bit halves."""
    c = a * 134217729.0          # 2**27 + 1
    hi = c - (c - a)
    return hi, a - hi


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with one rounding, for float64 tensors: the product is
    split exactly (Dekker's two-product) and the three parts are added
    without error but in the last step. Matches a hardware FMA except at
    a double-rounding tie of the last addition."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, t = _two_sum(p, c)
    return s + (t + e)


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` along a new last axis, as XLA:CPU
    computes it. ``jnp.linspace`` is jitted; XLA turns ``i / div`` into
    ``i * r`` with ``r = 1 / div``, ``stop * (i * r)`` into ``i * (stop *
    r)``, and LLVM fuses the final add, so element ``i < num - 1`` is
    ``fma(i, stop * r, start * (1 - i * r))`` (element 1, whose ``1 * x``
    folds away, is ``fma(start, 1 - r, stop * r)``) and the last is
    ``stop``. ``start`` and ``stop`` are float64 tensors of one shape (a
    batch of ranges)."""
    if num == 1:
        return start[..., None]
    r = 1.0 / (num - 1)
    q = stop * r
    cols = []
    for i in range(num - 1):
        if i == 0:
            cols.append(start * 1.0)
        elif i == 1:
            cols.append(fma(start, torch.full_like(start, 1.0 - r), q))
        else:
            cols.append(fma(torch.full_like(q, float(i)), q,
                            start * (1.0 - i * r)))
    cols.append(stop)
    return torch.stack(cols, dim=-1)
