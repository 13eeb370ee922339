"""Nonlinear function fitting for proxy detrending.

PyTorch counterpart of ``criteria3d_tpu/physics/fitting.py``: the
piecewise lapse-rate functions used for the elevation proxy
(lapseRatePiecewise_two/_three/_three_free, furtherMathFunctions.cpp:115-180)
and a Levenberg-Marquardt fitter (bestFittingMarquardt_nDimension) run as a
*batched* solver:

- every problem of a batch (the first-guess starts of one fit, times the
  cells of a local-detrending map) is one row of plain tensors, so the
  whole search is a fixed number of batched tensor operations;
- the residual Jacobian is analytic: a fitted function carries its
  ``jacobian(x, p)`` (``x.shape + (n,)``), as each function here does,
  following JAX's forward-mode rules at ties: the chosen branch's
  derivative at a ``where`` and half of each operand's at
  ``maximum(10, p2) == 10`` (:func:`_knee_width`);
- stations are fixed-size masked rows (invalid stations carry ``w == 0``);
- the small solves are ``torch.linalg.solve_ex``: a singular system gives
  non-finite steps, as JAX's solve does, and the card never waits for a
  check.

Parameters live on the last axis: ``func(x, p)`` reads ``p[..., i]``, so
``p`` of shape ``(B, 1, n)`` against ``x`` of shape ``(B, k)`` evaluates a
batch of fits, and ``(n,)`` against ``(k,)`` a single one.

For the non-elevation proxies the reference fits ``functionLinear_intercept``
(par0*x + par1) summed over proxies with the same Marquardt loop
(multipleDetrendingOtherProxiesFitting, interpolation.cpp:2137-2141); the
exact minimiser of that objective is weighted linear least squares, provided
in closed form (:func:`weighted_multilinear`).
"""

from __future__ import annotations

import itertools

import torch

from criteria3d_tpu_torch.device import input_device
from criteria3d_tpu_torch.ops import as_f64, const, linspace, sq

__all__ = [
    "lapse_piecewise_two", "lapse_piecewise_three", "lapse_piecewise_three_free",
    "linear_intercept", "levenberg_marquardt", "best_fitting_marquardt",
    "first_guess_grid", "weighted_multilinear",
]


def _p(p, i):
    return p[..., i]


def _knee_width(p):
    """(max(10, p2), its derivative in p2): JAX's ``maximum`` splits the
    derivative 0.5 / 0.5 where the two are equal."""
    p2 = _p(p, 2)
    ten = const(10.0, p2.dtype, p2.device)
    d = torch.where(p2 > ten, 1.0, torch.where(p2 == ten, 0.5, 0.0)).to(p2.dtype)
    return torch.maximum(ten, p2), d


def lapse_piecewise_two(x, p):
    """Two-piece lapse line through A(p0, p1); slopes p2 below, p3 above
    (lapseRatePiecewise_two, furtherMathFunctions.cpp:115-132)."""
    p0, p1, p2, p3 = (_p(p, i) for i in range(4))
    return torch.where(x < p0, p2 * (x - p0) + p1, p3 * (x - p0) + p1)


def _jac_two(x, p):
    p0, p2, p3 = _p(p, 0), _p(p, 2), _p(p, 3)
    lo = x < p0
    xp = x - p0
    one = torch.ones_like(xp)
    zero = torch.zeros_like(xp)
    return torch.stack([torch.where(lo, -p2, -p3).expand_as(xp), one,
                        torch.where(lo, xp, zero), torch.where(lo, zero, xp)], -1)


def _three(x, p, s_hi):
    """Three-piece body with outer slope p4 below and ``s_hi`` above."""
    p0, p1, p3, p4 = _p(p, 0), _p(p, 1), _p(p, 3), _p(p, 4)
    dx, _ = _knee_width(p)
    xb = p0 + dx
    lo = p4 * x - p0 * p4 + p1
    hi = s_hi * x - s_hi * p0 - s_hi * dx + p3 * dx + p1
    mid = p3 * x - p3 * p0 + p1
    return torch.where(x < p0, lo, torch.where(x > xb, hi, mid))


def _jac_three(x, p, free: bool):
    """Columns d/dp0..p4 (p5 too when ``free``), in the order JAX's
    forward mode forms each tangent."""
    p0, p3, p4 = _p(p, 0), _p(p, 3), _p(p, 4)
    s_hi = _p(p, 5) if free else p4
    dx, ddx = _knee_width(p)
    xb = p0 + dx
    below = x < p0
    above = ~below & (x > xb)
    xp = x - p0
    zero = torch.zeros_like(xp)
    one = torch.ones_like(xp)

    def pick(lo, hi, mid):
        return torch.where(below, lo, torch.where(above, hi, mid))

    cols = [pick(-p4, -s_hi, -p3).expand_as(xp), one,
            pick(zero, p3 * ddx - s_hi * ddx, zero),
            pick(zero, dx.expand_as(xp), xp)]
    if free:
        cols += [pick(xp, zero, zero), pick(zero, xp - dx, zero)]
    else:
        cols += [pick(xp, xp - dx, zero)]
    return torch.stack(cols, -1)


def lapse_piecewise_three(x, p):
    """Three-piece: knees at p0 and p0+p2 (p2 >= 10 m), middle slope p3,
    outer slope p4 (lapseRatePiecewise_three, furtherMathFunctions.cpp:134-147)."""
    return _three(x, p, _p(p, 4))


def lapse_piecewise_three_free(x, p):
    """Three-piece with free outer slopes p4 (below) and p5 (above)
    (lapseRatePiecewise_three_free, furtherMathFunctions.cpp:149-180)."""
    return _three(x, p, _p(p, 5))


def linear_intercept(x, p):
    """functionLinear_intercept (furtherMathFunctions.cpp:198-201)."""
    return _p(p, 0) * x + _p(p, 1)


lapse_piecewise_two.jacobian = _jac_two
lapse_piecewise_three.jacobian = lambda x, p: _jac_three(x, p, False)
lapse_piecewise_three_free.jacobian = lambda x, p: _jac_three(x, p, True)
linear_intercept.jacobian = lambda x, p: torch.stack(
    [x * torch.ones_like(_p(p, 0)), torch.ones_like(x * _p(p, 0))], -1)

ELEVATION_FUNCTIONS = {
    "double_piecewise": (lapse_piecewise_two, 4),
    "triple_piecewise": (lapse_piecewise_three, 5),
    "free_triple_piecewise": (lapse_piecewise_three_free, 6),
}


def _weighted_sse(func, params, x, y, w):
    r = func(x, params[..., None, :]) - y
    return torch.sum(w * r * r, dim=-1)


def levenberg_marquardt(func, p0, pmin, pmax, x, y, n_iter=60, w=None, *,
                        device=None):
    """Fixed-iteration Levenberg-Marquardt of ``func(x, params) ~ y`` for a
    batch of problems.

    ``p0``, ``pmin``, ``pmax``: ``(..., n)``; ``x, y, w``: ``(..., k)`` with
    the same leading shape (or one row for all). Invalid stations carry
    ``w == 0``. Parameters are clipped to [pmin, pmax] after every step —
    the box-constraint behaviour of the reference fitter. Returns
    ``(params, sse)``; tensors stay on their device, arrays go to
    ``device`` (the card when None).
    """
    dev = input_device(device, p0, x, y)
    p0 = as_f64(p0, dev)
    x = as_f64(x, dev)
    y = as_f64(y, dev)
    w = torch.ones_like(y) if w is None else as_f64(w, dev)
    pmin, pmax = as_f64(pmin, dev), as_f64(pmax, dev)
    lead = torch.broadcast_shapes(p0.shape[:-1], pmin.shape[:-1], x.shape[:-1])
    n, k = p0.shape[-1], x.shape[-1]
    p = torch.clamp(p0, pmin, pmax).expand(lead + (n,)).reshape(-1, n)
    pmin = pmin.expand(lead + (n,)).reshape(-1, n)
    pmax = pmax.expand(lead + (n,)).reshape(-1, n)
    x, y, w = (t.expand(lead + (k,)).reshape(-1, k) for t in (x, y, w))

    sqrt_w = torch.sqrt(w)
    eye = 1e-12 * torch.eye(n, dtype=p.dtype, device=dev)
    best_sse = _weighted_sse(func, p, x, y, w)
    lam = torch.full_like(best_sse, 1e-2)
    for _ in range(n_iter):
        r = sqrt_w * (func(x, p[:, None, :]) - y)
        J = sqrt_w[..., None] * func.jacobian(x, p[:, None, :])
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        A = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(JtJ, dim1=-2, dim2=-1)) + eye
        step = torch.linalg.solve_ex(A, -g)[0]
        p_new = torch.clamp(p + step, pmin, pmax)
        sse_new = _weighted_sse(func, p_new, x, y, w)
        improved = sse_new < best_sse
        p = torch.where(improved[:, None], p_new, p)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        best_sse = torch.minimum(best_sse, sse_new)
    return p.reshape(lead + (n,)), best_sse.reshape(lead)


def first_guess_grid(pmin, pmax, steps_per_param=None, *, device=None):
    """Grid of first-guess parameter combinations over the box [pmin, pmax]
    (calculateFirstGuessCombinations analogue), in ``itertools.product``
    order. Returns ``(..., n_starts, n_params)`` for bounds ``(..., n)``;
    each axis is ``jnp.linspace``'s (bit for bit, :func:`ops.linspace`)."""
    dev = input_device(device, pmin, pmax)
    pmin = as_f64(pmin, dev)
    pmax = as_f64(pmax, dev)
    n = pmin.shape[-1]
    if steps_per_param is None:
        steps_per_param = {4: 5, 5: 4, 6: 3}.get(n, 3)
    axes = linspace(pmin, pmax, steps_per_param)            # (..., n, steps)
    combos = torch.tensor(list(itertools.product(range(steps_per_param), repeat=n)),
                          device=dev)                       # (S, n)
    return torch.stack([axes[..., i, combos[:, i]] for i in range(n)], dim=-1)


def best_fitting_marquardt(func, pmin, pmax, x, y, w=None, *,
                           first_guesses=None, n_iter=60, device=None,
                           return_start: bool = False):
    """LM from every first-guess start in one batch; best SSE wins.

    Replaces bestFittingMarquardt_nDimension's sequential multi-start loop
    with one batched run. Bounds ``(..., n)``, points ``(..., k)`` with the
    same leading shape fit one problem per leading index; first guesses
    are ``(S, n)`` or ``(..., S, n)``. Returns ``(params, r2)``, and the
    index of the winning start when ``return_start`` (the first of equal
    SSEs, as ``jnp.argmin`` picks).
    """
    dev = input_device(device, x, y, pmin)
    x = as_f64(x, dev)
    y = as_f64(y, dev)
    w = torch.ones_like(y) if w is None else as_f64(w, dev)
    pmin = as_f64(pmin, dev)
    pmax = as_f64(pmax, dev)
    if first_guesses is None:
        first_guesses = first_guess_grid(pmin, pmax)
    g = as_f64(first_guesses, dev)
    # starts on a new axis just before the parameters / the points
    params_all, sse_all = levenberg_marquardt(
        func, g, pmin[..., None, :], pmax[..., None, :], x[..., None, :],
        y[..., None, :], n_iter, w[..., None, :], device=dev)
    best = torch.argmin(sse_all, dim=-1)
    params = torch.gather(params_all, -2,
                          best[..., None, None].expand(best.shape + (1, g.shape[-1])))[..., 0, :]
    sse = torch.gather(sse_all, -1, best[..., None])[..., 0]

    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-30)
    ybar = torch.sum(w * y, dim=-1) / wsum
    sstot = torch.clamp_min(torch.sum(w * sq(y - ybar[..., None]), dim=-1), 1e-30)
    r2 = 1.0 - sse / sstot
    return (params, r2, best) if return_start else (params, r2)


def weighted_multilinear(X, y, w, *, device=None):
    """Weighted least squares of ``y ~ X @ slopes + intercept``.

    Closed-form minimiser of the reference's summed linear_intercept objective
    for the non-elevation proxies. ``X``: (n_points, n_proxies). Returns
    ``(slopes, intercept)``.
    """
    dev = input_device(device, X, y, w)
    X = as_f64(X, dev)
    y = as_f64(y, dev)
    w = as_f64(w, dev)
    A = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=dev)], dim=1)
    Aw = A * w[:, None]
    M = A.T @ Aw + 1e-10 * torch.eye(A.shape[1], dtype=X.dtype, device=dev)
    b = Aw.T @ y
    sol = torch.linalg.solve_ex(M, b)[0]
    return sol[:-1], sol[-1]
