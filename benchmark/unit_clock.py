"""One more hour of the cell with the port's unit clock on, and its wall
split by layer: the seconds of the units of each layer of the state
machine, the machine's control (the launches' spans less their units) and
the time between the launches (the wall less the launches' spans: the
loads, the status reads, the MBR read and the host's Python), which add
up to the hour's wall.

The clock is the port's ``solver/device_loop.unit_clock()``: on the card
the graph machine's own kernels read the card's timer around every unit
and launch; off the card the eager driver times its units on the host.
The hour runs unprofiled, once a run (kept on the ``Run``). A port without
the clock gives no split: every reader then returns None.
"""

from __future__ import annotations

from benchmark.harness import log

# the port's layers of the machine's units (device_loop.LAYERS)
GROUPS = ("water assembly", "inner solve", "heat solve", "heat assembly", "period solver")


def split(run) -> dict | None:
    """The clocked hour's split [s a simulated hour]: each of
    :data:`GROUPS`, ``"machine control"`` and ``"between launches"``,
    with ``wall_s`` the hour's wall [s] and ``sim_hours`` the simulated
    hours it covers; None where the port has no unit clock."""
    if not hasattr(run, "unit_clock_split"):
        run.unit_clock_split = _measure(run)
    return run.unit_clock_split


def _measure(run) -> dict | None:
    from criteria3d_tpu_torch.solver import device_loop
    if not hasattr(device_loop, "unit_clock"):
        log("# unit clock: the port has none; nothing to read")
        return None
    system = run.system
    with device_loop.unit_clock() as clock:
        rec, out = system.hour()
    del out
    if not clock.periods:
        log("# unit clock: the hour ran no clocked period; nothing to read")
        return None
    layers = clock.layers()
    sim_hours = system.period_s / 3600.0
    wall = rec["wall_s"]
    parts = {g: layers.get(g, 0.0) for g in GROUPS}
    parts["machine control"] = clock.control_s
    parts["between launches"] = wall - clock.launch_s
    units = clock.units()
    p = clock.periods[-1]
    window = run.window_s / len(run.hours) if run.hours else None
    log(f"# unit clock: hour wall {wall} s ({p.driver} driver, {p.n_launches} launches, "
        f"{len(p.events)} unit events, {p.dropped} dropped); the window's "
        f"{window} s an hour; split [s] " + "; ".join(f"{k} {v}" for k, v in parts.items())
        + "; units (count, s) " + "; ".join(f"{k} {v}" for k, v in units.items() if v[0]))
    out = {k: v / sim_hours for k, v in parts.items()}
    out.update(wall_s=wall, sim_hours=sim_hours)
    return out


def read(run, part: str) -> float | None:
    """``part`` of :func:`split` [s a simulated hour], or None."""
    s = split(run)
    return None if s is None else s[part]
