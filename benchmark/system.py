"""The system under test: the port's water or coupled period on a cell's
catchment, built and run through the port's public functions.

Nothing here decides a metric: :class:`System` builds the grid and the
initial inputs from the DEM it is handed, captures the period's machine by
a zero-length period, runs one simulated hour from the same initial inputs
each time it is asked, and hands back the hour's counts and its outputs.

A configuration with a ``mesh`` (``{"cards": n}``, one block a card, laid
out by the port's ``make_mesh``) lays its catchment over the cards as a
user of the port does: the grid and the initial inputs are built whole on
the first card, cut over the mesh by the port's
``parallel.sharding.shard_pytree``, and the period runs with
``SolverParameters.mesh`` set, so the port's own ``device_loop.driver_for``
picks its rounds driver. Off the card (the tests) the mesh's blocks all lie
on the CPU, each block its own machine, and the rounds driver runs them as
threads.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel import sharding
from criteria3d_tpu_torch.solver import coupled as C
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver.step import compute_period_stats


def mesh_of(layout: dict, device: torch.device):
    """The mesh of a configuration's ``mesh`` entry (``{"cards": n}``): the
    first n cards, laid out as the port's ``make_mesh`` lays them, one block
    a card; on the CPU as many CPU blocks, each run by its own machine."""
    cards = int(layout["cards"])
    if device.type == "cuda":
        return sharding.make_mesh(cards)
    return sharding.make_mesh(cards, devices=[device] * cards, machines=range(cards))


class System:
    """The port on one cell: ``config`` (a configuration file's object),
    ``traffic`` (a traffic file's), ``dem`` the DEM, ``device`` the device
    (``cuda:0`` on the card; the mesh's first card where the configuration
    has a ``mesh``). ``devices``: every device the period runs on."""

    def __init__(self, config: dict, traffic: dict, dem, device: torch.device):
        self.device = device
        heat = config.get("heat")
        self.coupled = bool(heat)
        self.period_s = float(traffic["period_s"])
        self.mesh = mesh_of(config["mesh"], device) if config.get("mesh") else None
        if config["preset"] != "fast_f32":
            raise ValueError(f"unknown preset {config['preset']!r}")
        self.params = SolverParameters.fast_f32(
            heat_vapor=bool(heat and heat["vapor"]),
            heat_frozen_props=bool(heat and heat["frozen_props"]))
        inputs = self._whole_inputs(config, traffic, dem, device)
        self.n_nodes = int(inputs[0].n_nodes)
        self.shape = tuple(inputs[0].mask.shape)
        if self.mesh is None:
            self.devices = [device]
        else:
            self.devices = list(dict.fromkeys(self.mesh.devices.flat))
            self.params = dataclasses.replace(self.params, mesh=self.mesh)
            # the whole tensors go with the tuple they are cut from
            inputs = tuple(sharding.shard_pytree(x, self.mesh) for x in inputs)
            self._empty_caches()
        self.inputs = inputs

    def _whole_inputs(self, config: dict, traffic: dict, dem, device) -> tuple:
        """The grid and the initial inputs, whole on ``device``: ``(grid,
        water)`` or, coupled, ``(grid, water, heat, boundary)``."""
        heat = config.get("heat")
        grid = problems.catchment_grid(
            dem, float(config["cell_m"]), device,
            total_depth=config["total_depth_m"], min_thickness=config["min_thickness_m"],
            max_thickness=config["max_thickness_m"],
            max_thickness_depth=config["max_thickness_depth_m"], soil=config["soil"])
        water = problems.storm_state(grid, self.params, psi0=float(traffic["psi0_m"]),
                                     rain=float(traffic["rain_m_per_h"]))
        if not self.coupled:
            return grid, water
        grid = problems.with_heat_surface(grid)
        heat_state, boundary = problems.initial_heat(
            grid, self.params, water, float(heat["t0_K"]),
            air_temperature=float(heat["air_temperature_K"]),
            rel_humidity=float(heat["rel_humidity_pct"]),
            wind_speed=float(heat["wind_speed_m_s"]),
            net_irradiance=float(heat["net_irradiance_W_m2"]))
        return grid, water, heat_state, boundary

    def _empty_caches(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()

    def sync(self) -> None:
        """Wait for every card the period runs on."""
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def capture(self) -> float:
        """A zero-length period, in which the graph driver builds and
        captures its machine; the capture seconds the driver counts."""
        device_loop.reset_counts()
        self._period(0.0)
        self.sync()
        return float(device_loop.counts()["capture_s"])

    def _period(self, seconds: float):
        if self.coupled:
            grid, water, heat_state, boundary = self.inputs
            return C.compute_period_coupled(grid, self.params, water, heat_state, boundary,
                                            seconds)
        grid, water = self.inputs
        return compute_period_stats(grid, self.params, water, seconds)

    def hour(self, seconds: float | None = None) -> tuple[dict, object]:
        """One simulated period (the traffic's, or ``seconds``) from the
        initial inputs, ended by synchronising the cards and reading the
        whole-period water MBR, as the port's bench ends an hour. Returns
        ``(record, output)``: the record holds the wall [s], the MBR, the
        host reads, the solver's counts and the driver's counts of this
        period alone."""
        host_read.count = 0
        device_loop.reset_counts()
        C.reset_counts()
        t0 = time.perf_counter()
        out = self._period(self.period_s if seconds is None else seconds)
        self.sync()
        water = out[0]
        mbr = float(water.balance_whole.mbr)
        wall = time.perf_counter() - t0
        drv = device_loop.counts()
        rec = dict(wall_s=wall, mbr=mbr, host_reads=host_read.count,
                   launches=drv["launches"])
        if self.mesh is not None:
            rec.update(rounds=drv["rounds"], rounds_enqueued=drv["rounds_enqueued"])
        if self.coupled:
            cnt = C.counts()
            rec.update(stats=[cnt["steps"], cnt["attempts"], cnt["approximations"],
                              cnt["inner_iterations"]],
                       chunks=cnt["chunks"], substeps=cnt["substeps_accepted"]
                       + cnt["substeps_rejected"], heat_sweeps=cnt["heat_sweeps"])
        else:
            rec["stats"] = list(out[1])
        return rec, (out if self.coupled else out[0])

    def outputs(self, out) -> dict:
        """What the comparison judges of an hour's output, on the CPU (the
        blocks of a mesh joined by the port's ``gather_pytree``): the heads,
        the saturation, the water storage the period reports, the
        whole-period water MBR and, coupled, the temperatures and the hour's
        boundary heat sink."""
        water, heat_state = (out if self.coupled else (out, None))
        cpu = torch.device("cpu")
        res = dict(h=sharding.gather_pytree(water.h, cpu).detach(),
                   se=sharding.gather_pytree(water.se, cpu).detach(),
                   storage=float(water.balance_current.storage),
                   mbr=float(water.balance_whole.mbr))
        if heat_state is not None:
            res.update(t=sharding.gather_pytree(heat_state.t, cpu).detach(),
                       heat_sink=float(heat_state.sink_whole))
        return res

    def free(self) -> None:
        """Drop the inputs and every kept machine, and hand every card's
        cached memory back."""
        self.inputs = None
        device_loop.clear()
        self._empty_caches()
