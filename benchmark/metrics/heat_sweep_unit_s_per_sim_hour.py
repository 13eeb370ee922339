"""The heat solve's units (``sweep``, ``h_exchange``): their seconds in the
clocked hour [s a simulated hour] (benchmark/unit_clock.py); None
without the port's unit clock."""
from benchmark import unit_clock

LAYER = "heat solve (solver/heat.py heat_sweep)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "heat solve")
