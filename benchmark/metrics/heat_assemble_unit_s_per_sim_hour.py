"""The heat assembly's units (``chunk``, ``rebuild``, ``substep``): their
seconds in the clocked hour [s a simulated hour]
(benchmark/unit_clock.py); None without the port's unit clock."""
from benchmark import unit_clock

LAYER = "heat assembly (solver/heat.py, coupled.py chunk / substep units)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "heat assembly")
