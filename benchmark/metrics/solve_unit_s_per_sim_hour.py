"""The inner solve's units (``solve_init``, ``solve``, ``solve_end``,
``x_exchange``): their seconds in the clocked hour [s a simulated hour]
(benchmark/unit_clock.py); None without the port's unit clock."""
from benchmark import unit_clock

LAYER = "inner solve (solver/step.py cg_iteration, CG line)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "inner solve")
