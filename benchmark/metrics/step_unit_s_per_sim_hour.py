"""The period solver's units (every unit of no other layer): their seconds
in the clocked hour [s a simulated hour] (benchmark/unit_clock.py); None
without the port's unit clock."""
from benchmark import unit_clock

LAYER = "period solver (solver/step.py stats)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "period solver")
