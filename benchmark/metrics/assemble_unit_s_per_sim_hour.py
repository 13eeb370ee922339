"""The water assembly's units (``assemble``): their seconds in the clocked
hour [s a simulated hour] (benchmark/unit_clock.py); None without the
port's unit clock."""
from benchmark import unit_clock

LAYER = "water assembly (solver/water.py assemble_fast)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "water assembly")
