"""Heat sweeps per simulated hour: ``coupled.counts()["heat_sweeps"]`` over
the window."""
LAYER = "coupled period (solver/coupled.py counts)"
UNIT = "count/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_counter"


def read(run):
    return run.per_hour("heat_sweeps")
