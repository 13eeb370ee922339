"""CG iterations per simulated hour: the period's stats over the window."""
LAYER = "period solver (solver/step.py stats)"
UNIT = "count/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_counter"


def read(run):
    return sum(h["stats"][3] for h in run.hours) / run.sim_hours
