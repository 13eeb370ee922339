"""A CG-line iteration's share of its roofline (benchmark/roofline/
cg_iteration.py), timed by CUDA events from the cell's first cg_start."""
from benchmark.roofline import cg_iteration

LAYER = "inner solve (solver/step.py cg_iteration, CG line)"
UNIT = "%"
MOVES = "s_per_sim_hour"
SOURCE = "device_trace"


def read(run):
    return run.roofline(cg_iteration)
