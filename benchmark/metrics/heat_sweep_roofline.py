"""A heat sweep's share of its roofline (benchmark/roofline/heat_sweep.py),
timed by CUDA events on the cell's frozen heat system."""
from benchmark.roofline import heat_sweep

LAYER = "heat solve (solver/heat.py heat_sweep)"
UNIT = "%"
MOVES = "s_per_sim_hour"
SOURCE = "device_trace"


def read(run):
    return run.roofline(heat_sweep)
