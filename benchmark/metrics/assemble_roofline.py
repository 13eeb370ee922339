"""The water assembly's share of its roofline (benchmark/roofline/
assemble_fast.py), timed by CUDA events on the cell's storm state."""
from benchmark.roofline import assemble_fast

LAYER = "water assembly (solver/water.py assemble_fast)"
UNIT = "%"
MOVES = "s_per_sim_hour"
SOURCE = "device_trace"


def read(run):
    return run.roofline(assemble_fast)
