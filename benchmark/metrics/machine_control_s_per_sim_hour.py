"""The graph machine's control: the launches' spans less their units (the
switch and while kernels and the conditional nodes) in the clocked hour
[s a simulated hour] (benchmark/unit_clock.py); None without the port's
unit clock."""
from benchmark import unit_clock

LAYER = "graph driver (solver/device_loop.py)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "machine control")
