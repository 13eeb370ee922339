"""The clocked hour's wall less its launches' spans: the loads, the status
reads, the MBR read and the host's Python [s a simulated hour]
(benchmark/unit_clock.py); None without the port's unit clock."""
from benchmark import unit_clock

LAYER = "graph driver (solver/device_loop.py)"
UNIT = "s/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_span"


def read(run):
    return unit_clock.read(run, "between launches")
