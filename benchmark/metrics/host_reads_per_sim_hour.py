"""Host reads per simulated hour: ``device.host_read.count`` over the
window."""
LAYER = "graph driver (solver/device_loop.py)"
UNIT = "count/sim-h"
MOVES = "s_per_sim_hour"
SOURCE = "program_counter"


def read(run):
    return run.per_hour("host_reads")
