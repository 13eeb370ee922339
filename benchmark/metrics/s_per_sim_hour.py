"""Wall seconds per simulated hour on the cell's cards: the window's wall
over the simulated hours its periods cover."""
LAYER = None
UNIT = "s/sim-h"
MOVES = None
SOURCE = "host_clock"


def read(run):
    return run.window_s / run.sim_hours
