"""Wall seconds per simulated hour on the cell's cards: the window's wall
over the hours it completed."""
LAYER = None
UNIT = "s/sim-h"
MOVES = None
SOURCE = "host_clock"


def read(run):
    return run.window_s / len(run.hours)
