"""Set-up: process start to the window's start (import, the libraries
loaded or built, the DEM, grid and state, the capture, one warm hour)."""
LAYER = None
UNIT = "s"
MOVES = None
SOURCE = "host_clock"


def read(run):
    return run.setup_s
