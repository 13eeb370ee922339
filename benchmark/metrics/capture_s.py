"""Seconds the graph driver spent capturing the period's machine
in the zero-length period of set-up (``device_loop.counts()
["capture_s"]``); not measured off the card, where nothing is captured."""
LAYER = "graph driver (solver/device_loop.py)"
UNIT = "s"
MOVES = "setup_s"
SOURCE = "program_span"


def read(run):
    return run.capture_s if run.on_card else None
