"""``torch.cuda.max_memory_allocated`` over the window, reset at its start,
of the fullest card the cell runs on [GiB]; not measured off the card."""
LAYER = None
UNIT = "GiB"
MOVES = None
SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 2**30 if run.on_card else None
