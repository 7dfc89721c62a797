"""Labelled seed nodes in the optimizer steps completed inside the measured
window, over the card's busy time in it: the union of the intervals of the
device operations that a device-only trace of the window records.  It is
the card time a trained seed costs, whatever the host does between the
operations."""
from portbench import devtrace

NAME = "train_seeds_per_device_s"
UNIT = "seeds/s"
LAYER = "end to end"
SOURCE = "device_trace"
RUN = "untraced"
MOVES = "train_seeds_per_device_s"


def read(run):
    if not run.window_dev:
        return None
    return (run.window_steps * run.seeds_per_step
            / devtrace.busy_seconds(run.window_dev))
