"""Median milliseconds of the sampling stage alone (the prepare half without
the feature fetch), fenced, after the window (``stages.py``)."""
NAME = "sampling_stage_ms"
UNIT = "ms"
LAYER = "sampling"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    return None if run.stages is None else 1e3 * run.stages["sampling"]
