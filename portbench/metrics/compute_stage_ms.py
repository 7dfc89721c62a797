"""Median milliseconds of the compute stage alone (the forward and backward
of every worker and the gradient mean, no update), fenced, after the
window (``stages.py``)."""
NAME = "compute_stage_ms"
UNIT = "ms"
LAYER = "model forward and backward"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    return None if run.stages is None else 1e3 * run.stages["compute"]
