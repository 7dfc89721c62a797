"""Median milliseconds of the feature stage alone (the fetch through the
feature store), fenced, after the window (``stages.py``)."""
NAME = "feature_stage_ms"
UNIT = "ms"
LAYER = "feature fetch"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    return None if run.stages is None else 1e3 * run.stages["feature"]
