"""Median milliseconds of the program's host seed draw for one step
(``Pipeline.seeds_host``, which ``SyncDriver`` calls before each step),
timed by the host clock around the call after the traced steps."""
import statistics

NAME = "seed_draw_ms"
UNIT = "ms"
LAYER = "seed draw"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    if run.trace is None:
        return None
    return 1e3 * statistics.median(run.trace["seed_draw_s"])
