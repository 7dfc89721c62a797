"""Share of the traced window in which no operation ran on the device:
100 * (1 - union of the device ops' intervals / the window)."""
from portbench import devtrace

NAME = "device_idle_share"
UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None or not tr["dev"]:
        return None
    busy = sum(b - a for a, b in devtrace.busy_intervals(tr["dev"]))
    return 100.0 * (1.0 - busy / (tr["t1"] - tr["t0"]))
