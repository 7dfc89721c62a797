"""Device operations (kernels, copies, fills) a step, from the profiler's
raw records of the traced window."""
NAME = "device_ops_per_step"
UNIT = "ops"
LAYER = "training driver and dispatch"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None or not tr["dev"]:
        return None
    return len(tr["dev"]) / tr["steps"]
