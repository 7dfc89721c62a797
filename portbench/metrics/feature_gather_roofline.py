"""``feature_gather_kernel``'s least time on an H100
(``counts.feature_gather_bound``) over its device time in the traced
window, in percent."""
from portbench import counts, devtrace

NAME = "feature_gather_roofline"
UNIT = "%"
LAYER = "kernel feature_gather"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = devtrace.kernel_seconds(tr["dev"], ("feature_gather_kernel",),
                                tr["launches"]["feature_gather"])
    if t is None:
        return None
    D = run.model["in_dim"]
    return 100.0 * sum(counts.feature_gather_bound(s, D)
                       for s in run.trace_counts) / t
