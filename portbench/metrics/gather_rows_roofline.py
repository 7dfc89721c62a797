"""``gather_rows_kernel``'s least time on an H100
(``counts.gather_rows_bound``: the cache hits' rows) over its device time
in the traced window, in percent."""
from portbench import counts, devtrace

NAME = "gather_rows_roofline"
UNIT = "%"
LAYER = "kernel gather_rows"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = devtrace.kernel_seconds(tr["dev"], ("gather_rows_kernel",),
                                tr["launches"].get("gather_rows", 0))
    if t is None:
        return None
    D = run.model["in_dim"]
    return 100.0 * sum(counts.gather_rows_bound(s, D)
                       for s in run.trace_counts) / t
