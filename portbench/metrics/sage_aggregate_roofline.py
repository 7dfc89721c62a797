"""The ``sage_aggregate`` forward and backward gather kernels' least times
on an H100, summed (``counts.sage_aggregate_bounds``), over their device
times in the traced window, summed, in percent."""
from portbench import counts, devtrace

NAME = "sage_aggregate_roofline"
UNIT = "%"
LAYER = "kernel sage_aggregate"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    fwd = devtrace.kernel_seconds(
        tr["dev"], ("sage_aggregate_kernel", "sage_aggregate_wide_kernel"),
        tr["launches"]["sage_aggregate"])
    bwd = devtrace.kernel_seconds(
        tr["dev"], ("sage_aggregate_backward_kernel",),
        tr["launches"]["sage_aggregate_backward"])
    if fwd is None or bwd is None:
        return None
    bound = sum(sum(counts.sage_aggregate_bounds(run.model, s))
                for s in run.trace_counts)
    return 100.0 * bound / (fwd + bwd)
