"""``fused_sample_kernel``'s least time on an H100 (its bytes and integer
operations, ``counts.fused_sample_bound``) over its device time in the
traced window, in percent."""
from portbench import counts, devtrace

NAME = "fused_sample_roofline"
UNIT = "%"
LAYER = "kernel fused_sample"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    t = devtrace.kernel_seconds(tr["dev"], ("fused_sample_kernel",),
                                tr["launches"]["fused_sample"])
    if t is None:
        return None
    return 100.0 * sum(counts.fused_sample_bound(s)
                       for s in run.trace_counts) / t
