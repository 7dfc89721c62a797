"""The ``sage_epilogue`` forward and backward kernels' least time on an
H100 over their device time in the traced window, summed, in percent.

The least bytes are counted here, from the traced steps' structure: each
hidden layer (every level but the top) runs its tail on each worker's
(S, H) destination rows, S the level's capacity.  The forward reads the
two products and, with dropout, the uniforms, and writes the output; the
backward reads the upstream gradient and the saved output and writes the
pre-activation gradient; and each launch reads the bias or writes its
gradient.  A program without these kernels (no such launch count) reads
nothing."""
from portbench import devtrace, h100

NAME = "sage_epilogue_roofline"
UNIT = "%"
LAYER = "kernel sage_epilogue"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def tail_bytes(model: dict, step: dict) -> int:
    """Least bytes of one step's ``sage_epilogue`` launches, forward and
    backward, over every worker."""
    H = model["hidden_dim"]
    arrays = (4 if model["dropout"] > 0 else 3) + 3
    total = 0
    for lvl in step["levels"][1:]:
        P = len(lvl["workers"])
        total += arrays * lvl["S"] * P * H * 4 + 2 * P * H * 4
    return total


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = tr["launches"]
    fwd = devtrace.kernel_seconds(tr["dev"], ("sage_epilogue_kernel",),
                                  launches.get("sage_epilogue", 0))
    bwd = devtrace.kernel_seconds(tr["dev"],
                                  ("sage_epilogue_backward_kernel",),
                                  launches.get("sage_epilogue_backward", 0))
    if fwd is None or bwd is None:
        return None
    nbytes = sum(tail_bytes(run.model, s) for s in run.trace_counts)
    return 100.0 * nbytes / h100.HBM_BYTES_PER_S / (fwd + bwd)
