"""The ``gat_attention`` forward and backward kernels' least time on an H100
over their device time in the traced window, summed, in percent.

The least bytes are counted here, from the traced steps' structure, and do
not depend on how the attention is computed.  Per level and worker, for a
layer of H heads of width C (``H * C`` floats a projected row): the
forward reads the projected row of each valid source once (the valid
destinations and every source their valid edges name, each once: a
destination an edge names is counted once), the edge ids (S x F int32) and
the two attention vectors, and writes the valid destinations' output; the
backward reads the upstream gradient of the valid destinations and the
same inputs, and writes the gradients of those rows and of the two
attention vectors.  A program without these kernels (no such launch count)
reads nothing."""
from portbench import devtrace, h100

NAME = "gat_attention_roofline"
UNIT = "%"
LAYER = "kernel gat_attention"
SOURCE = "device_trace"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def sources(step: dict, level: int, p: int) -> int:
    """Valid sources of worker ``p`` at ``level`` (top first): the
    sampler puts a level's valid destinations and the sources its valid
    edges name, each once, in its source list, which is the next level's
    destinations (below the bottom level: the frontier)."""
    levels = step["levels"]
    if level + 1 < len(levels):
        return levels[level + 1]["workers"][p]["dst"]
    return step["frontier"][p]


def attention_bytes(model: dict, step: dict) -> int:
    """Least bytes of one step's ``gat_attention`` launches, forward and
    backward, over every worker."""
    L, H = model["num_layers"], model["gat_heads"]
    total = 0
    for layer in range(L):
        C = (model["num_classes"] if layer == L - 1
             else model["hidden_dim"] // H)
        row = H * C * 4
        lvl = step["levels"][L - 1 - layer]
        for p, w in enumerate(lvl["workers"]):
            src = sources(step, L - 1 - layer, p)
            inputs = src * row + lvl["S"] * lvl["F"] * 4 + 2 * row
            forward = inputs + w["dst"] * row
            backward = w["dst"] * row + inputs + src * row + 2 * row
            total += forward + backward
    return total


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = tr["launches"]
    fwd = devtrace.kernel_seconds(tr["dev"], ("gat_attention_kernel",),
                                  launches.get("gat_attention", 0))
    bwd = devtrace.kernel_seconds(tr["dev"],
                                  ("gat_attention_backward_kernel",),
                                  launches.get("gat_attention_backward", 0))
    if fwd is None or bwd is None:
        return None
    nbytes = sum(attention_bytes(run.model, s) for s in run.trace_counts)
    return 100.0 * nbytes / h100.HBM_BYTES_PER_S / (fwd + bwd)
