"""Seconds from process start to the first timed step: imports, CUDA
context, the dataset (memory-mapped, or generated on a checkout's first
run), Pipeline.build, kernel loading and the warm-up steps.  The start of
the benchmark's own device trace of the window is left out: it is
instrumentation, and the traced run does not pay it there."""
NAME = "setup_s"
UNIT = "s"
LAYER = "end to end"
SOURCE = "host_clock"
RUN = "untraced"
MOVES = "setup_s"


def read(run):
    return run.setup_s
