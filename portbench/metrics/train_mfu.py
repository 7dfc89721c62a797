"""The model's GEMM operations in the measured window's steps (its model
file's ``gemm_flops``, ``models/<conv>.py``: for sage the forward on the
valid destination rows, weight gradients, input gradients past the first
layer) over the window's wall time and the H100's float32 peak outside
the tensor cores, in percent."""
from portbench import h100

NAME = "train_mfu"
UNIT = "%"
LAYER = "whole step"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    if run.window_counts is None:
        return None
    flops = sum(run.model_file.gemm_flops(run.model, s)["total"]
                for s in run.window_counts)
    return 100.0 * flops / run.window_s / h100.FP32_FLOP_PER_S
