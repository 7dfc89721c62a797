"""All-to-all rounds a step (sampling and feature), from the program's round
counter (``Pipeline.counter``) over the traced steps."""
NAME = "rounds_per_step"
UNIT = "rounds"
LAYER = "placement"
SOURCE = "program_counter"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    return None if run.trace is None else run.trace["rounds_per_step"]
