"""Labelled seed nodes in the optimizer steps completed inside the measured
window, over the window's wall time (closed by a synchronize): the rate a
training job sees on the host's clock.  The host paces the step and its
speed swings from run to run, so the rate is read per layer; the card's
own rate is the end-to-end ``train_seeds_per_device_s``."""
NAME = "window_seeds_per_s"
UNIT = "seeds/s"
LAYER = "whole step"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "train_seeds_per_device_s"


def read(run):
    return run.window_steps * run.seeds_per_step / run.window_s
