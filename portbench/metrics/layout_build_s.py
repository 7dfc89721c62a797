"""Seconds of ``Pipeline.build`` in set-up: the partition fed back from
the offline assignment, the relabelled layout, the placement's plan and
the move to the device (``core/partition.py`` ``build_layout``)."""
NAME = "layout_build_s"
UNIT = "s"
LAYER = "data and partition layout"
SOURCE = "host_clock"
RUN = "traced"
MOVES = "setup_s"


def read(run):
    return run.layout_build_s
