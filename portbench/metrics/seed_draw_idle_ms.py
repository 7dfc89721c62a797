"""Milliseconds a step in which the card was idle while the host was in the
step's own seed draw: the idle gaps of the host-traced steps that the
harness names after the program's ``seeds/draw`` span (a ``torch.profiler``
range the program opens around ``seeds_per_worker_host``), over those
steps.  0 where the draw left the card no idle gap (a draw staged ahead);
None where no gap bears a program span's name: a program that opens no
profiler ranges."""
NAME = "seed_draw_idle_ms"
UNIT = "ms"
LAYER = "seed draw"
SOURCE = "program_span"
RUN = "traced"
MOVES = "train_seeds_per_device_s"

DRAW = "seeds/draw"
SPANS = ("driver/step", "driver/seeds", "driver/train_step", "seeds/h2d",
         "step/sample", "step/fetch", "step/grad_mean", "step/update",
         "model/forward", "model/backward")


def read(run):
    if run.trace is None:
        return None
    labels = run.trace["idle_labels"]
    if not any(name in labels for name in SPANS + (DRAW,)):
        return None
    return 1e3 * labels.get(DRAW, 0.0) / run.mix["label_steps"]
