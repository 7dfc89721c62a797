"""Milliseconds a step in which the card was idle while the host ran the
program's own Python between torch calls: the idle gaps of the host-traced
steps that the harness names after one of the program's in-step spans
(the training step's layer boundaries, which the program opens as
``torch.profiler`` ranges), over those steps.  None where no gap bears a
program span's name: a program that opens no profiler ranges."""
NAME = "step_python_idle_ms"
UNIT = "ms"
LAYER = "training driver and dispatch"
SOURCE = "program_span"
RUN = "traced"
MOVES = "train_seeds_per_device_s"

SPANS = ("driver/step", "driver/seeds", "driver/train_step", "seeds/h2d",
         "step/sample", "step/fetch", "step/grad_mean", "step/update",
         "model/forward", "model/backward")
DRAW = "seeds/draw"


def read(run):
    if run.trace is None:
        return None
    labels = run.trace["idle_labels"]
    if not any(name in labels for name in SPANS + (DRAW,)):
        return None
    idle = sum(labels.get(name, 0.0) for name in SPANS)
    return 1e3 * idle / run.mix["label_steps"]
