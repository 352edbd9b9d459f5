"""Stream ms of a training step's Adam update and schedule step: the program's
span `train.optimizer` over the window, per `train.steps` (one a step)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "train.optimizer", "train.steps")
