"""Stream ms of a training step's backward and the gradients' all-reduce: the
program's span `train.backward` over the window, per `train.steps` (one a
step)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "train.backward", "train.steps")
