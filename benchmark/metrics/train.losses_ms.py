"""Stream ms of a training step's losses after the render: MSE, VGG and
antibias: the program's span `train.losses` over the window, per
`train.steps` (one a step)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "train.losses", "train.steps")
