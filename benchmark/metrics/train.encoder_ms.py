"""Stream ms of a training step's encoder (ResNet34 over the source views, the
normals): the program's span `model.encode` over the window, per
`train.steps` (one a step)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "model.encode", "train.steps")
