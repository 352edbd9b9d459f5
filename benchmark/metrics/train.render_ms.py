"""Stream ms of a training step's render of its rays: the sampler, the field
forward and K4: the program's span `renderer.rays` over the window, per
`train.steps` (one a step)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "renderer.rays", "train.steps")
