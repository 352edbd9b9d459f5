"""Stream ms of a frame's field MLP: posenc and ResnetFC with its heads, every
chunk: the program's span `field.mlp` over the window, per `serve.requests`
(one a frame)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "field.mlp", "serve.requests")
