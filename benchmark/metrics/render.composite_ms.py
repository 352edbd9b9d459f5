"""Stream ms of a frame's compositing (K4), every chunk: the program's span
`composite` over the window, per `serve.requests` (one a frame)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "composite", "serve.requests")
