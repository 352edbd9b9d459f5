"""Stream ms of a frame's latent fetch: the int8 quad-row gather and float32
blend, and the MVS depth lookup (K2), every chunk: the program's span
`field.gather` over the window, per `serve.requests` (one a frame)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "field.gather", "serve.requests")
