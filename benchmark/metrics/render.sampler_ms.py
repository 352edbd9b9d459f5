"""Stream ms of a frame's depth-guided sampler (anchors, the paired prior
gather, K1, top-k, the Gaussian refit), every chunk: the program's span
`sampler` over the window, per `serve.requests` (one a frame)."""

from metrics import program_spans


def read(ctx):
    return program_spans.stream_ms_per(ctx, "sampler", "serve.requests")
