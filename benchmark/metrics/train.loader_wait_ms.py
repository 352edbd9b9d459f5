"""Mean host-clock ms the training loop waited in next() on the
BatchLoader, a step: what the readers add to a step when they fall
behind."""


def read(ctx):
    spans = ctx["spans"].get("loader_next")
    return 1e3 * sum(spans) / len(spans) if spans else None
