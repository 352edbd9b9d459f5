"""100 x (1 - the device's busy seconds over the traced window's): busy is
the union of the intervals of every kernel, copy and set on the device in
torch.profiler's trace, so that two streams at once count once."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.busy_ns == 0:
        return None
    return 100.0 * (1.0 - t.busy_ns / 1e9 / ctx["window_s"])
