"""The program's own spans and counters over the traced window
(`diner_tpu_torch.utils.profiling`), for the readers of per-layer device
times: the port's take_report() is called once a run and its report kept
in the run's context. A program without that facility reports nothing."""


def report(ctx):
    """The port's report of the window, or None where it has none."""
    if "program_report" not in ctx:
        try:
            from diner_tpu_torch.utils.profiling import take_report
        except ImportError:
            take_report = None
        ctx["program_report"] = (take_report() if take_report is not None
                                 else None)
    return ctx["program_report"]


def stream_ms_per(ctx, span: str, counter: str):
    """The span's stream ms over the window (the device time from its entry
    marker to its exit marker, summed over its calls) per unit of the
    program's counter; None on a run without a device trace or where the
    program recorded neither."""
    rep = report(ctx)
    trace = ctx["trace"]
    if rep is None or trace is None or trace.busy_ns == 0:
        return None
    row = rep["spans"].get(span)
    n = rep["counters"].get(counter)
    if not row or not n or row["stream_ms"] is None:
        return None
    return row["stream_ms"] / n
