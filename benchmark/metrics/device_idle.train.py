"""Share of the traced window in which no device operation ran."""


def read(run):
    summary = run.tracer.summary
    if summary is None or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
