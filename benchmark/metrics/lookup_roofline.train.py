"""The lookup kernels' share of their roofline in the training step: the
least time of each traced step's gathers and scatter-adds from their shapes
(``counts.lookup_bound_s``: ids, table and rows each counted once) over the
device time of the gather, the scatter-add's two passes and its id sort in
the same trace."""

KERNELS = ("gather_rows_kernel", "scatter_chunks", "scatter_spans", "RadixSort")


def read(run):
    summary, steps = run.tracer.summary, run.work.get("traced_steps")
    if summary is None or not steps:
        return None
    device_s = summary.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * steps * run.work["lookup_bound_s"] / device_s
