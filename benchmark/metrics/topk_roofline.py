"""Kernel #1's share of its roofline: the least time of every score + top-k
call made while the profiler ran, from its shapes (``counts.topk_bound_s``),
over the device time of kernel #1's launches (pass 1 and pass 2, the
kernels named ``score_topk_*``) in the same trace."""

from benchmark.counts import topk_bound_s

KERNELS = ("score_topk_",)


def read(run):
    calls = run.calls.get("score_topk")
    summary = run.tracer.summary
    if not calls or summary is None:
        return None
    device_s = summary.device_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(topk_bound_s(*call) for call in calls) / device_s
