"""Median device ms a step of the expert layer's routing and row traffic:
the program's device spans ``moe.route`` (router, top-k, ordering by
expert), ``moe.dispatch`` and ``moe.combine`` (forward and backward), summed
over each ``train.step`` span of the traced epoch that they fall in. Both
are recorded by ``twotowers_tpu_torch/utils/tracing.py`` while the profiler
runs; a program without them gives no reading."""

from benchmark.measure import percentile

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    try:
        from twotowers_tpu_torch.utils import tracing
        device = [s for s in tracing.device_spans() if s.name in SPANS]
    except (ImportError, AttributeError):
        return None
    steps = sorted((s.start_ns, s.end_ns) for s in tracing.spans() if s.name == "train.step")
    per_step = [sum(d.ms for d in device if start <= d.start_ns <= end)
                for start, end in steps]
    per_step = [ms for ms in per_step if ms > 0]
    return percentile(per_step, 50) if per_step else None
