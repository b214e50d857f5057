"""Median host ms of the program's span ``train.step``: the ``train_step`` call
in ``train_epoch``: the step's dispatch. The span is recorded by
``twotowers_tpu_torch/utils/tracing.py`` while the profiler runs, so this
reads the traced part of the window; a program without the span gives no
reading."""

from benchmark.measure import percentile

SPAN = "train.step"


def read(run):
    try:
        from twotowers_tpu_torch.utils import tracing
    except ImportError:
        return None
    durations = [s.end_ns - s.start_ns for s in tracing.spans() if s.name == SPAN]
    return percentile(durations, 50) * 1e-6 if durations else None
