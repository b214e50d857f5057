"""Median host ms of the program's span ``encode.tokenize``: the tokenizer's
``encode_batch`` of one call's queries and the id tensor's copy to the card,
inside ``search_batch``'s encode. The span is recorded by
``twotowers_tpu_torch/utils/tracing.py`` while the profiler runs, so this
reads the traced part of the window; a program without the span gives no
reading."""

from benchmark.measure import percentile

SPAN = "encode.tokenize"


def read(run):
    try:
        from twotowers_tpu_torch.utils import tracing
    except ImportError:
        return None
    durations = [s.end_ns - s.start_ns for s in tracing.spans() if s.name == SPAN]
    return percentile(durations, 50) * 1e-6 if durations else None
