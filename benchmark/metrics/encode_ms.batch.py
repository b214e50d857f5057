"""Median host ms of encoding one batch's queries (tokenize, copy, tower,
synchronised), timed around ``TwoTowerSearch._encode_texts_device`` by
the driver in the traced run."""

from benchmark.measure import percentile


def read(run):
    spans = run.spans.get("encode")
    return percentile(spans, 50) * 1e3 if spans else None
