"""The whole search's share of the card's f32 peak: the FLOPs of every
query answered in the window (its tower, then its products with every
document: ``counts.search_flops``) over the window's seconds and 67
TFLOP/s, the configuration's precision. The profiled part of the window
(its queries and seconds) is left out: the profiler slows the host."""

from benchmark.counts import H100_FLOPS, search_flops


def read(run):
    w = run.work
    if not w.get("queries") or not w.get("window_s"):
        return None
    summary = run.tracer.summary
    traced_s = summary.window_s if summary is not None else 0.0
    queries = w["queries"] - w.get("traced_queries", 0)
    flops = queries * search_flops(w["n_docs"], w["dim"], w["emb"], w["hid"])
    return 100.0 * flops / (w["window_s"] - traced_s) / H100_FLOPS["float32"]
