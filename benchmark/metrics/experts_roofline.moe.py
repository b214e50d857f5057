"""The held experts' products' share of their roofline in the traced
epoch: the least time of their matrix products
(``counts_moonlight.experts_bound_s``: 18 x A x D x I FLOPs at the bf16
peak, A the counter ``moe.assignments``, the token-expert pairs on held
experts) over the device ms of the program's ``moe.experts`` spans, forward
and backward. Both are recorded by ``twotowers_tpu_torch/utils/tracing.py``
while the profiler runs; a program without them gives no reading."""

from benchmark.counts_moonlight import experts_bound_s


def read(run):
    try:
        from twotowers_tpu_torch.utils import tracing
        device_ms, counters = tracing.device_ms(), tracing.counters()
    except (ImportError, AttributeError):
        return None
    ms, assignments = device_ms.get("moe.experts"), counters.get("moe.assignments")
    if not ms or not assignments:
        return None
    enc = run.cell.config["model"]["encoder"]
    bound_s = experts_bound_s(assignments, int(enc["hidden_dim"]),
                              int(enc["moe_intermediate_size"]))
    return 100.0 * bound_s / (ms * 1e-3)
