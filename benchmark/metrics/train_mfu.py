"""The training step's share of the card's bf16 peak: model FLOPs a step
(``counts.tf_flops`` at the cell's shapes) times the steps finished in the
window, over its seconds and 989 TFLOP/s. The profiled epoch (its steps and
seconds) is left out: the profiler slows the host."""

from benchmark.counts import H100_FLOPS


def read(run):
    w = run.work
    if not w.get("steps") or not w.get("window_s"):
        return None
    steps = w["steps"] - w.get("traced_steps", 0)
    seconds = w["window_s"] - w.get("traced_s", 0.0)
    return 100.0 * steps * w["step_flops"] / seconds / H100_FLOPS["bfloat16"]
