"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout. The run
builds its inputs and weights from ``--seed``, sets up and warms the cell's
shapes (``setup_s``, from process start to the first timed request or
step), drives the program for ``--seconds``, checks what the window
produced against the plain reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines of standard error. It exits non-zero, printing no result, where
there is no card or fewer than the cell needs, or where a module of JAX or
of the JAX package is loaded once the window has closed.

The kernels and the native tokenizer build into ``build/`` inside the
checkout at first use (``twotowers_tpu_torch/kernels/build.py``), so only
the first run of a cell in a checkout compiles.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    loaded = harness.loaded_jax_modules()
    if loaded:
        print(f"JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 3
    limit = harness.power_limit()
    run.note(f"card: {limit or torch.cuda.get_device_name(0)}")
    out = harness.result(run, {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                               "count": cell.chips,
                               "memory_peak_bytes": run.memory_peak_bytes})
    for name, (value, lim) in run.checks.items():
        print(f"check {name}: {value!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
