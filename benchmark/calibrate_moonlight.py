"""Readings that set the limits of ``correct`` in ``train-moonlight-b512``:
the program's own, the control and a fault, on the card at the cell's size.

    python3 benchmark/calibrate_moonlight.py --seeds 1 2 3 [--program-seeds ...]

For each of ``--seeds``: the program's first steps against the f32
reference (the reading a run makes); the control, the reference with its
products rounded to fp8 (e4m3; the nearest precision below the cell's
bf16) put in the program's place; and two faults judged as a run judges
the program: a routing fault, the program with 5 experts a token where the
model has 6, and the program's step fed half of each batch (the other
half's weights 0, so the mean is over the rest), as ``calibrate.py`` plants
it in the transformer cell.
``--program-seeds`` reads the program alone on more seeds. One JSON line
a reading. The benchmark's runs never run this;
``tests/test_benchmark_moonlight.py`` runs the same code at a size a test
run holds.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

NAME = "train-moonlight-b512"


def program_readings(run, fault: str = ""):
    """(tree, the program's first steps' readings, their batches) of a
    fresh build of ``run``'s cell, with ``fault`` planted (``half_batch``);
    the program's state is freed."""
    from benchmark.drivers import train_moonlight
    from benchmark.serving import free_device_memory

    spec, tree, model, state, step, batch, first, main = train_moonlight.build(run)
    if fault == "half_batch":
        inner = step

        def step(state, queries, positives, negatives, weights):  # noqa: F811
            half = weights.clone()
            half[len(half) // 2:] = 0.0
            return inner(state, queries, positives, negatives, half)
    state, readings, batches = train_moonlight.first_steps(run, state, step, model, first,
                                                          batch)
    del state, model, first, main, step
    free_device_memory()
    return tree, readings, batches


def control(run, tree, batches, want, precision_name: str = "fp8"):
    from benchmark.drivers import train_moonlight
    from benchmark.reference import transformer_train

    low = train_moonlight.reference(run, tree, batches, run.cell.config, precision_name)
    program = {"losses": low["losses"],
               "first_grad_norms": transformer_train.leaf_norms(low["first_grad"]),
               "change_norms": transformer_train.leaf_norms(low["change"])}
    return transformer_train.compare(program, want)


def with_top_k(cell, top_k: int):
    """The cell with the program's experts per token set to ``top_k``."""
    fault = copy.deepcopy(cell)
    fault.config["model"]["encoder"]["num_experts_per_tok"] = top_k
    return fault


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.drivers import train_moonlight
    from benchmark.reference import transformer_train

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(NAME)

    def emit(kind, seed, numbers, t):
        print(json.dumps({"workload": NAME, "kind": kind, "seed": seed,
                          "seconds": time.perf_counter() - t, **numbers}), flush=True)

    for seed in args.program_seeds + args.seeds:
        t = time.perf_counter()
        run = harness.Run(cell, seed, 0, False, device, t)
        tree, readings, batches = program_readings(run)
        want = train_moonlight.reference(run, tree, batches, cell.config)
        emit("program", seed, transformer_train.compare(readings, want), t)
        if seed not in args.seeds:
            continue
        t = time.perf_counter()
        emit("control_fp8", seed, control(run, tree, batches, want), t)
        t = time.perf_counter()
        top = int(cell.config["model"]["encoder"]["num_experts_per_tok"]) - 1
        fault = harness.Run(with_top_k(cell, top), seed, 0, False, device, t)
        _, readings, _ = program_readings(fault)
        emit(f"fault_top{top}", seed, transformer_train.compare(readings, want), t)
        t = time.perf_counter()
        _, readings, _ = program_readings(run, "half_batch")
        emit("fault_half_batch", seed, transformer_train.compare(readings, want), t)
    print(json.dumps({"card": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
