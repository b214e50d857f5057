"""Readings that set the limits of ``correct``: the control and the faults,
on the card at a cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--program-seeds ...]

Serving cells: the control is the plain reference computed with TF32
products (the nearest precision below the configuration's float32, TF32
off) put in the program's place: its top-k answers to as many of the
pool's queries as a run checks, judged against the f32 reference as a
run judges the program's. Training cell: the control is the reference with
fp8 (e4m3) products, judged as the program's first steps are; the faults
are the program's step fed half of each batch (the other half's weights
0, so the mean is over the rest) and a step that leaves the state
unchanged (its change is 0: ``change_gap`` reads 1). ``--program-seeds``
reads the program's first steps on more seeds in the same process
(training only; the serving cells' program readings come from their runs).

The benchmark's runs never run this; ``tests/test_benchmark_controls.py``
runs the same code at a size a test run holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def serve_control(run, precision_name: str = "tf32"):
    """``rank_gap`` / ``score_gap`` of the reference at ``precision_name``
    put in the program's place."""
    import numpy as np
    import torch

    from benchmark import serving, textgen
    from benchmark.reference import mean_search, precision

    s = serving.setup(run)
    precision.exact_matmuls()
    cast = precision.caster(precision_name)
    k = int(run.cell.traffic["top_k"])
    renormalize = run.cell.traffic["driver"] == "service_search"
    lut = mean_search.fit_vocab(s.fit.data).to(run.device)
    tower_d = "query_tower" if s.spec.tied_weights else "document_tower"
    docs = mean_search.encode_texts(mean_search.DeviceTexts(s.docs, run.device),
                                    torch.arange(len(s.docs), device=run.device), lut,
                                    s.tree, tower_d, serving.max_len(run), cast)
    n_check = int(run.cell.traffic["check_queries"])
    idx = np.sort(textgen.rng_for(run.seed, textgen.SAMPLE).choice(
        len(s.queries), size=min(n_check, len(s.queries)), replace=False))
    queries = mean_search.encode_texts(mean_search.DeviceTexts(s.queries, run.device),
                                       torch.from_numpy(idx).to(run.device), lut, s.tree,
                                       "query_tower", serving.max_len(run), cast)
    if renormalize:
        docs = mean_search.l2_normalize(docs, mean_search.STORE_EPS)
        queries = mean_search.l2_normalize(queries, mean_search.STORE_EPS)
    values, ids = mean_search.top_k(queries, cast(docs), k, cast)
    del docs, queries
    serving.free_device_memory()
    return serving.judge(run, s, idx, ids.cpu().numpy(), values.cpu().numpy(), renormalize)


def train_readings(run, fault: str = ""):
    """The program's first steps (with ``fault`` planted: ``half_batch``)
    judged against the f32 reference."""
    from benchmark.drivers import train_epoch
    from benchmark.reference import transformer_train

    spec, tree, model, state, step, batch, first, _ = train_epoch.build(run)
    if fault == "half_batch":
        inner = step

        def step(state, queries, positives, negatives, weights):  # noqa: F811
            half = weights.clone()
            half[len(half) // 2:] = 0.0
            return inner(state, queries, positives, negatives, half)
    state, readings, batches = train_epoch.first_steps(run, state, step, model, first, batch)
    del state, model, first
    return transformer_train.compare(
        readings, train_epoch.reference(run, tree, batches, run.cell.config))


def train_control(run, precision_name: str = "fp8"):
    """The reference at ``precision_name`` put in the program's place."""
    from benchmark.drivers import train_epoch
    from benchmark.reference import precision, transformer_train

    spec, tree, model, state, step, batch, first, _ = train_epoch.build(run)
    state, _, batches = train_epoch.first_steps(run, state, step, model, first, batch)
    del state, model, first
    cfg = run.cell.config["model"]
    precision.exact_matmuls()
    args = dict(heads=int(cfg["encoder"]["num_heads"]), rate=float(cfg["encoder"]["dropout"]),
                temperature=float(cfg["loss"]["temperature"]),
                lr=float(cfg["optimizer"]["lr"]), weight_decay=0.01,
                seed=train_epoch.gen_seed(run.seed),
                tied=bool(cfg["encoder"]["tied_weights"]))
    low = transformer_train.train_steps(tree, batches, cast=precision.caster(precision_name),
                                        **args)
    program = {"losses": low["losses"],
               "first_grad_norms": transformer_train.leaf_norms(low["first_grad"]),
               "change_norms": transformer_train.leaf_norms(low["change"])}
    return transformer_train.compare(program, train_epoch.reference(run, tree, batches,
                                                                    run.cell.config))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    training = cell.traffic["driver"] == "train_epoch"

    def emit(kind, seed, numbers, t):
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "seconds": time.perf_counter() - t, **numbers}), flush=True)

    for seed in args.program_seeds:
        t = time.perf_counter()
        emit("program", seed, train_readings(harness.Run(cell, seed, 0, False, device, t)), t)
    for seed in args.seeds:
        run = harness.Run(cell, seed, 0, False, device, time.perf_counter())
        t = time.perf_counter()
        if training:
            emit("control_fp8", seed, train_control(run), t)
            t = time.perf_counter()
            emit("fault_half_batch", seed, train_readings(run, "half_batch"), t)
        else:
            emit("control_tf32", seed, serve_control(run), t)
    print(json.dumps({"card": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
