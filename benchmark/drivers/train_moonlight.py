"""The program's training loop on the ``deepseek_v3`` tower:
``train/loop.py:train_epoch`` with ``make_train_step``, epoch after epoch,
over pairs made in set-up.

As ``train_epoch.py`` drives the transformer cell, with what this tower
needs: the model is built first (a tree without the tower fails here, in
seconds), on the meta device and then filled from weights made on the card
from the seed (``leaves``); queries and passages keep their own widths
(``query_len`` and ``passage_len``), since the step encodes them apart;
the check's reference is ``reference/moonlight_train.py``, which computes
the batch ``reference_chunk`` texts at a time.

End-to-end: ``train_pairs_per_s`` (real pairs of finished steps over the
window), ``setup_s``. The traced run profiles one whole epoch (the second),
in which the program records its expert layer's device spans and counter
(``utils/tracing.py``); the per-layer metrics ``experts_roofline.moe`` and
``route_ms.moe`` read them.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from .. import counts_moonlight, textgen, weights
from ..reference import moonlight_train, precision, transformer_train
from .train_epoch import Pairs, first_steps, gen_seed

BIAS_SCALE = 0.05  # the selection bias: N(0, 0.05^2) a router output


def leaves(vocab: int, enc: Dict[str, Any]) -> List[weights.Leaf]:
    """The tree's leaves and their rules (JAX layout, tied towers): linears
    and stacked experts U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the table
    N(0, 1), norms 1, the router's selection bias N(0, ``BIAS_SCALE``^2)."""
    d, h = int(enc["hidden_dim"]), int(enc["num_heads"])
    nope, rope, v = (int(enc[k]) for k in ("qk_nope_head_dim", "qk_rope_head_dim",
                                            "v_head_dim"))
    rank, n_routed = int(enc["kv_lora_rank"]), int(enc["n_routed_experts"])
    held = int(enc["experts_held"][1])
    inner, dense_inner = int(enc["moe_intermediate_size"]), int(enc["intermediate_size"])
    shared = inner * int(enc["n_shared_experts"])

    def linear(path, fan_in, shape):
        return (path, shape, "uniform", fan_in ** -0.5)

    out = [(("embedding", "table"), (vocab, d), "normal", 1.0),
           (("query_tower", "final_norm"), (d,), "ones", 1.0)]
    for i in range(int(enc["num_layers"])):
        blk = ("query_tower", "layers", i)
        out += [(blk + ("attn_norm",), (d,), "ones", 1.0),
                (blk + ("mlp_norm",), (d,), "ones", 1.0),
                (blk + ("kv_a_norm",), (rank,), "ones", 1.0),
                linear(blk + ("q_w",), d, (d, h * (nope + rope))),
                linear(blk + ("kv_a_w",), d, (d, rank + rope)),
                linear(blk + ("kv_b_w",), rank, (rank, h * (nope + v))),
                linear(blk + ("o_w",), h * v, (h * v, d))]
        if i < int(enc["first_k_dense"]):
            out += [linear(blk + ("gate_up_w",), d, (d, 2 * dense_inner)),
                    linear(blk + ("down_w",), dense_inner, (dense_inner, d))]
        else:
            out += [linear(blk + ("router_w",), d, (d, n_routed)),
                    (blk + ("router_bias",), (n_routed,), "normal", BIAS_SCALE),
                    linear(blk + ("shared_gate_up_w",), d, (d, 2 * shared)),
                    linear(blk + ("shared_down_w",), shared, (shared, d)),
                    linear(blk + ("experts_gate_up_w",), d, (held, d, 2 * inner)),
                    linear(blk + ("experts_down_w",), inner, (held, inner, d))]
    return out


def make_pairs(rng, n: int, traffic) -> Pairs:
    zipf, vocab = float(traffic["zipf"]), int(traffic["vocab"])
    return Pairs(textgen.zipf_rows(rng, n, *traffic["query_tokens"], int(traffic["query_len"]),
                                   vocab, zipf),
                 textgen.zipf_rows(rng, n, *traffic["positive_tokens"],
                                   int(traffic["passage_len"]), vocab, zipf))


def build(run):
    """The model, train state, step and both datasets of ``run``'s cell."""
    import torch

    from twotowers_tpu_torch.convert import load_params
    from twotowers_tpu_torch.models.losses import build_loss
    from twotowers_tpu_torch.models.towers import TwoTower, spec_from_config
    from twotowers_tpu_torch.train.optim import build_optimizer
    from twotowers_tpu_torch.train.pipeline import Pipeline
    from twotowers_tpu_torch.train.step import create_train_state, make_train_step

    cfg = run.cell.config
    model_cfg, vocab = cfg["model"], int(cfg["vocab_size"])
    spec = spec_from_config(model_cfg, vocab)
    with torch.device("meta"):
        model = TwoTower(spec)
    model = model.to_empty(device=run.device)
    tree = weights.make(leaves(vocab, model_cfg["encoder"]), run.seed, run.device)
    load_params(model, weights.to_numpy(tree))
    loss_cfg = dict(model_cfg["loss"])
    loss_def = build_loss(loss_cfg.pop("type"), **loss_cfg)
    optimizer = build_optimizer(model_cfg)
    state = create_train_state(model, optimizer, seed=gen_seed(run.seed))
    batch = int(model_cfg["batch_size"])
    traffic = dict(run.cell.traffic, vocab=vocab)
    first = make_pairs(textgen.rng_for(run.seed, textgen.FIRST_PAIRS),
                       int(traffic["first_steps"]) * batch, traffic)
    rows = np.concatenate([first.queries, first.positives], axis=1)
    if len(np.unique(rows, axis=0)) != len(rows):
        raise RuntimeError("the first steps' pairs are not all different")
    main = make_pairs(textgen.rng_for(run.seed, textgen.PAIRS), int(traffic["pairs"]), traffic)

    def pipeline(dataset):
        return Pipeline(None, dataset, spec, model, optimizer, loss_def,
                        int(traffic["passage_len"]))

    return (spec, tree, model, state, make_train_step(loss_def, optimizer), batch,
            pipeline(first), pipeline(main))


def reference(run, tree, batches, config, precision_name: str = "f32") -> Dict[str, Any]:
    """The reference's first steps from ``tree`` on ``batches``, its
    products at ``precision_name``."""
    model_cfg = config["model"]
    precision.exact_matmuls()
    return moonlight_train.train_steps(
        tree, batches, arch=moonlight_train.arch_from_encoder(model_cfg["encoder"]), temperature=float(model_cfg["loss"]["temperature"]),
        lr=float(model_cfg["optimizer"]["lr"]),
        weight_decay=float(model_cfg["optimizer"]["weight_decay"]),
        cast=precision.caster(precision_name), chunk=int(run.cell.traffic["reference_chunk"]),
        tied=bool(model_cfg["encoder"]["tied_weights"]))


def run(run) -> None:
    import torch

    from twotowers_tpu_torch.kernels import gather, scatter_add
    from twotowers_tpu_torch.train.loop import train_epoch

    spec, tree, model, state, step, batch, first, main = build(run)
    run.mark("model, state, pairs")
    state, readings, batches = first_steps(run, state, step, model, first, batch)
    gathers, scatters = gather.LAUNCHES, scatter_add.LAUNCHES
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.mark("first steps")

    run.tracer.open_window()
    start = time.perf_counter()
    run.setup_s = start - run.t0
    epoch, steps, traced_steps, traced_s = 1, 0, 0, 0.0
    per_epoch = -(-len(main.dataset) // batch)
    # a traced run profiles its second epoch even where the first outlasts
    # the window (a slow host): the traced metrics read that epoch
    while time.perf_counter() - start < run.seconds or (run.trace and epoch <= 2):
        traced = run.trace and epoch == 2
        t = time.perf_counter()
        if traced:
            run.tracer.start()
        state, _ = train_epoch(step, state, main, batch, epoch=epoch, seed=run.seed)
        if traced:
            run.tracer.stop()
            traced_steps, traced_s = per_epoch, time.perf_counter() - t
        steps += per_epoch
        epoch += 1
    run.window_s = time.perf_counter() - start

    pairs = (epoch - 1) * len(main.dataset)
    run.attempted = steps
    run.e2e["setup_s"] = run.setup_s
    run.e2e["train_pairs_per_s"] = pairs / run.window_s
    traffic, enc = run.cell.traffic, run.cell.config["model"]["encoder"]
    run.work.update(
        steps=steps, traced_steps=traced_steps, traced_s=traced_s, window_s=run.window_s,
        step_flops=counts_moonlight.step_flops(enc, batch, int(traffic["query_len"]),
                                               int(traffic["passage_len"])))
    run.note(f"setup_s {run.setup_s!r}; window_s {run.window_s!r}; epochs {epoch - 1}; "
             f"steps {steps}; pairs {pairs}; train_pairs_per_s "
             f"{run.e2e['train_pairs_per_s']!r}; step_ms {run.window_s / steps * 1e3!r}")
    run.note(f"gather launches {gather.LAUNCHES - gathers}; scatter-add launches "
             f"{scatter_add.LAUNCHES - scatters} ({steps} steps)")
    run.note(f"first steps' losses {readings['losses']}")
    _note_experts(run)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    run.note(f"memory_peak_bytes {run.memory_peak_bytes}")
    del state, model, first, main
    from ..serving import free_device_memory
    free_device_memory()
    gaps = transformer_train.compare(readings, reference(run, tree, batches, run.cell.config))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        run.check(name, gaps[name])


def _note_experts(run) -> None:
    """The traced epoch's token-expert pairs on held experts, and the
    largest over the mean tokens a held expert took in a layer's call."""
    try:
        from twotowers_tpu_torch.utils import tracing
        by_expert = tracing.counter_values().get("moe.assignments")
        spans = tracing.device_spans()
    except (ImportError, AttributeError):
        return
    if by_expert is None:
        return
    calls = sum(1 for s in spans if s.name == "moe.experts" and s.attrs.get("phase") == "forward")
    summary = run.tracer.summary
    if summary is not None:
        rows = {name: (s, summary.kernel_n[name]) for name, s in summary.kernel_s.items()
                if any(k in name for k in ("gather_rows", "scatter_", "RadixSort"))}
        run.note(f"lookup kernels in the traced epoch (s, launches): {rows}")
    run.note(f"moe.assignments {float(by_expert.sum())!r} over {calls} expert-layer calls; "
             f"by held expert {by_expert.tolist()}, largest over mean "
             f"{float(by_expert.max() / by_expert.mean())!r}; device ms by span "
             f"{ {k: round(v, 3) for k, v in tracing.device_ms().items()} }")
