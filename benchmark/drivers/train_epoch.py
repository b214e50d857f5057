"""The program's training loop: ``train/loop.py:train_epoch`` with
``make_train_step``, epoch after epoch, over pairs made in set-up.

Set-up: the model from the config at the seed's weights, its optimizer and
train state (dropout generator seeded with the seed); ``pairs`` pairs of
Zipf id rows; and the first steps: ``first_steps`` batches of other pairs,
all different, through the same ``train_epoch`` and step, whose losses,
first gradient (from AdamW's first moment after one step) and parameter
change the check compares. The same state then goes into the window.
Window: whole epochs of ``iterate_batches`` (reshuffled each epoch) and
``prefetch_to_device`` until ``--seconds`` have passed; an epoch ends when
its last metrics are read, so every step in it has finished.

End-to-end: ``train_pairs_per_s`` (real pairs of finished steps over the
window). The traced run profiles one whole epoch (the second).
"""

from __future__ import annotations

import time

import numpy as np

from .. import counts, textgen, weights
from ..reference import precision, transformer_train


class Pairs:
    """The dataset ``train_epoch`` reads: (queries, positives, no
    negatives)."""

    def __init__(self, queries: np.ndarray, positives: np.ndarray):
        self.queries, self.positives = queries, positives

    def arrays(self):
        return self.queries, self.positives, None

    def __len__(self) -> int:
        return len(self.queries)


def make_pairs(rng, n: int, traffic, seq: int, vocab: int) -> Pairs:
    zipf = float(traffic["zipf"])
    return Pairs(textgen.zipf_rows(rng, n, *traffic["query_tokens"], seq, vocab, zipf),
                 textgen.zipf_rows(rng, n, *traffic["positive_tokens"], seq, vocab, zipf))


class FirstSteps:
    """Wraps the step for the first steps: keeps each batch it is fed and
    each step's loss, and the first gradient's norms by leaf after step 1."""

    def __init__(self, step, model):
        self.step, self.model = step, model
        self.batches, self.losses, self.first_grad_norms = [], [], None

    def __call__(self, state, queries, positives, negatives, weights_):
        from twotowers_tpu_torch.convert import opt_state_to_jax

        self.batches.append((queries.clone(), positives.clone(), weights_.clone()))
        state, metrics = self.step(state, queries, positives, negatives, weights_)
        self.losses.append(metrics["loss"].clone())
        if self.first_grad_norms is None:
            mu = opt_state_to_jax(self.model, state.optimizer)["mu"]
            b1 = state.optimizer.param_groups[0]["betas"][0]
            self.first_grad_norms = {p: float(np.linalg.norm(v)) / (1.0 - b1)
                                     for p, v in transformer_train.leaves(mu)}
        return state, metrics


def gen_seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def build(run):
    """The model, train state, step and both datasets of ``run``'s cell."""
    from twotowers_tpu_torch.convert import params_from_jax
    from twotowers_tpu_torch.models.losses import build_loss
    from twotowers_tpu_torch.models.towers import spec_from_config
    from twotowers_tpu_torch.train.optim import build_optimizer
    from twotowers_tpu_torch.train.pipeline import Pipeline
    from twotowers_tpu_torch.train.step import create_train_state, make_train_step

    cfg, traffic = run.cell.config, run.cell.traffic
    model_cfg, vocab = cfg["model"], int(cfg["vocab_size"])
    spec = spec_from_config(model_cfg, vocab)
    seq = int(model_cfg["tokeniser"]["max_len"])
    tree = weights.make(weights.transformer_leaves(
        vocab, spec.embedding.embedding_dim, spec.tower.hidden_dim, spec.tower.num_layers,
        spec.tower.max_len, spec.tied_weights), run.seed, run.device)
    model = params_from_jax(weights.to_numpy(tree), spec).to(run.device)
    loss_cfg = dict(model_cfg["loss"])
    loss_def = build_loss(loss_cfg.pop("type"), **loss_cfg)
    optimizer = build_optimizer(model_cfg)
    state = create_train_state(model, optimizer, seed=gen_seed(run.seed))
    batch = int(model_cfg["batch_size"])
    first = make_pairs(textgen.rng_for(run.seed, textgen.FIRST_PAIRS),
                       int(traffic["first_steps"]) * batch, traffic, seq, vocab)
    rows = np.concatenate([first.queries, first.positives], axis=1)
    if len(np.unique(rows, axis=0)) != len(rows):
        raise RuntimeError("the first steps' pairs are not all different")
    main = make_pairs(textgen.rng_for(run.seed, textgen.PAIRS), int(traffic["pairs"]),
                      traffic, seq, vocab)

    def pipeline(dataset):
        return Pipeline(None, dataset, spec, model, optimizer, loss_def, seq)

    return (spec, tree, model, state, make_train_step(loss_def, optimizer), batch,
            pipeline(first), pipeline(main))


def first_steps(run, state, step, model, first, batch):
    """Drive the first steps through ``train_epoch``; the program's
    readings."""
    from twotowers_tpu_torch.convert import params_to_jax
    from twotowers_tpu_torch.train.loop import train_epoch

    start = {p: np.array(v) for p, v in transformer_train.leaves(params_to_jax(model))}
    recorder = FirstSteps(step, model)
    state, _ = train_epoch(recorder, state, first, batch, epoch=0, seed=run.seed)
    after = dict(transformer_train.leaves(params_to_jax(model)))
    readings = {"losses": [float(x) for x in recorder.losses],
                "first_grad_norms": recorder.first_grad_norms,
                "change_norms": {p: float(np.linalg.norm(after[p] - start[p])) for p in start}}
    return state, readings, recorder.batches


def reference(run, tree, batches, config):
    model_cfg = config["model"]
    precision.exact_matmuls()
    return transformer_train.train_steps(
        tree, batches, heads=int(model_cfg["encoder"]["num_heads"]),
        rate=float(model_cfg["encoder"]["dropout"]),
        temperature=float(model_cfg["loss"]["temperature"]),
        lr=float(model_cfg["optimizer"]["lr"]), weight_decay=0.01,
        seed=gen_seed(run.seed), cast=precision.caster("f32"),
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
    while time.perf_counter() - start < run.seconds:
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
    seq = int(run.cell.config["model"]["tokeniser"]["max_len"])
    run.work.update(
        steps=steps, traced_steps=traced_steps, traced_s=traced_s, window_s=run.window_s,
        step_flops=counts.tf_flops(batch, seq, spec.embedding.embedding_dim,
                                   spec.tower.hidden_dim, spec.tower.num_layers),
        lookup_bound_s=counts.lookup_bound_s(
            2, batch * seq, spec.embedding.vocab_size, spec.embedding.embedding_dim,
            "float32", str(spec.compute_dtype).replace("torch.", "")))
    run.note(f"setup_s {run.setup_s!r}; window_s {run.window_s!r}; epochs {epoch - 1}; "
             f"steps {steps}; pairs {pairs}; train_pairs_per_s "
             f"{run.e2e['train_pairs_per_s']!r}; step_ms {run.window_s / steps * 1e3!r}")
    run.note(f"gather launches {gather.LAUNCHES - gathers}; scatter-add launches "
             f"{scatter_add.LAUNCHES - scatters} ({steps} steps)")
    run.note(f"first steps' losses {readings['losses']}")
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    del state, model, first, main
    from ..serving import free_device_memory
    free_device_memory()
    gaps = transformer_train.compare(readings, reference(run, tree, batches, run.cell.config))
    for name in ("loss_gap", "grad_gap", "change_gap"):
        run.check(name, gaps[name])
