"""The port's training loop, pipeline and checkpoints against the JAX
package, and the loop end to end on the CPU.

The slice as a whole: JAX ``train_epoch`` and the port's run over the same
word-vocabulary TSV (vocab > 512, so the lookup's backward is the
scatter-add), from the same seed and weights carried with ``convert.py``.
The epoch loss agrees within rtol 1e-5 (f32 sums in another order), the
metric JSONL has the same keys, and the final params agree within a
hundredth of lr (Adam turns gradient elements near 0 into lr-sized steps).
"""

import json

import jax
import numpy as np
import pytest
import torch

from test_torch_train import jax_tpu_route  # noqa: F401 (a fixture)
from twotowers_tpu.train import MetricLogger as JaxMetricLogger
from twotowers_tpu.train import build_pipeline as jax_build_pipeline
from twotowers_tpu.train import create_train_state as jax_create_train_state
from twotowers_tpu.train import make_train_step as jax_make_train_step
from twotowers_tpu.train import train_epoch as jax_train_epoch
from twotowers_tpu_torch.convert import load_params, params_to_jax
from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
from twotowers_tpu_torch.train import (
    build_pipeline, create_train_state, latest_checkpoint, load_checkpoint,
    load_trained_model, make_train_step, save_checkpoint, train_epoch, train_model)
from twotowers_tpu_torch.train.metrics import MetricLogger

LR = 1e-3


def _word_tsv(path, rng, n=60, vocab=900):
    """Triplets over words w0..w{vocab-1}; the positive shares most of its
    query's words, the negative is drawn afresh."""
    rows = []
    for _ in range(n):
        query = [f"w{i}" for i in rng.integers(0, vocab, size=rng.integers(4, 12))]
        positive = query[:-1] + [f"w{rng.integers(0, vocab)}"]
        negative = [f"w{i}" for i in rng.integers(0, vocab, size=rng.integers(4, 12))]
        rows.append((" ".join(query), " ".join(positive), " ".join(negative)))
    with open(path, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for row in rows:
            f.write("\t".join(row) + "\n")
    return str(path), rows


def _config(tmp_path, data, **over):
    config = {
        "data": data,
        "tokeniser": {"type": "word", "max_len": 12, "max_vocab_size": 2000},
        "embedding": {"type": "lookup", "embedding_dim": 16},
        "encoder": {"arch": "mean", "hidden_dim": 32, "tied_weights": False},
        "loss": {"type": "triplet", "margin": 0.2},
        "optimizer": {"type": "adamw", "lr": LR},
        "batch_size": 16,
        "epochs": 2,
        "checkpoint_dir": str(tmp_path / "ckpt"),
        "log_dir": str(tmp_path / "logs"),
    }
    config.update(over)
    return config


def _jsonl_keys(path):
    with open(path) as f:
        return [sorted(k for k in json.loads(line) if k != "_time") for line in f]


def test_epoch_matches_jax(tmp_path, np_rng, jax_tpu_route):  # noqa: F811
    data, _ = _word_tsv(tmp_path / "train.tsv", np_rng)
    config = _config(tmp_path, data)
    jax_pipe = jax_build_pipeline(config, seed=3)
    pipe = build_pipeline(config, seed=3, device="cpu")
    assert pipe.dataset.vocab_size == jax_pipe.dataset.vocab_size > 512
    for a, b in zip(pipe.dataset.arrays(), jax_pipe.dataset.arrays()):
        np.testing.assert_array_equal(a, b)
    load_params(pipe.model, jax.tree_util.tree_map(np.asarray, jax_pipe.params))

    jax_step = jax_make_train_step(jax_pipe.spec, jax_pipe.loss_def, jax_pipe.optimizer)
    jax_state = jax_create_train_state(jax_pipe.params, jax_pipe.optimizer)
    with JaxMetricLogger(config, log_dir=str(tmp_path / "jax"), run_name="r") as log:
        jax_state, want = jax_train_epoch(jax_step, jax_state, jax_pipe, 16, epoch=1, seed=3,
                                          metric_logger=log)
    step = make_train_step(pipe.loss_def, pipe.optimizer)
    state = create_train_state(pipe.model, pipe.optimizer, seed=3)
    with MetricLogger(config, log_dir=str(tmp_path / "port"), run_name="r") as log:
        state, got = train_epoch(step, state, pipe, 16, epoch=1, seed=3, metric_logger=log)

    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the port drops the JAX package's unread avg_batch_time
    assert set(got) == set(want) - {"avg_batch_time"} and state.step == int(jax_state.step) == 4
    assert _jsonl_keys(tmp_path / "port" / "r_metrics.jsonl") == \
        _jsonl_keys(tmp_path / "jax" / "r_metrics.jsonl")
    got_params = params_to_jax(state.model)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got_params),
                                 jax.tree_util.tree_leaves_with_path(jax_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-2 * LR,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_model_checkpoints_resumes_and_serves(tmp_path, np_rng):
    data, rows = _word_tsv(tmp_path / "train.tsv", np_rng, n=100)
    config = _config(tmp_path, data, precision="bf16",
                     encoder={"arch": "mean", "hidden_dim": 32, "tied_weights": True},
                     optimizer={"type": "adamw", "lr": 1e-2})
    state, pipe = train_model(config, seed=1, device="cpu")
    assert state.step == 2 * 7 and pipe.spec.compute_dtype == torch.bfloat16
    with open(next((tmp_path / "logs").glob("*_metrics.jsonl"))) as f:
        epochs = [r for r in map(json.loads, f) if "train/epoch_loss" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert epochs[1]["train/epoch_loss"] < epochs[0]["train/epoch_loss"]

    ckpt = tmp_path / "ckpt"
    latest = latest_checkpoint(str(ckpt))
    assert latest.endswith("_epoch2") and (ckpt / "best_model" / "opt_state.npz").exists()
    tree, meta = load_checkpoint(latest)
    assert (meta["epoch"], meta["step"]) == (2, 14) and int(tree["opt_state"]["count"]) == 14

    again, _ = train_model(dict(config, epochs=3, resume="latest"), seed=1, device="cpu")
    assert again.step == 14 + 7  # epoch 3 only, the step count carried
    assert latest_checkpoint(str(ckpt)).endswith("_epoch3")  # a resumed run's first epoch saves

    model, spec, tokenizer, _ = load_trained_model(str(ckpt / "best_model"), device="cpu")
    search = TwoTowerSearch(model, spec, tokenizer, max_length=12, device="cpu")
    docs = [positive for _, positive, _ in rows]
    search.index_documents(docs)
    for text in docs[:5]:
        top = search.search(text, top_k=3)
        assert top[0][0] == text or top[0][1] == pytest.approx(top[1][1])


def test_train_model_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model({"data": str(tmp_path / "absent.tsv")})


def _tree(rng):
    return {"embedding": {"table": rng.normal(size=(5, 3)).astype(np.float32)},
            "query_tower": {"w1": rng.normal(size=(3, 2)).astype(np.float32)}}


def test_checkpoint_round_trip_and_best_mirror(tmp_path, np_rng):
    params, mu = _tree(np_rng), _tree(np_rng)
    opt = {"count": np.asarray(7, np.int32), "mu": mu, "nu": _tree(np_rng)}
    first = save_checkpoint({"params": params, "opt_state": opt}, str(tmp_path),
                            tokenizer_state={"type": "char"}, config={"a": 1}, epoch=1,
                            step=7, loss=0.5)
    tree, meta = load_checkpoint(first)
    np.testing.assert_array_equal(tree["params"]["embedding"]["table"],
                                  params["embedding"]["table"])
    np.testing.assert_array_equal(tree["opt_state"]["mu"]["query_tower"]["w1"],
                                  mu["query_tower"]["w1"])
    assert int(tree["opt_state"]["count"]) == 7
    assert (meta["epoch"], meta["step"], meta["loss"], meta["config"]) == (1, 7, 0.5, {"a": 1})
    best = load_checkpoint(str(tmp_path / "best_model"))[0]
    np.testing.assert_array_equal(best["params"]["embedding"]["table"],
                                  params["embedding"]["table"])
    # the same name again overwrites in place (mkdir exist_ok), and only
    # save_best moves the mirror
    again = save_checkpoint({"params": _tree(np_rng)}, str(tmp_path), epoch=2,
                            checkpoint_name="two_tower_x_epoch2", save_best=False)
    save_checkpoint({"params": _tree(np_rng)}, str(tmp_path), epoch=2,
                    checkpoint_name="two_tower_x_epoch2", save_best=False)
    assert load_checkpoint(again)[0]["opt_state"] is None
    np.testing.assert_array_equal(load_checkpoint(str(tmp_path / "best_model"))[0]["params"]
                                  ["embedding"]["table"], params["embedding"]["table"])


def test_latest_checkpoint_orders_by_timestamp_then_epoch(tmp_path, np_rng):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for name in ("two_tower_20260101_000000_epoch9", "two_tower_20260101_000000_epoch10",
                 "two_tower_20251231_235959_epoch12"):
        save_checkpoint({"params": _tree(np_rng)}, str(tmp_path), checkpoint_name=name)
    (tmp_path / "stray").mkdir()  # no meta.json: not a checkpoint
    assert latest_checkpoint(str(tmp_path)).endswith("20260101_000000_epoch10")
