"""The pretrained embedding kinds (``word2vec``, ``glove``, ``pretrained``)
and ``configs/word2vec_skipgram.yml`` through the port, against the JAX
package.

* The table from a given vectors array is bit-equal to JAX's, with
  ``_pretrained_vectors`` patched in both packages (gensim is absent and
  nothing downloads).
* The fallback table takes its seed from ``hashlib``, so two processes with
  different ``PYTHONHASHSEED`` build the same one (the JAX package seeds
  from the salted ``hash()``; ROADMAP.md §3 records the deviation). JAX's
  fallback table is carried into the port with ``convert.py``.
* A frozen-table train step at vocab 640 (> 512, the word-scale lookup):
  loss, metrics and gradients within rtol 1e-5 / atol 1e-5 of the largest
  gradient (f32 summed in another order); params after 3 Adam steps within
  a hundredth of lr; the table bit-for-bit unchanged in both.
* The optimizer state (optax's zero moments for the frozen table, none in
  the torch optimizer) through ``convert.py`` and the checkpoint files,
  bit for bit.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import twotowers_tpu.models.embeddings as jax_emb
import twotowers_tpu_torch.models.embeddings as emb
from test_torch_loop import _word_tsv
from test_torch_train import VOCAB, _assert_trees_close, _batch, _np
from test_torch_train import jax_tpu_route  # noqa: F401 (a fixture)
from twotowers_tpu.models import init_two_tower
from twotowers_tpu.models.losses import build_loss as jax_build_loss
from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config
from twotowers_tpu.train import build_optimizer as jax_build_optimizer
from twotowers_tpu.train import build_pipeline as jax_build_pipeline
from twotowers_tpu.train import create_train_state as jax_create_train_state
from twotowers_tpu.train import make_train_step as jax_make_train_step
from twotowers_tpu.train import train_epoch as jax_train_epoch
from twotowers_tpu.train.step import _encode_for_loss as jax_encode_for_loss
from twotowers_tpu_torch.convert import (
    load_params, opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax)
from twotowers_tpu_torch.models import Embedding, EmbeddingSpec, build_loss, spec_from_config
from twotowers_tpu_torch.train import (
    build_optimizer, build_pipeline, create_train_state, latest_checkpoint, load_checkpoint,
    make_train_step, save_checkpoint, train_epoch, train_model)
from twotowers_tpu_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "word2vec_skipgram.yml")
EMB, HID = 32, 24  # vocab 640, batch 8, seq 12: test_torch_train's batches
LR = 5e-4  # the config's Adam rate


def _assert_trees_equal(got, want):
    _assert_trees_close(got, want, rtol=0, atol=0)


# ---- the table ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["word2vec", "glove", "pretrained"])
@pytest.mark.parametrize("rows,width", [
    (100, 20),    # fewer rows than V, narrower than D
    (100, 48),    # wider than D
    (900, 20),    # more rows than V
    (639, 32),    # exactly V - 1 rows, D wide
    (2000, 300),  # a word2vec-like array, cut on both axes
])
def test_table_from_vectors_is_jax_bit_for_bit(monkeypatch, np_rng, kind, rows, width):
    vectors = np_rng.normal(size=(rows, width)).astype(np.float32)
    sources = []
    for module in (jax_emb, emb):
        monkeypatch.setattr(module, "_pretrained_vectors",
                            lambda source: sources.append(source) or vectors)
    section = {"type": kind, "embedding_dim": EMB}
    jax_spec = jax_emb.spec_from_config(section, VOCAB)
    spec = emb.spec_from_config(section, VOCAB)
    assert spec.source == jax_spec.source and not spec.trainable
    want = np.asarray(jax_emb.init_embedding(jax.random.PRNGKey(0), jax_spec)["table"])
    module = Embedding(spec)
    module.reset_parameters(torch.Generator().manual_seed(0))
    got = module.table.detach().numpy()
    np.testing.assert_array_equal(got, want)
    assert sources == [spec.source] * 2
    assert not module.table.requires_grad and not got[0].any()
    n_copy, w = min(rows, VOCAB - 1), min(width, EMB)
    np.testing.assert_array_equal(got[1:1 + n_copy, :w], vectors[:n_copy, :w])
    assert not got[1 + n_copy:].any() and not got[:, w:].any()


def test_fallback_table_when_no_vectors(monkeypatch):
    spec = emb.spec_from_config({"type": "glove", "embedding_dim": 50}, 700)
    table = emb.pretrained_table(spec)  # gensim is absent: the fallback
    assert table.dtype == np.float32 and table.shape == (700, 50) and not table[0].any()
    np.testing.assert_allclose(table[1:].std(), 1 / np.sqrt(50), rtol=0.05)
    np.testing.assert_array_equal(emb.pretrained_table(spec), table)
    other = emb.spec_from_config({"type": "glove", "embedding_dim": 50,
                                  "source": "glove-twitter-25"}, 700)
    assert not np.array_equal(emb.pretrained_table(other), table)
    monkeypatch.setattr(emb, "_pretrained_vectors", lambda source: pytest.fail("called"))
    nameless = EmbeddingSpec(kind="word2vec", vocab_size=700, embedding_dim=50,
                             trainable=False, source=None)
    assert emb.pretrained_table(nameless).shape == (700, 50)


def test_unknown_kind_raises_as_jax_does():
    spec = EmbeddingSpec(kind="fasttext", vocab_size=10, embedding_dim=4)
    with pytest.raises(ValueError, match="Unknown embedding: 'fasttext'"):
        Embedding(spec)
    jax_spec = jax_emb.EmbeddingSpec(kind="fasttext", vocab_size=10, embedding_dim=4)
    with pytest.raises(ValueError, match="Unknown embedding: 'fasttext'"):
        jax_emb.init_embedding(jax.random.PRNGKey(0), jax_spec)


_PROBE = """
import hashlib, json, sys
sys.modules["gensim"] = None  # no vectors: both fallbacks
from twotowers_tpu_torch.index.glove import _hashed_vectors
from twotowers_tpu_torch.models.embeddings import pretrained_table, spec_from_config
spec = spec_from_config({"type": "pretrained", "embedding_dim": 300}, 900)
words = _hashed_vectors(25)
print(json.dumps({
    "salted": hash("hashed-vec"),
    "table": hashlib.sha256(pretrained_table(spec).tobytes()).hexdigest(),
    "words": [hashlib.sha256(words[w].tobytes()).hexdigest() for w in ("tpu", "gpu", "x")],
}))
"""


def test_fallbacks_are_the_same_in_every_process():
    """The seeds do not depend on PYTHONHASHSEED (JAX's do: ROADMAP.md §3)."""
    runs = []
    for hash_seed in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": hash_seed,
               "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        out = subprocess.run([sys.executable, "-c", _PROBE], env=env, capture_output=True,
                             text=True, timeout=240, check=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
    assert runs[0]["salted"] != runs[1]["salted"]  # the salt did change
    assert runs[0]["table"] == runs[1]["table"] and runs[0]["words"] == runs[1]["words"]
    spec = emb.spec_from_config({"type": "pretrained", "embedding_dim": 300}, 900)
    assert hashlib.sha256(emb.pretrained_table(spec).tobytes()).hexdigest() == runs[0]["table"]


# ---- the frozen-table step ------------------------------------------------------

def _specs():
    config = {"embedding": {"type": "pretrained", "embedding_dim": EMB, "trainable": False},
              "encoder": {"arch": "mean", "hidden_dim": HID, "tied_weights": True}}
    return jax_spec_from_config(config, VOCAB), spec_from_config(config, VOCAB)


def _named_grads(model):
    """(path in the JAX tree, the parameter's .grad in the JAX layout),
    zeros where there is no gradient."""
    from twotowers_tpu_torch.convert import _leaves

    for path, param, transposed in _leaves(model):
        grad = param.grad if param.grad is not None else torch.zeros_like(param)
        grad = grad.detach().numpy()
        yield path, grad.T if transposed else grad


def test_frozen_table_step_matches_jax(np_rng, jax_tpu_route):  # noqa: F811
    jax_spec, spec = _specs()
    assert not jax_spec.embedding.trainable and not spec.embedding.trainable
    params = init_two_tower(jax.random.PRNGKey(3), jax_spec)
    config = {"optimizer": {"type": "adam", "lr": LR}}
    jax_opt = jax_build_optimizer(config)
    jax_loss = jax_build_loss("triplet", margin=0.3)
    jax_step = jax_make_train_step(jax_spec, jax_loss, jax_opt)
    jax_state = jax_create_train_state(params, jax_opt)
    opt = build_optimizer(config)
    state = create_train_state(params_from_jax(_np(params), spec), opt)
    assert isinstance(state.optimizer, torch.optim.Adam)
    step = make_train_step(build_loss("triplet", margin=0.3), opt)
    table = state.model.embedding.table.detach().clone()

    batches = [_batch(np_rng) for _ in range(3)]
    q, p, n, w = map(jnp.asarray, batches[0])
    (_, _), jax_grads = jax.value_and_grad(
        lambda prm: jax_encode_for_loss(prm, jax_spec, jax_loss, q, p, n, w, train=True,
                                        dropout_rng=None), has_aux=True)(params)
    for i, batch in enumerate(batches):
        jax_state, want = jax_step(jax_state, *map(jnp.asarray, batch))
        state, got = step(state, *map(torch.from_numpy, batch))
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        if i == 0:
            grads = dict(_named_grads(state.model))
            scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jax_grads))
            for path, grad in grads.items():
                want_grad = np.asarray(jax_grads[path[0]][path[1]])
                np.testing.assert_allclose(grad, want_grad, rtol=1e-5, atol=1e-5 * scale,
                                           err_msg=str(path))
            assert state.model.embedding.table.grad is None
            assert not np.asarray(jax_grads["embedding"]["table"]).any()
    assert state.step == int(jax_state.step) == 3
    assert torch.equal(state.model.embedding.table, table)
    np.testing.assert_array_equal(np.asarray(jax_state.params["embedding"]["table"]),
                                  table.numpy())
    _assert_trees_close(params_to_jax(state.model), _np(jax_state.params), rtol=0,
                        atol=1e-2 * LR)
    back = opt_state_to_jax(state.model, state.optimizer)
    want = _np(jax_state.opt_state[0]._asdict())
    assert int(back["count"]) == int(want["count"]) == 3
    assert not want["mu"]["embedding"]["table"].any() and not back["mu"]["embedding"]["table"].any()
    _assert_trees_close(back["mu"], want["mu"], rtol=1e-5, atol=1e-8)
    _assert_trees_close(back["nu"], want["nu"], rtol=1e-4, atol=1e-10)


def test_optimizer_state_round_trips_through_convert_and_checkpoints(np_rng, tmp_path,
                                                                     jax_tpu_route):  # noqa: F811
    """Two JAX Adam steps with a frozen table; optax's state (zero table
    moments) into the torch optimizer (no entry for the table) and back,
    then through save_checkpoint / load_checkpoint, bit for bit."""
    jax_spec, spec = _specs()
    config = {"optimizer": {"type": "adam", "lr": LR}}
    jax_opt = jax_build_optimizer(config)
    jax_step = jax_make_train_step(jax_spec, jax_build_loss("triplet", margin=0.3), jax_opt)
    jax_state = jax_create_train_state(init_two_tower(jax.random.PRNGKey(4), jax_spec), jax_opt)
    for _ in range(2):
        jax_state, _ = jax_step(jax_state, *map(jnp.asarray, _batch(np_rng)))
    adam = _np(jax_state.opt_state[0]._asdict())

    state = create_train_state(params_from_jax(_np(jax_state.params), spec),
                               build_optimizer(config))
    opt_state_from_jax(adam, state.model, state.optimizer)
    assert state.model.embedding.table not in state.optimizer.state
    back = opt_state_to_jax(state.model, state.optimizer)
    assert int(back["count"]) == int(adam["count"]) == 2
    _assert_trees_equal(back["mu"], adam["mu"])
    _assert_trees_equal(back["nu"], adam["nu"])

    path = save_checkpoint({"params": params_to_jax(state.model), "opt_state": back},
                           str(tmp_path), tokenizer_state={}, config={}, epoch=1, step=2)
    tree, meta = load_checkpoint(path)
    fresh = create_train_state(params_from_jax(tree["params"], spec), build_optimizer(config))
    opt_state_from_jax(tree["opt_state"], fresh.model, fresh.optimizer)
    again = opt_state_to_jax(fresh.model, fresh.optimizer)
    assert int(again["count"]) == 2 and meta["step"] == 2
    _assert_trees_equal(again["mu"], adam["mu"])
    _assert_trees_equal(again["nu"], adam["nu"])
    _assert_trees_equal(params_to_jax(fresh.model), _np(jax_state.params))


# ---- configs/word2vec_skipgram.yml ----------------------------------------------

def word2vec_config(tmp_path, data, **over):
    """configs/word2vec_skipgram.yml with its data and paths under tmp_path,
    2 epochs at batch 16 (the widths as the file has them)."""
    config = load_config(CONFIG)
    config.update(data=data, checkpoint_dir=str(tmp_path / "ckpt"),
                  log_dir=str(tmp_path / "logs"), epochs=2, batch_size=16, **over)
    return config


def test_word2vec_config_epoch_matches_jax(tmp_path, np_rng, jax_tpu_route):  # noqa: F811
    data, _ = _word_tsv(tmp_path / "train.tsv", np_rng, n=80)
    config = word2vec_config(tmp_path, data)
    jax_pipe = jax_build_pipeline(config, seed=2)
    pipe = build_pipeline(config, seed=2, device="cpu")
    assert pipe.dataset.vocab_size == jax_pipe.dataset.vocab_size > 512
    assert pipe.spec.embedding.kind == "pretrained" and pipe.spec.embedding.embedding_dim == 300
    load_params(pipe.model, _np(jax_pipe.params))

    jax_step = jax_make_train_step(jax_pipe.spec, jax_pipe.loss_def, jax_pipe.optimizer)
    jax_state = jax_create_train_state(jax_pipe.params, jax_pipe.optimizer)
    jax_state, want = jax_train_epoch(jax_step, jax_state, jax_pipe, 16, epoch=1, seed=2)
    state = create_train_state(pipe.model, pipe.optimizer, seed=2)
    state, got = train_epoch(make_train_step(pipe.loss_def, pipe.optimizer), state, pipe, 16,
                             epoch=1, seed=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert state.step == int(jax_state.step) == 5
    _assert_trees_close(params_to_jax(state.model), _np(jax_state.params), rtol=0,
                        atol=1e-2 * LR)


def test_word2vec_config_trains_checkpoints_and_resumes(tmp_path, np_rng, monkeypatch):
    data, _ = _word_tsv(tmp_path / "train.tsv", np_rng, n=100)
    scatters = []
    monkeypatch.setattr(emb, "scatter_add_rows", lambda *a: scatters.append(a))
    config = word2vec_config(tmp_path, data)
    state, pipe = train_model(config, seed=1, device="cpu")
    table = emb.pretrained_table(pipe.spec.embedding)  # the fallback: gensim is absent
    assert torch.equal(state.model.embedding.table, torch.from_numpy(table))
    assert pipe.dataset.vocab_size > 512  # the word-scale lookup, GatherScatterGrad
    assert state.step == 2 * 7 and not scatters  # the frozen table has no backward
    with open(next((tmp_path / "logs").glob("*_metrics.jsonl"))) as f:
        epochs = [r["train/epoch_loss"] for r in map(json.loads, f) if "train/epoch_loss" in r]
    assert len(epochs) == 2 and all(np.isfinite(epochs))

    tree, meta = load_checkpoint(latest_checkpoint(str(tmp_path / "ckpt")))
    np.testing.assert_array_equal(tree["params"]["embedding"]["table"], table)
    assert not tree["opt_state"]["mu"]["embedding"]["table"].any()
    saved = opt_state_to_jax(state.model, state.optimizer)
    _assert_trees_equal(tree["opt_state"]["mu"], saved["mu"])
    assert int(tree["opt_state"]["count"]) == meta["step"] == 14

    again, _ = train_model({**config, "epochs": 3, "resume": "latest"}, seed=1, device="cpu")
    assert again.step == 14 + 7 and latest_checkpoint(str(tmp_path / "ckpt")).endswith("_epoch3")
    assert int(opt_state_to_jax(again.model, again.optimizer)["count"]) == 21
    assert torch.equal(again.model.embedding.table, torch.from_numpy(table))
