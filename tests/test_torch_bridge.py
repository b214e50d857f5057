"""``bridge/orbax_to_torch.py``: checkpoints the JAX package trained, served
and resumed by the port.

JAX trains one epoch on the CPU of ``configs/default_config.yml`` (its
widths as the file has them) and of ``configs/transformer_tower.yml`` at a
narrow width in f32, and of the default config under an uneven ``mesh:``
split on the 8 virtual CPU devices (its table padded, which JAX's own
loader refuses). The bridge converts each checkpoint directory; the port's
``load_trained_model`` then gives JAX's encodings (f32 rtol 1e-5 / atol
1e-6, the transformer 1e-5 / 1e-5) and JAX's search results (the same ids,
scores within 1e-5), and ``resume: latest`` continues at JAX's step and
Adam counts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from twotowers_tpu.index.two_tower import TwoTowerSearch as JaxTwoTowerSearch
from twotowers_tpu.models.towers import encode as jax_encode
from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config
from twotowers_tpu.tokenizers import tokenizer_from_state as jax_tokenizer_from_state
from twotowers_tpu.train import train_model as jax_train_model
from twotowers_tpu.train.checkpoint import load_trained_model as jax_load_trained_model
from twotowers_tpu_torch.convert import opt_state_from_jax, opt_state_to_jax
from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
from twotowers_tpu_torch.train import (
    build_optimizer, latest_checkpoint, load_checkpoint, load_trained_model, train_model)
from twotowers_tpu_torch.train.step import trainable_parameters
from twotowers_tpu_torch.utils import load_config

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "bridge"))
import orbax_to_torch as bridge  # noqa: E402

ROWS, BATCH = 48, 16  # 3 steps an epoch


def _tsv(path, rng, n=ROWS):
    """Triplets of short sentences over a small word list (chars and BPE
    merges both recur)."""
    words = ["tpu", "gpu", "kernel", "search", "vector", "query", "tower", "model",
             "index", "score", "batch", "train", "dense", "sparse", "token"]
    rows = []
    for _ in range(n):
        query = " ".join(rng.choice(words, size=rng.integers(3, 7)))
        positive = query + " " + rng.choice(words)
        negative = " ".join(rng.choice(words, size=rng.integers(3, 7)))
        rows.append((query, positive, negative))
    with open(path, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        f.writelines("\t".join(row) + "\n" for row in rows)
    return str(path), rows


def _default_config(tmp_path, data, **over):
    config = load_config(str(ROOT / "configs" / "default_config.yml"), apply_env=False)
    return {**config, "data": data, "checkpoint_dir": str(tmp_path / "jax_ckpt"),
            "log_dir": str(tmp_path / "jax_logs"), "batch_size": BATCH, "epochs": 1, **over}


def _transformer_config(tmp_path, data):
    """transformer_tower.yml at a narrow width, f32. Its loss section keeps
    only in_batch's own key: the inherited ``margin`` makes the JAX
    package's in_batch loss raise (ROADMAP.md §3)."""
    config = load_config(str(ROOT / "configs" / "transformer_tower.yml"), apply_env=False)
    return {**config, "data": data, "checkpoint_dir": str(tmp_path / "jax_ckpt"),
            "log_dir": str(tmp_path / "jax_logs"), "batch_size": BATCH, "epochs": 1,
            "precision": "float32", "loss": {"type": "in_batch", "temperature": 0.1},
            "tokeniser": {**config["tokeniser"], "max_len": 16, "num_merges": 60},
            "embedding": {**config["embedding"], "embedding_dim": 16, "max_len": 16},
            "encoder": {**config["encoder"], "hidden_dim": 16, "num_layers": 2,
                        "num_heads": 2, "max_len": 16}}


def _max_len(config):
    return int(config["tokeniser"]["max_len"])


def _jax_tree(path):
    """The orbax state as stored, restored without a template."""
    return ocp.StandardCheckpointer().restore(Path(path) / "state")


def _assert_serves_as_jax(dst, jax_params, jax_spec, jax_tok, config, texts, tol):
    model, spec, tok, _ = load_trained_model(str(dst), device="cpu")
    assert tok.state_dict() == jax_tok.state_dict()
    ids = jax_tok(texts, _max_len(config))
    for tower in ("query", "document"):
        want = np.asarray(jax_encode(jax_params, jax_spec, jnp.asarray(ids), tower))
        with torch.no_grad():
            got = model.encode(torch.from_numpy(np.asarray(ids)), tower).numpy()
        np.testing.assert_allclose(got, want, **tol, err_msg=tower)

    search = TwoTowerSearch(model, spec, tok, max_length=_max_len(config), device="cpu")
    jax_search = JaxTwoTowerSearch(jax_params, jax_spec, jax_tok, max_length=_max_len(config))
    docs = sorted(set(texts))
    search.index_documents(docs)
    jax_search.index_documents(docs)
    queries = docs[:6]
    got, want = search.search_batch(queries, top_k=5), jax_search.search_batch(queries, top_k=5)
    for g, w in zip(got, want):
        assert [d for d, _ in g] == [d for d, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], atol=1e-5)


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """JAX's epoch of the default config and the bridge's conversion of
    its whole checkpoint directory."""
    tmp_path = tmp_path_factory.mktemp("default")
    data, rows = _tsv(tmp_path / "train.tsv", np.random.default_rng(0))
    config = _default_config(tmp_path, data)
    state, pipeline = jax_train_model(config, seed=3)
    # the script on best_model, in a process of its own while the tests run
    script = subprocess.Popen(
        [sys.executable, str(ROOT / "bridge" / "orbax_to_torch.py"),
         str(Path(config["checkpoint_dir"]) / "best_model"), str(tmp_path / "cli_out")],
        env={**os.environ, "JAX_PLATFORMS": "cpu"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    written = bridge.convert(config["checkpoint_dir"], str(tmp_path / "port_ckpt"))
    yield tmp_path, config, rows, state, pipeline, written, script
    script.kill()
    script.communicate()


def test_default_config_checkpoint_serves_as_jax(default_run):
    tmp_path, config, rows, state, pipeline, written, _ = default_run
    assert sorted(Path(p).name for p in written) == sorted(
        p.name for p in Path(config["checkpoint_dir"]).iterdir())
    best = tmp_path / "port_ckpt" / "best_model"
    assert {p.name for p in best.iterdir()} == {"params.npz", "opt_state.npz", "meta.json"}
    assert (best / "meta.json").read_bytes() == (
        Path(config["checkpoint_dir"]) / "best_model" / "meta.json").read_bytes()
    params, spec, tok, _ = jax_load_trained_model(str(Path(config["checkpoint_dir"]) / "best_model"))
    texts = [text for row in rows[:12] for text in row]
    _assert_serves_as_jax(best, params, spec, tok, config, texts, dict(rtol=1e-5, atol=1e-6))


def test_optimizer_state_carries_over_bit_for_bit(default_run):
    _, config, _, state, _, written, _ = default_run
    adam = jax.tree_util.tree_map(np.asarray, state.opt_state[0]._asdict())
    (epoch1,) = [p for p in written if p.endswith("_epoch1")]
    tree, meta = load_checkpoint(epoch1)
    model, _, _, _ = load_trained_model(epoch1, device="cpu")
    optimizer = build_optimizer(config).build(trainable_parameters(model))
    opt_state_from_jax(tree["opt_state"], model, optimizer)
    back = opt_state_to_jax(model, optimizer)
    assert int(back["count"]) == int(adam["count"]) == int(state.step) == meta["step"] == 3
    for key in ("mu", "nu"):
        for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(back[key]),
                                          jax.tree_util.tree_leaves_with_path(adam[key])):
            np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))


def test_resume_latest_continues_at_jax_counts(default_run):
    tmp_path, config, _, state, _, _, _ = default_run
    port = {**config, "checkpoint_dir": str(tmp_path / "port_ckpt"),
            "log_dir": str(tmp_path / "port_logs"), "epochs": 2, "resume": "latest"}
    again, _ = train_model(port, seed=3, device="cpu")
    assert again.step == int(state.step) + 3  # epoch 2 only
    assert int(opt_state_to_jax(again.model, again.optimizer)["count"]) == int(state.step) + 3
    assert latest_checkpoint(port["checkpoint_dir"]).endswith("_epoch2")


def test_transformer_checkpoint_serves_as_jax(tmp_path):
    data, rows = _tsv(tmp_path / "train.tsv", np.random.default_rng(1))
    config = _transformer_config(tmp_path, data)
    state, pipeline = jax_train_model(config, seed=4)
    src = Path(config["checkpoint_dir"]) / "best_model"
    (dst,) = bridge.convert(str(src), str(tmp_path / "port_best"))
    params, spec, tok, _ = jax_load_trained_model(str(src))
    assert spec.tower.arch == "transformer" and len(params["query_tower"]["layers"]) == 2
    texts = [text for row in rows[:10] for text in row]
    _assert_serves_as_jax(dst, params, spec, tok, config, texts, dict(rtol=1e-5, atol=1e-5))
    tree, meta = load_checkpoint(dst)
    assert int(tree["opt_state"]["count"]) == meta["step"] == int(state.step) == 3


def test_uneven_mesh_checkpoint_cut_to_the_vocabulary(tmp_path):
    """JAX trains under mesh {data: 2, model: 3} on 6 of the 8 virtual
    devices; the vocabulary does not divide by 3, so the stored table is
    padded and JAX's own loader refuses it. The bridge cuts it back."""
    data, rows = _tsv(tmp_path / "train.tsv", np.random.default_rng(2))
    config = _default_config(tmp_path, data, mesh={"data": 2, "model": 3})
    state, pipeline = jax_train_model(config, seed=5)
    src = Path(config["checkpoint_dir"]) / "best_model"
    vocab = pipeline.tokenizer.vocab_size
    stored = _jax_tree(src)
    assert vocab % 3 and stored["params"]["embedding"]["table"].shape[0] == vocab + 3 - vocab % 3
    with pytest.raises(ValueError, match="not compatible with the stored shape"):
        jax_load_trained_model(str(src))

    (dst,) = bridge.convert(str(src), str(tmp_path / "port_best"))
    meta = json.loads((src / "meta.json").read_text())
    tok = jax_tokenizer_from_state(meta["tokenizer"])
    spec = jax_spec_from_config(meta["config"], vocab)
    params = jax.tree_util.tree_map(np.asarray, stored["params"])
    params["embedding"]["table"] = params["embedding"]["table"][:vocab]
    texts = [text for row in rows[:12] for text in row]
    _assert_serves_as_jax(dst, params, spec, tok, config, texts, dict(rtol=1e-5, atol=1e-6))
    tree, _ = load_checkpoint(dst)
    for key in ("mu", "nu"):
        want = np.asarray(stored["opt_state"][0][key]["embedding"]["table"])
        np.testing.assert_array_equal(tree["opt_state"][key]["embedding"]["table"],
                                      want[:vocab])
        assert not want[vocab:].any()  # the pad rows had no gradient


def test_port_loaders_name_the_bridge_for_an_orbax_directory(default_run):
    tmp_path, config, _, _, _, _, _ = default_run
    src = str(Path(config["checkpoint_dir"]) / "best_model")
    for load in (load_checkpoint, lambda p: load_trained_model(p, device="cpu")):
        with pytest.raises(FileNotFoundError, match="bridge/orbax_to_torch.py"):
            load(src)


def test_script_converts_from_the_command_line(default_run):
    """``python bridge/orbax_to_torch.py SRC DST`` writes what the function
    does (the epoch-1 directory that best_model mirrors)."""
    tmp_path, _, _, _, _, written, script = default_run
    stdout, stderr = script.communicate(timeout=300)
    assert script.returncode == 0, stderr[-4000:]
    assert stdout.split() == [str(tmp_path / "cli_out")]
    (epoch1,) = [p for p in written if p.endswith("_epoch1")]
    got, _ = load_checkpoint(str(tmp_path / "cli_out"))
    want, _ = load_checkpoint(epoch1)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_the_way_back_loads_in_the_jax_package(default_run, tmp_path):
    """The port's checkpoint (a resumed epoch of the bridged one) written as
    an orbax state: JAX's ``load_trained_model`` reads the same params, and
    its optimizer state carries the port's count and moments."""
    port_root = default_run[0] / "port_back"
    _, config, _, state, _, _, _ = default_run
    train_model({**config, "checkpoint_dir": str(port_root), "log_dir": str(tmp_path / "logs"),
                 "epochs": 1}, seed=5, device="cpu")
    src = port_root / "best_model"
    dst = bridge.to_orbax(str(src), str(tmp_path / "orbax"))
    params, spec, tok, _ = jax_load_trained_model(dst)
    tree, meta = load_checkpoint(str(src))
    for (path, got), (_, want) in zip(jax.tree_util.tree_leaves_with_path(params),
                                      jax.tree_util.tree_leaves_with_path(tree["params"])):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=jax.tree_util.keystr(path))
    restored = _jax_tree(dst)["opt_state"][0]
    assert int(restored["count"]) == int(tree["opt_state"]["count"]) == meta["step"] == 3
    np.testing.assert_array_equal(restored["mu"]["embedding"]["table"],
                                  tree["opt_state"]["mu"]["embedding"]["table"])
    # and back again: the bridge gives the port's files
    (again,) = bridge.convert(dst, str(tmp_path / "again"))
    got, _ = load_checkpoint(again)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(tree)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
