"""The port's evaluation (metrics, ``evaluate_model``, the CLI) against the
JAX package's, and the transformer-tower config end to end on the CPU.

``evaluate_model`` runs in both packages on the same weights (JAX's, carried
into the port with ``convert.params_from_jax``), the same BPE tokenizer and
the same (query, documents, relevance) tuples from a numpy seed. The
metrics are exact functions of the ranking, and the rankings agree (the
encodings agree within 1e-5, far from any tie on these inputs), so the
results must be equal to float rounding (rel 1e-12).
"""

import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from twotowers_tpu.evaluation import evaluate_model as jax_evaluate_model
from twotowers_tpu.evaluation import metrics as jax_metrics
from twotowers_tpu.evaluation.cli import tuples_from_triplets as jax_tuples_from_triplets
from twotowers_tpu.models import (
    EmbeddingSpec as JaxEmbeddingSpec, TowerSpec as JaxTowerSpec,
    TwoTowerSpec as JaxTwoTowerSpec, init_two_tower)
from twotowers_tpu.tokenizers import BPETokenizer as JaxBPE
from twotowers_tpu_torch.convert import opt_state_to_jax, params_from_jax, params_to_jax
from twotowers_tpu_torch.evaluation import evaluate_model, metrics
from twotowers_tpu_torch.evaluation import cli
from twotowers_tpu_torch.evaluation.evaluate import _Encoder
from twotowers_tpu_torch.models import EmbeddingSpec, TowerSpec, TwoTowerSpec
from twotowers_tpu_torch.serve.app import ModelRuntime
from twotowers_tpu_torch.serve.service import RetrievalService
from twotowers_tpu_torch.tokenizers import BPETokenizer
from twotowers_tpu_torch.train import (
    build_optimizer, create_train_state, load_trained_model, save_checkpoint, train_model)
from twotowers_tpu_torch.utils import load_config

WORDS = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa", "theta", "zeta",
         "lambda", "mu", "nu", "xi", "rho", "tau", "phi"]


def _text(rng):
    return " ".join(rng.choice(WORDS, size=rng.integers(2, 9)))


def _tuples(rng, n=6, docs=7):
    out = []
    for _ in range(n):
        relevance = [int(x) for x in rng.random(docs) < 0.3]
        out.append((_text(rng), [_text(rng) for _ in range(docs)], relevance))
    out.append((_text(rng), [_text(rng)], [0]))  # nothing relevant, one document
    return out


# ---- metrics --------------------------------------------------------------------

@pytest.mark.parametrize("reference_compat", [False, True])
def test_metrics_match_jax(np_rng, reference_compat):
    for _ in range(60):
        rel = (np_rng.random(np_rng.integers(1, 25)) < 0.3).astype(int)
        total = int(rel.sum())
        assert metrics.mean_reciprocal_rank(rel) == jax_metrics.mean_reciprocal_rank(rel)
        for k in (1, 3, 5, 10, 30):
            assert metrics.precision_at_k(rel, k) == jax_metrics.precision_at_k(rel, k)
            assert metrics.recall_at_k(rel, k, total) == jax_metrics.recall_at_k(rel, k, total)
            assert metrics.ndcg_at_k(rel, k, reference_compat) == \
                jax_metrics.ndcg_at_k(rel, k, reference_compat)


def test_metric_edge_cases_match_jax():
    for rel in ([], [0, 0, 0], [1], [0, 1]):
        for k in (1, 2, 5):
            assert metrics.precision_at_k(rel, k) == jax_metrics.precision_at_k(rel, k)
            assert metrics.recall_at_k(rel, k, 0) == jax_metrics.recall_at_k(rel, k, 0) == 0.0
        if rel:
            assert metrics.ndcg_at_k(rel, 3) == jax_metrics.ndcg_at_k(rel, 3)
        assert metrics.mean_reciprocal_rank(rel) == jax_metrics.mean_reciprocal_rank(rel)
    assert metrics.mean_reciprocal_rank([0, 0, 1]) == pytest.approx(1 / 3)


# ---- evaluate_model -------------------------------------------------------------

def _models(arch, vocab, seed=0):
    def build(E, T, S, dtype):
        return S(embedding=E(kind="positional" if arch != "mean" else "lookup", vocab_size=vocab,
                             embedding_dim=16, max_len=12),
                 tower=T(arch=arch, embedding_dim=16, hidden_dim=32, dropout=0.1,
                         kernel_size=3, num_layers=2, num_heads=4, max_len=12),
                 tied_weights=False, compute_dtype=dtype)

    import jax.numpy as jnp

    jax_spec = build(JaxEmbeddingSpec, JaxTowerSpec, JaxTwoTowerSpec, jnp.float32)
    spec = build(EmbeddingSpec, TowerSpec, TwoTowerSpec, torch.float32)
    params = init_two_tower(jax.random.PRNGKey(seed), jax_spec)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), spec)
    return jax_spec, params, spec, model


@pytest.mark.parametrize("arch", ["mean", "cnn", "rnn", "transformer"])
def test_evaluate_model_matches_jax(np_rng, arch):
    tuples = _tuples(np_rng)
    corpus = [t[0] for t in tuples] + [d for t in tuples for d in t[1]]
    tok, jax_tok = BPETokenizer(num_merges=40).fit(corpus), JaxBPE(num_merges=40).fit(corpus)
    jax_spec, params, spec, model = _models(arch, tok.vocab_size)
    assert model.training  # evaluate_model must turn the dropout off
    kw = dict(batch_size=4, max_length=12)
    got = evaluate_model(model, spec, tuples, tok, **kw)
    want = jax_evaluate_model(params, jax_spec, tuples, jax_tok, **kw)
    assert set(got) == set(want) and len(got) == 10
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-12), key
    compat = evaluate_model(model, spec, tuples, tok, ndcg_reference_compat=True, **kw)
    want = jax_evaluate_model(params, jax_spec, tuples, jax_tok, ndcg_reference_compat=True,
                              **kw)
    assert compat == pytest.approx(want, rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError, match="not the model's"):
        evaluate_model(model, _models("mean", 7)[2], tuples, tok)


def test_encoder_runs_fixed_chunks_and_reads_back_once(np_rng, monkeypatch):
    _, _, spec, model = _models("transformer", 40)
    tok = BPETokenizer(num_merges=10).fit(WORDS)
    seen = []
    encode = model.encode
    monkeypatch.setattr(model, "encode",
                        lambda ids, tower: seen.append(tuple(ids.shape)) or encode(ids, tower))
    texts = [_text(np_rng) for _ in range(5)]
    out = _Encoder(model.eval(), tok, 12, 4)(texts, "document")
    assert seen == [(4, 12), (4, 12)]  # 5 texts in two padded chunks of 4
    assert out.shape == (5, 32) and out.dtype == np.float32
    with torch.no_grad():
        want = encode(torch.from_numpy(tok(texts, 12)), "document").numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


# ---- the CLI --------------------------------------------------------------------

def _checkpoint(tmp_path, rng):
    tuples = _tuples(rng)
    corpus = [t[0] for t in tuples] + [d for t in tuples for d in t[1]]
    tok = BPETokenizer(num_merges=40, max_len=12).fit(corpus)
    _, _, spec, model = _models("transformer", tok.vocab_size)
    config = {"tokeniser": {"type": "bpe", "max_len": 12, "num_merges": 40},
              "embedding": {"type": "positional", "embedding_dim": 16, "max_len": 12},
              "encoder": {"arch": "transformer", "hidden_dim": 32, "num_layers": 2,
                          "num_heads": 4, "max_len": 12, "dropout": 0.1}}
    state = create_train_state(model, build_optimizer({}))
    path = save_checkpoint({"params": params_to_jax(model),
                            "opt_state": opt_state_to_jax(model, state.optimizer)},
                           str(tmp_path / "ckpt"), tokenizer_state=tok.state_dict(),
                           config=config)
    return path, tuples, model, tok, spec


def test_cli_scores_a_checkpoint_on_the_cpu(tmp_path, np_rng, capsys):
    path, tuples, model, tok, spec = _checkpoint(tmp_path, np_rng)
    (tmp_path / "tuples.json").write_text(json.dumps(tuples))
    out = tmp_path / "metrics.json"
    assert cli.main(["--checkpoint", path, "--test_data", str(tmp_path / "tuples.json"),
                     "--device", "cpu", "--batch_size", "4", "--output", str(out)]) == 0
    want = evaluate_model(model, spec, tuples, tok, batch_size=4, max_length=12)
    assert json.loads(out.read_text()) == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert "Mean Reciprocal Rank" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs a CUDA card"):  # the card by default
        cli.main(["--checkpoint", path, "--test_data", str(tmp_path / "tuples.json")])
    with pytest.raises(SystemExit):
        cli.main(["--checkpoint", path, "--device", "cpu"])


def test_tuples_from_triplets_matches_jax(tmp_path, np_rng):
    pd = pytest.importorskip("pandas")
    queries = [_text(np_rng) for _ in range(8)]
    rows = [(q, _text(np_rng), _text(np_rng)) for q in queries for _ in range(3)]
    pd.DataFrame(rows, columns=["query", "positive_doc", "negative_doc"]).to_parquet(
        tmp_path / "t.parquet")
    got = cli.tuples_from_triplets(str(tmp_path / "t.parquet"), num_queries=5, num_docs=6)
    want = jax_tuples_from_triplets(str(tmp_path / "t.parquet"), num_queries=5, num_docs=6)
    assert got == want and len(got) == 5


# ---- the slice as a whole, on the CPU -------------------------------------------

def test_transformer_config_trains_scores_and_serves_on_the_cpu(tmp_path, monkeypatch):
    """configs/transformer_tower.yml through load_config and train_model at
    a cut depth (300 synthetic triplets, 2 epochs of batch 256, the last
    batch padded), full width otherwise; the checkpoint reloads, scores
    held-out tuples and serves."""
    for name in [n for n in __import__("os").environ if n.startswith("TWOTOWER_")]:
        monkeypatch.delenv(name)
    positives = chip_smoke.word_triplets_tsv(tmp_path / "t.tsv", 300 + 10, seed=0)
    rows = [line.rstrip("\n").split("\t") for line in open(tmp_path / "t.tsv")]
    (tmp_path / "train.tsv").write_text("".join("\t".join(r) + "\n" for r in rows[:301]))
    config = {**load_config("transformer_tower.yml"), "data": str(tmp_path / "train.tsv"),
              "checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": str(tmp_path / "logs"),
              "epochs": 2}
    state, pipeline = train_model(config, device="cpu")
    assert state.step == 4 and pipeline.spec.tower.arch == "transformer"
    assert pipeline.spec.embedding.kind == "positional" and pipeline.tokenizer.merges
    assert pipeline.spec.compute_dtype == torch.bfloat16 and pipeline.max_length == 48
    logs = [json.loads(line) for line in next((tmp_path / "logs").glob("*.jsonl")).open()]
    epoch_loss = [r["train/epoch_loss"] for r in logs if "train/epoch_loss" in r]
    assert len(epoch_loss) == 2 and all(np.isfinite(epoch_loss))

    best = str(tmp_path / "ckpt" / "best_model")
    model, spec, tok, _ = load_trained_model(best, device="cpu")
    assert spec == pipeline.spec and tok.state_dict() == pipeline.tokenizer.state_dict()
    ids = torch.from_numpy(tok(positives[:6], 48))
    with torch.no_grad():
        assert torch.equal(model.encode(ids), state.model.eval().encode(ids))
    rng = np.random.default_rng(1)
    tuples = chip_smoke.eval_tuples([r[0] for r in rows[301:]], [r[1] for r in rows[301:]],
                                    [r[2] for r in rows[1:301]], rng)
    results = evaluate_model(model, spec, tuples, tok, max_length=48)
    assert len(results) == 10 and all(0.0 <= v <= 1.0 for v in results.values())

    service = RetrievalService(model=ModelRuntime(best, device="cpu"), device="cpu")
    service.add(positives[:40], ids=[f"p{i}" for i in range(40)])
    for i in (0, 17, 39):
        result = service.search(positives[i], top_k=3)["results"]
        first = [r["document"] for r in result if r["distance"] <= result[0]["distance"] + 1e-6]
        assert positives[i] in first
