"""The plain reference agrees with the program at tiny sizes on the CPU,
and its pieces do what their names say."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import textgen, weights
from benchmark.reference import mean_search, precision, transformer_train
from benchmark.tests.tiny_cells import SEED, tiny_run


@pytest.mark.parametrize("name", ["serve-batch256-msmarco", "serve-c8-msmarco",
                                  "train-transformer-b4096"])
def test_program_is_correct_at_a_tiny_size(name):
    run = tiny_run(name)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert run.setup_s > 0 and run.window_s >= run.seconds
    assert all(v >= 0 for v in run.e2e.values())


def test_traced_run_reads_its_per_layer_metrics():
    from benchmark import harness

    run = tiny_run("serve-batch256-msmarco", seconds=1.0, trace=True)
    out = harness.result(run, {"platform": "cpu"})
    assert run.correct
    assert "encode_ms.batch" in out["metrics"] and "search_mfu" in out["metrics"]
    assert list(out)[-1] == "checks" and out["device"]["window_s"] > 0
    # no card: no device time, so no kernel share is reported
    assert "topk_roofline" not in out["metrics"]


def test_reference_encode_matches_the_programs_tower():
    from twotowers_tpu_torch.convert import params_from_jax
    from twotowers_tpu_torch.models.towers import spec_from_config
    from twotowers_tpu_torch.tokenizers.char import CharTokenizer

    texts = textgen.random_texts(300, 48, 160, SEED, textgen.DOCS)
    strings = texts.strings()
    tok = CharTokenizer(max_len=64).fit(strings[:100])
    spec = spec_from_config({"precision": "float32",
                             "embedding": {"type": "lookup", "embedding_dim": 64},
                             "encoder": {"arch": "mean", "hidden_dim": 128}}, tok.vocab_size)
    tree = weights.make(weights.mean_leaves(tok.vocab_size, 64, 128, False), SEED,
                        torch.device("cpu"))
    model = params_from_jax(weights.to_numpy(tree), spec).eval()
    with torch.no_grad():
        want = model.encode(torch.from_numpy(tok.encode_batch(strings, 64)), "document")
    lut = mean_search.fit_vocab(texts.head(100).data)
    got = mean_search.encode_texts(mean_search.DeviceTexts(texts, torch.device("cpu")),
                                   torch.arange(300), lut, tree, "document_tower", 64,
                                   precision.caster("f32"))
    assert torch.allclose(got, want, atol=2e-6, rtol=0)
    ids = mean_search.token_ids(*(torch.from_numpy(a) for a in (texts.data, texts.starts,
                                                                  texts.lengths)), lut, 64)
    assert np.array_equal(ids.numpy(), tok.encode_batch(strings, 64))


def test_judge_reads_zero_on_exact_answers_and_the_gap_of_a_swap():
    gen = torch.Generator().manual_seed(1)
    docs = mean_search.l2_normalize(torch.randn(500, 16, generator=gen))
    queries = mean_search.l2_normalize(torch.randn(8, 16, generator=gen))
    values, ids = mean_search.top_k(queries, docs, 5, precision.caster("f32"))
    assert mean_search.judge(queries, docs, ids, values) == {"rank_gap": 0.0, "score_gap": 0.0}
    swapped = ids.clone()
    swapped[0, [0, 4]] = swapped[0, [4, 0]]
    gaps = mean_search.judge(queries, docs, swapped, values)
    assert gaps["rank_gap"] == pytest.approx(float(values[0, 0] - values[0, 4]))


def test_rounding_to_tf32_and_fp8():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0])
    assert precision.round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,
                                                1.0 + 2.0 ** -9, -3.0]
    y = torch.tensor([448.0, 1.0, -0.3])
    r = precision.round_fp8(y)
    assert r[0] == 448.0 and r[1] == 1.0 and abs(float(r[2]) + 0.3) <= 0.3 * 2 ** -3
    z = torch.randn(64, generator=torch.Generator().manual_seed(0), requires_grad=True)
    precision.caster("fp8")(z).sum().backward()
    assert torch.equal(z.grad, torch.ones(64))


def test_leaf_norms_and_the_worst_leaf_gap():
    leaves = {("w",): torch.tensor([2.0, -1.0]), ("b",): torch.tensor([0.0])}
    norms = transformer_train.leaf_norms(leaves)
    assert norms[("w",)] == pytest.approx(5 ** 0.5) and norms[("b",)] == 0.0
    # against the larger of the leaf's own and the median leaf's reference norm
    want = {("a",): 2.0, ("b",): 1e-9, ("c",): 4.0}
    got = {("a",): 1.0, ("b",): 1.0, ("c",): 4.0}
    assert transformer_train.worst_leaf_gap(got, want, list(want)) == pytest.approx(0.5)
