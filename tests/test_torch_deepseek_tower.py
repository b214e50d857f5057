"""The ``deepseek_v3`` tower (``models/deepseek_tower.py``, ``models/moe.py``)
against the plain reference ``benchmark/reference/moonlight_train.py``.

The JAX package has no such tower, so the reference is the oracle: the
forward and every parameter's gradient through the ``in_batch`` loss in f32
on seeded weights, and in bf16 within a tolerance; the router's choice and
weights; the share test of expert parallelism (the partial outputs of the
shares of the experts, the shared experts counted once, add up to the uncut
layer); pad tokens; the spec; the checkpoint round trip with the selection
bias; a ``train_model`` epoch served by ``TwoTowerSearch``; and the expert
layer's device spans and counter, recorded only under the profiler. Small
shapes: hidden 64, 4 heads of 16 + 8 (v 16), kv rank 32, 16 experts of
width 24 with 4 held, top-3, 2 shared, 1 dense + 2 expert layers.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import moonlight_train as ref
from twotowers_tpu_torch.convert import _leaves, params_from_jax, params_to_jax
from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
from twotowers_tpu_torch.models import moe as moe_mod
from twotowers_tpu_torch.models.losses import build_loss
from twotowers_tpu_torch.models.towers import TwoTower, spec_from_config
from twotowers_tpu_torch.train import load_trained_model, train_model
from twotowers_tpu_torch.train.step import _encode_for_loss
from twotowers_tpu_torch.utils import tracing

VOCAB = 700
ENCODER = {"arch": "deepseek_v3", "hidden_dim": 64, "num_layers": 3, "first_k_dense": 1,
           "num_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
           "kv_lora_rank": 32, "intermediate_size": 96, "moe_intermediate_size": 24,
           "n_routed_experts": 16, "experts_held": [4, 4], "n_shared_experts": 2,
           "num_experts_per_tok": 3, "routed_scaling_factor": 2.446, "rope_theta": 50000.0,
           "rms_norm_eps": 1e-5, "tied_weights": True, "dropout": 0.0}
TEMPERATURE = 0.02
# bf16 against the f32 reference: the products' operands carry 8 bits
# (relative rounding 2**-9), so through 3 layers a unit vector's elements
# move by up to ~2e-3 (1.8e-3 read at these seeds), and the gradients,
# through a loss at temperature 0.02 that scales the vectors' errors by 50,
# by a few hundredths of their norm (2.3e-2 read); each bound leaves twice
# the reading or more
BF16_VECTOR_ATOL = 5e-3
BF16_GRAD_RTOL = 5e-2


def _config(encoder=None, precision="f32"):
    return {"embedding": {"type": "lookup", "embedding_dim": 64},
            "encoder": {**ENCODER, **(encoder or {})}, "precision": precision}


def _model(encoder=None, precision="f32", seed=1):
    spec = spec_from_config(_config(encoder, precision), VOCAB)
    model = TwoTower(spec, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for layer in model.query_tower.layers[spec.tower.first_k_dense:]:
        layer.mlp.router_bias.copy_(0.05 * torch.randn(spec.tower.n_routed_experts,
                                                       generator=gen))
    return model


def _tree(model):
    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_torch(v) for v in node]
        return torch.from_numpy(node)
    return to_torch(params_to_jax(model))


def _ids(batch=6, seq=12, seed=3):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, VOCAB, (batch, seq), generator=gen)
    lengths = torch.randint(2, seq + 1, (batch,), generator=gen)
    ids[torch.arange(seq)[None, :] >= lengths[:, None]] = 0
    return ids


def _arch(encoder=None):
    return ref.arch_from_encoder({**ENCODER, **(encoder or {})})


@pytest.mark.parametrize("held", [[0, 16], [4, 4], [12, 4]])
def test_forward_matches_the_reference_in_f32(held):
    model = _model({"experts_held": held})
    ids = _ids()
    got = model.encode(ids)
    want = ref.tower(_tree(model), ids, _arch({"experts_held": held}), lambda x: x)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


def _step_grads(model, queries, positives, weights):
    loss_def = build_loss("in_batch", temperature=TEMPERATURE)
    model.train()
    loss, _ = _encode_for_loss(model, loss_def, queries, positives, None, weights)
    loss.backward()
    grads = {}
    for path, p, transposed in _leaves(model):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        grads[path] = (g.T if transposed else g).detach().float()
    return float(loss.detach()), grads


def _reference_grads(model, queries, positives, weights, encoder=None, chunk=4):
    out = ref.train_steps(_tree(model), [(queries, positives, weights)],
                          arch=_arch(encoder), temperature=TEMPERATURE, lr=1e-5,
                          weight_decay=0.01, cast=lambda x: x, chunk=chunk)
    return out["losses"][0], out["first_grad"]


def _batch(seed=5):
    queries, positives = _ids(6, 8, seed), _ids(6, 14, seed + 1)
    weights = torch.tensor([1.0, 1, 1, 1, 1, 0])
    return queries, positives, weights


def test_every_gradient_matches_the_reference_in_f32():
    model = _model()
    queries, positives, weights = _batch()
    loss, grads = _step_grads(model, queries, positives, weights)
    want_loss, want = _reference_grads(model, queries, positives, weights)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert set(grads) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for path, g in want.items():
        torch.testing.assert_close(grads[path], g, rtol=0, atol=2e-5 * scale, msg=str(path))
    assert any(float(want[p].abs().max()) > 0 for p in want if p[-1] == "experts_down_w")
    assert all(float(g.abs().max()) == 0 for p, g in grads.items() if p[-1] == "router_bias")


def test_bf16_stays_near_the_f32_reference():
    model = _model(precision="bf16")
    ids = _ids()
    got = model.encode(ids).detach()
    assert got.dtype == torch.float32
    want = ref.tower(_tree(model), ids, _arch(), lambda x: x)
    assert float((got - want).abs().max()) < BF16_VECTOR_ATOL
    queries, positives, weights = _batch()
    _, grads = _step_grads(model, queries, positives, weights)
    _, want_grads = _reference_grads(model, queries, positives, weights)
    for path, g in want_grads.items():
        norm = float(g.norm())
        if norm > 0:
            assert float((grads[path] - g).norm()) <= BF16_GRAD_RTOL * norm, path


def test_the_router_picks_by_biased_scores_and_weighs_by_unbiased_ones():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(50, 64, generator=gen)
    weight = torch.randn(16, 64, generator=gen) * 0.1
    bias = torch.zeros(16)
    bias[7] = 10.0  # expert 7 is always picked, whatever its score
    chosen, weights = moe_mod.route(x, weight, bias, 3, 2.446)
    assert (chosen == 7).any(dim=-1).all()
    scores = torch.sigmoid(x @ weight.T)
    for t in range(50):
        biased = (scores[t] + bias).tolist()
        assert set(chosen[t].tolist()) == set(sorted(range(16), key=lambda e: -biased[e])[:3])
        picked = scores[t, chosen[t]]
        torch.testing.assert_close(weights[t], picked / picked.sum() * 2.446)
        assert float(weights[t].sum()) == pytest.approx(2.446, rel=1e-6)
    want_chosen, want_weights = ref.route(x, {"router_w": weight.T, "router_bias": bias},
                                          {"top_k": 3, "scaling": 2.446})
    assert torch.equal(chosen, want_chosen)
    torch.testing.assert_close(weights, want_weights, rtol=0, atol=0)


def test_the_shares_of_the_experts_add_up_to_the_uncut_layer():
    """Four holders of four experts each: their outputs, less the shared
    experts' that each adds, sum to the layer that holds all sixteen."""
    whole = _model({"experts_held": [0, 16]})
    layer = whole.query_tower.layers[1].mlp
    h = torch.randn(40, 64, generator=torch.Generator().manual_seed(9))
    shared = layer.shared(h)
    total = torch.zeros_like(h)
    for first in range(0, 16, 4):
        part = moe_mod.MoE(64, 24, 16, (first, 4), 2, 3, 2.446)
        part.load_state_dict({
            "router.weight": layer.router.weight, "router_bias": layer.router_bias,
            "shared.gate_up.weight": layer.shared.gate_up.weight,
            "shared.down.weight": layer.shared.down.weight,
            "experts_gate_up": layer.experts_gate_up[first:first + 4],
            "experts_down": layer.experts_down[first:first + 4]})
        total = total + part(h) - shared
    total = total + shared
    tree = _tree(whole)["query_tower"]["layers"][1]
    want = ref.moe(tree, h, _arch({"experts_held": [0, 16]}), lambda x: x, (0, 16))
    torch.testing.assert_close(total, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(layer(h), want, rtol=0, atol=1e-5)


def test_pad_tokens_do_not_move_real_ones_and_an_all_pad_row_is_zero():
    model = _model()
    ids = _ids(5, 10)
    ids[2] = 0
    wider = torch.cat([ids, torch.zeros(5, 6, dtype=ids.dtype)], dim=1)
    a, b = model.encode(ids), model.encode(wider)
    torch.testing.assert_close(a[[0, 1, 3, 4]], b[[0, 1, 3, 4]], rtol=0, atol=1e-5)
    assert float(a[2].abs().max()) == 0.0 and float(b[2].abs().max()) == 0.0
    a.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)


def test_spec_from_config_reads_every_key():
    spec = spec_from_config(_config(), VOCAB)
    t = spec.tower
    assert (t.arch, t.hidden_dim, t.num_layers, t.first_k_dense, t.num_heads) == \
        ("deepseek_v3", 64, 3, 1, 4)
    assert (t.qk_nope_head_dim, t.qk_rope_head_dim, t.v_head_dim, t.kv_lora_rank) == \
        (16, 8, 16, 32)
    assert (t.intermediate_size, t.moe_intermediate_size, t.n_routed_experts,
            t.experts_held, t.n_shared_experts, t.num_experts_per_tok) == \
        (96, 24, 16, (4, 4), 2, 3)
    assert (t.routed_scaling_factor, t.rope_theta, t.rms_norm_eps) == (2.446, 50000.0, 1e-5)
    assert spec.tied_weights and spec.embedding.kind == "lookup" and spec.output_dim == 64
    default = spec_from_config({"encoder": {"arch": "deepseek_v3"}}, VOCAB).tower
    assert (default.qk_rope_head_dim, default.n_routed_experts, default.experts_held,
            default.num_experts_per_tok) == (64, 64, None, 6)


def test_the_tower_refuses_a_held_range_outside_the_experts():
    with pytest.raises(ValueError, match="experts_held"):
        _model({"experts_held": [14, 4]})


def test_checkpoint_layout_round_trips_with_the_selection_bias():
    model = _model()
    tree = params_to_jax(model)
    layer = tree["query_tower"]["layers"][1]
    assert layer["experts_gate_up_w"].shape == (4, 64, 48)
    assert layer["experts_down_w"].shape == (4, 24, 64)
    assert layer["router_w"].shape == (64, 16) and layer["q_w"].shape == (64, 4 * 24)
    assert layer["router_bias"].shape == (16,) and np.abs(layer["router_bias"]).max() > 0
    assert "gate_up_w" in tree["query_tower"]["layers"][0]
    again = params_from_jax(tree, model.spec)
    for (path, a, _), (_, b, _) in zip(_leaves(model), _leaves(again)):
        assert torch.equal(a, b), path
    ids = _ids()
    assert torch.equal(again.encode(ids), model.encode(ids))


def _pairs_tsv(path, rng, n=40):
    words = [f"w{i}" for i in range(60)]
    with open(path, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for _ in range(n):
            q = list(rng.choice(words, size=rng.integers(3, 7)))
            p = q + list(rng.choice(words, size=rng.integers(2, 8)))
            f.write(f"{' '.join(q)}\t{' '.join(p)}\t{' '.join(rng.choice(words, 4))}\n")
    return str(path)


def test_train_model_saves_a_checkpoint_that_search_serves(tmp_path):
    rng = np.random.default_rng(0)
    config = {"data": _pairs_tsv(tmp_path / "pairs.tsv", rng),
              "tokeniser": {"type": "bpe", "max_len": 16, "num_merges": 30},
              "embedding": {"type": "lookup", "embedding_dim": 64},
              "encoder": ENCODER, "loss": {"type": "in_batch", "temperature": TEMPERATURE},
              "optimizer": {"type": "adamw", "lr": 1e-3}, "precision": "bf16",
              "batch_size": 16, "epochs": 1, "checkpoint_dir": str(tmp_path / "ckpt"),
              "log_dir": str(tmp_path / "logs")}
    state, pipe = train_model(config, seed=1, device="cpu")
    assert state.step == 3 and pipe.spec.tower.arch == "deepseek_v3"
    model, spec, tokenizer, _ = load_trained_model(str(tmp_path / "ckpt" / "best_model"),
                                                   device="cpu")
    trained = params_to_jax(state.model)
    loaded = params_to_jax(model)
    np.testing.assert_array_equal(trained["query_tower"]["layers"][2]["router_bias"],
                                  loaded["query_tower"]["layers"][2]["router_bias"])
    np.testing.assert_array_equal(trained["query_tower"]["layers"][1]["experts_down_w"],
                                  loaded["query_tower"]["layers"][1]["experts_down_w"])
    search = TwoTowerSearch(model, spec, tokenizer, max_length=16, device="cpu")
    docs = [f"w{i} w{i + 1} w{i + 2}" for i in range(0, 30, 3)]
    search.index_documents(docs)
    top = search.search(docs[4], top_k=3)
    assert len(top) == 3 and all(np.isfinite(score) for _, score in top)


EXPERT_SPANS = {"mla", "moe.route", "moe.dispatch", "moe.experts", "moe.combine"}


def test_device_spans_and_the_counter_only_under_the_profiler():
    tracing.clear()
    model = _model()
    queries, positives, weights = _batch()
    _step_grads(model, queries, positives, weights)
    assert tracing.device_spans() == [] and tracing.counters() == {}
    model.zero_grad()
    with profile(activities=[ProfilerActivity.CPU]):
        _step_grads(model, queries, positives, weights)
    spans = tracing.device_spans()
    assert {s.name for s in spans} == EXPERT_SPANS
    # 2 expert layers, each run by the query and the document encodes
    by = {}
    for s in spans:
        by.setdefault((s.name, s.attrs.get("phase")), []).append(s)
    assert {k: len(v) for k, v in by.items()} == {
        ("mla", None): 6, ("moe.route", None): 4,
        ("moe.dispatch", "forward"): 4, ("moe.dispatch", "backward"): 4,
        ("moe.experts", "forward"): 4, ("moe.experts", "backward"): 4,
        ("moe.combine", "forward"): 4, ("moe.combine", "backward"): 4}
    assert all(s.ms >= 0 and s.start_ns <= s.end_ns for s in spans)
    assert {s.attrs["layer"] for s in spans if s.name != "mla"} == {1, 2}
    assert sorted({s.attrs["tokens"] for s in spans}) == [6 * 8, 6 * 14]
    assert set(tracing.device_ms()) == EXPERT_SPANS
    # at most 3 held picks a token, in 2 layers of 2 encodes
    (assignments,) = tracing.counters().values()
    assert 0 < assignments <= 2 * 3 * 6 * (8 + 14) and assignments == int(assignments)
    assert list(tracing.counters()) == ["moe.assignments"]
    tracing.clear()
    assert tracing.device_spans() == [] and tracing.counters() == {}


def test_the_counter_counts_the_held_assignments():
    model = _model()
    layer = model.query_tower.layers[1].mlp
    h = torch.randn(30, 64, generator=torch.Generator().manual_seed(4))
    chosen, _ = moe_mod.route(h, layer.router.weight, layer.router_bias, 3, 2.446)
    want = int(((chosen >= 4) & (chosen < 8)).sum())
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        picks, ends, held = layer.order(chosen)
    assert tracing.counters() == {"moe.assignments": float(want)}
    assert held == want == len(picks) == int(ends[-1])
    assert ends.tolist() == np.cumsum([int((chosen == e).sum()) for e in range(4, 8)]).tolist()
    experts = chosen.flatten()[picks] - 4
    assert experts.tolist() == sorted(experts.tolist())
    tracing.clear()


def test_dispatch_and_combine_are_each_others_gradient():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(10, 8, generator=gen, requires_grad=True)
    tokens = torch.tensor([3, 3, 0, 9, 5, 3], dtype=torch.int32)
    rows = moe_mod.Dispatch.apply(x, tokens, 0)
    torch.testing.assert_close(rows, x[tokens.long()])
    g = torch.randn(6, 8, generator=gen)
    (x_grad,) = torch.autograd.grad(rows, x, g)
    torch.testing.assert_close(x_grad, torch.zeros(10, 8).index_add(0, tokens.long(), g))
    y = torch.randn(6, 8, generator=gen, requires_grad=True)
    out = moe_mod.Combine.apply(y, tokens, 10, torch.float32, 0)
    torch.testing.assert_close(out, torch.zeros(10, 8).index_add(0, tokens.long(), y))
    h = torch.randn(10, 8, generator=gen)
    (y_grad,) = torch.autograd.grad(out, y, h)
    torch.testing.assert_close(y_grad, h[tokens.long()])


def test_expert_products_backward_matches_autograd_of_the_plain_loop():
    gen = torch.Generator().manual_seed(6)
    counts = [3, 0, 5, 2]
    rows = torch.randn(10, 16, generator=gen, requires_grad=True)
    gate_up = torch.randn(4, 16, 16, generator=gen, requires_grad=True)
    down = torch.randn(4, 8, 16, generator=gen, requires_grad=True)
    offsets = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    got = moe_mod.ExpertProducts.apply(rows, gate_up, down, offsets, 0, 10)
    grad = torch.randn(10, 16, generator=gen)
    got_grads = torch.autograd.grad(got, (rows, gate_up, down), grad)
    parts, start = [], 0
    for e, n in enumerate(counts):
        g, u = (rows[start:start + n] @ gate_up[e]).chunk(2, dim=-1)
        parts.append((torch.nn.functional.silu(g) * u) @ down[e])
        start += n
    want = torch.cat(parts)
    want_grads = torch.autograd.grad(want, (rows, gate_up, down), grad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_the_silu_gate_gives_the_same_bits_in_any_chunks(monkeypatch):
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(37, 5, 10, generator=gen).bfloat16()
    grad = torch.randn(37, 5, 5, generator=gen).bfloat16()
    whole = moe_mod._silu_gate(h), moe_mod._silu_gate_grad(h, grad)
    monkeypatch.setattr(moe_mod, "ELEMENTWISE_CHUNK", 30)
    assert len(moe_mod._row_chunks(h)[1]) == 62
    chunked = moe_mod._silu_gate(h), moe_mod._silu_gate_grad(h, grad)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    gate, up = h.float().chunk(2, dim=-1)
    assert torch.equal(whole[0], (torch.nn.functional.silu(gate) * up).bfloat16())
