"""The port's sequence towers (cnn / rnn / transformer), the ``positional``
embedding, the converter and the checkpoints of these models, against JAX.

JAX's weights (``init_two_tower`` from a PRNG key) are carried into the
port with ``convert.params_from_jax``; ids come from a numpy seed and go to
both packages. Small sizes: batch 6, seq 12, embedding 16, hidden 32, 2
layers, 4 heads. Tolerances and why:

* f32 encodings: rtol 1e-5, atol 1e-5 (the same f32 arithmetic, summed in
  another order by another BLAS; the GRU's 12 steps and the transformer's
  2 blocks compound it);
* bf16 encodings: atol 1.5e-2 on unit vectors, four bf16 steps (2**-8 =
  3.9e-3 relative each). XLA fuses the towers' elementwise chains and
  rounds their bf16 results at other places than eager PyTorch (which
  rounds after every op); the GRU's 12 steps and the transformer's 2
  blocks carry such roundings along. On this seeded input the gaps are
  3e-8 (cnn), 2.4e-3 (rnn) and 3.9e-3 (transformer);
* one ``in_batch`` train step in f32: loss and similarities rtol 1e-5,
  gradients rtol 1e-5 and atol 1e-5 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _assert_trees_close, _grads_tree, jax_tpu_route  # noqa: F401
from twotowers_tpu.models import (
    EmbeddingSpec as JaxEmbeddingSpec, TowerSpec as JaxTowerSpec,
    TwoTowerSpec as JaxTwoTowerSpec, init_two_tower)
from twotowers_tpu.models.losses import build_loss as jax_build_loss
from twotowers_tpu.models.towers import encode as jax_encode
from twotowers_tpu.models.towers import forward as jax_forward
from twotowers_tpu.train import build_optimizer as jax_build_optimizer
from twotowers_tpu.train import create_train_state as jax_create_train_state
from twotowers_tpu.train import make_train_step as jax_make_train_step
from twotowers_tpu.tokenizers import build_tokenizer as jax_build_tokenizer
from twotowers_tpu_torch.convert import (
    opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax)
from twotowers_tpu_torch.models import (
    EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec, build_loss, is_sequence_arch)
from twotowers_tpu_torch.tokenizers import build_tokenizer
from twotowers_tpu_torch.train import (
    build_optimizer, create_train_state, load_checkpoint, load_trained_model, make_train_step,
    save_checkpoint)

ARCHS = ["cnn", "rnn", "transformer"]
BATCH, SEQ, EMB, HID = 6, 12, 16, 32


def _specs(arch, tied=True, kind="lookup", vocab=40, bf16=False, kernel_size=3,
           max_len=SEQ, dropout=0.0):
    def build(E, T, S, dtype):
        return S(embedding=E(kind=kind, vocab_size=vocab, embedding_dim=EMB, max_len=max_len),
                 tower=T(arch=arch, embedding_dim=EMB, hidden_dim=HID, dropout=dropout,
                         kernel_size=kernel_size, num_layers=2, num_heads=4, max_len=max_len),
                 tied_weights=tied, compute_dtype=dtype)

    return (build(JaxEmbeddingSpec, JaxTowerSpec, JaxTwoTowerSpec,
                  jnp.bfloat16 if bf16 else jnp.float32),
            build(EmbeddingSpec, TowerSpec, TwoTowerSpec,
                  torch.bfloat16 if bf16 else torch.float32))


def _ids(rng, vocab, batch=BATCH, seq=SEQ):
    """Ragged trailing padding, one full row and one all-pad row."""
    ids = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
    for row, length in enumerate(rng.integers(1, seq, size=batch)):
        ids[row, length:] = 0
    ids[0] = rng.integers(1, vocab, size=seq)
    ids[1] = 0
    return ids


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=1, **spec_kw):
    jax_spec, spec = _specs(arch, **spec_kw)
    params = init_two_tower(jax.random.PRNGKey(seed), jax_spec)
    return jax_spec, spec, params, params_from_jax(_np(params), spec).eval()


def _encode_both(jax_spec, params, model, ids, tower):
    want = np.asarray(jax_encode(params, jax_spec, jnp.asarray(ids), tower))
    with torch.no_grad():
        got = model.encode(torch.from_numpy(ids), tower).numpy()
    return got, want


# ---- encodings ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("kind,vocab", [("lookup", 40), ("positional", 600)])
def test_encode_matches_jax_in_f32(np_rng, arch, tied, kind, vocab):
    jax_spec, spec, params, model = _pair(arch, tied=tied, kind=kind, vocab=vocab)
    assert is_sequence_arch(arch)
    ids = _ids(np_rng, vocab)
    for tower in ("query", "document"):
        got, want = _encode_both(jax_spec, params, model, ids, tower)
        assert got.shape == (BATCH, HID) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=tower)
    q, d = model(*(torch.from_numpy(ids),) * 2)
    assert torch.equal(q, d) or not tied


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_matches_jax_in_bf16(np_rng, arch):
    jax_spec, spec, params, model = _pair(arch, kind="positional", vocab=600, bf16=True)
    got, want = _encode_both(jax_spec, params, model, _ids(np_rng, 600), "query")
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_pad_rows_match_jax(arch):
    """A batch of rows with no real token: the transformer attends
    uniformly, the CNN pools to zero, the GRU keeps its zero state."""
    jax_spec, spec, params, model = _pair(arch, kind="positional", vocab=600)
    ids = np.zeros((3, SEQ), np.int32)
    got, want = _encode_both(jax_spec, params, model, ids, "query")
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel_size", [2, 4, 5])
def test_cnn_same_padding_matches_xla_at_any_kernel(np_rng, kernel_size):
    """XLA's SAME pads (K-1)//2 on the left and the rest on the right; an
    even kernel is where a wrong split shows."""
    jax_spec, spec, params, model = _pair("cnn", kernel_size=kernel_size, seed=kernel_size)
    assert model.query_tower.conv1.weight.shape == (HID, EMB, kernel_size)
    got, want = _encode_both(jax_spec, params, model, _ids(np_rng, 40), "query")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["lookup", "positional"])
def test_sequence_longer_than_max_len_raises_in_both(np_rng, kind):
    """Past max_len the positional table raises first, else the transformer."""
    jax_spec, spec, params, model = _pair("transformer", kind=kind, vocab=600, max_len=8)
    ids = _ids(np_rng, 600, seq=9)
    with pytest.raises(ValueError, match="exceeds"):
        jax_encode(params, jax_spec, jnp.asarray(ids), "query")
    with pytest.raises(ValueError, match="exceeds"):
        model.encode(torch.from_numpy(ids))
    got, want = _encode_both(jax_spec, params, model, ids[:, :8], "query")  # at max_len
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["cnn", "transformer"])
def test_dropout_draws_from_the_generator(np_rng, arch):
    """In training mode the masks come from the generator passed in, one
    seed one mask; in eval mode, or with no generator (JAX's towers with no
    key), there is no dropout."""
    _, spec = _specs(arch, kind="positional", vocab=600, dropout=0.5)
    model = TwoTower(spec, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids(np_rng, 600))
    state = torch.random.get_rng_state()
    with torch.no_grad():
        a = model.encode(ids, "query", torch.Generator().manual_seed(3))
        b = model.encode(ids, "query", torch.Generator().manual_seed(3))
        c = model.encode(ids, "query", torch.Generator().manual_seed(4))
        no_key = model.encode(ids, "query")
        model.eval()
        e1, e2 = model.encode(ids), model.encode(ids, "query", torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, e1)
    assert torch.equal(e1, e2) and torch.equal(no_key, e1)


def test_hidden_must_divide_by_heads():
    _, spec = _specs("transformer")
    bad = TwoTowerSpec(embedding=spec.embedding,
                       tower=TowerSpec(arch="transformer", embedding_dim=EMB, hidden_dim=30,
                                       num_heads=4),
                       tied_weights=True)
    with pytest.raises(ValueError, match="must divide by num_heads"):
        TwoTower(bad)


# ---- the converter --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("kind", ["lookup", "positional"])
def test_converter_round_trip_is_bit_exact(arch, tied, kind):
    jax_spec, spec = _specs(arch, tied=tied, kind=kind, vocab=600)
    tree = _np(init_two_tower(jax.random.PRNGKey(3), jax_spec))
    back = params_to_jax(params_from_jax(tree, spec))
    if arch == "transformer":
        assert isinstance(back["query_tower"]["layers"], list)
        assert len(back["query_tower"]["layers"]) == 2
    flat = jax.tree_util.tree_leaves_with_path(tree)
    back_flat = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in back_flat]
    for (_, a), (_, b) in zip(flat, back_flat):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_converter_lays_out_conv_and_gru_weights():
    """JAX's WIO conv weight becomes (C_out, C_in, K); the GRU's w_x, b and
    w_h become the hand-written cell's x_proj and h_proj."""
    for arch in ("cnn", "rnn"):
        jax_spec, spec = _specs(arch, kernel_size=2)
        tree = _np(init_two_tower(jax.random.PRNGKey(4), jax_spec))
        tower = params_from_jax(tree, spec).query_tower
        jt = tree["query_tower"]
        if arch == "cnn":
            np.testing.assert_array_equal(tower.conv1.weight.detach().numpy(),
                                          jt["conv1_w"].transpose(2, 1, 0))
        else:
            np.testing.assert_array_equal(tower.x_proj.weight.detach().numpy(), jt["w_x"].T)
            np.testing.assert_array_equal(tower.x_proj.bias.detach().numpy(), jt["b"])
            np.testing.assert_array_equal(tower.h_proj.weight.detach().numpy(), jt["w_h"].T)


# ---- the train step -------------------------------------------------------------

def _pair_batch(rng, vocab):
    q, p = _ids(rng, vocab, batch=8), _ids(rng, vocab, batch=8)
    q[1], p[1] = p[1], rng.integers(1, vocab, size=SEQ)  # the all-pad row, as a document
    w = np.ones(8, np.float32)
    w[-1] = 0.0
    q[-1] = p[-1] = 0
    return q, p, w


@pytest.mark.parametrize("arch,kind,vocab", [
    ("transformer", "positional", 600), ("transformer", "lookup", 40),
    ("cnn", "positional", 600), ("rnn", "lookup", 600)])
def test_in_batch_step_matches_jax_in_f32(np_rng, jax_tpu_route, arch, kind, vocab):
    """One ``in_batch`` AdamW step from the same weights: loss, metrics and
    every gradient, then the optax state carried out of the port."""
    jax_spec, spec, params, model = _pair(arch, tied=True, kind=kind, vocab=vocab, seed=5)
    q, p, w = _pair_batch(np_rng, vocab)
    config = {"optimizer": {"type": "adamw", "lr": 1e-3}}
    loss = jax_build_loss("in_batch", temperature=0.1)
    jax_opt = jax_build_optimizer(config)
    jax_state = jax_create_train_state(params, jax_opt)

    def loss_of(prm):
        qv, dv = jax_forward(prm, jax_spec, jnp.asarray(q), jnp.asarray(p))
        return loss.fn(qv, dv, jnp.asarray(w))[0]

    jax_grads = _np(jax.grad(loss_of)(params))
    jax_state, jm = jax_make_train_step(jax_spec, loss, jax_opt)(
        jax_state, jnp.asarray(q), jnp.asarray(p), None, jnp.asarray(w))

    opt = build_optimizer(config)
    state = create_train_state(model, opt)
    state, tm = make_train_step(build_loss("in_batch", temperature=0.1), opt)(
        state, torch.from_numpy(q), torch.from_numpy(p), None, torch.from_numpy(w))
    for key in ("loss", "pos_similarity", "neg_similarity", "similarity_diff", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jax_grads))
    _assert_trees_close(_grads_tree(state.model), jax_grads, rtol=1e-5, atol=1e-5 * scale)
    adam = _np(jax_state.opt_state[0]._asdict())
    got = opt_state_to_jax(state.model, state.optimizer)
    assert int(got["count"]) == int(adam["count"]) == 1
    # mu = 0.1 g and nu = 0.001 g**2 after one step: the gradients' tolerance
    _assert_trees_close(got["mu"], adam["mu"], rtol=1e-5, atol=1e-5 * scale)
    _assert_trees_close(got["nu"], adam["nu"], rtol=2e-5, atol=1e-5 * scale ** 2)
    # and back in: the moments the port reads are those it wrote
    again = create_train_state(params_from_jax(params_to_jax(state.model), spec),
                               build_optimizer(config))
    opt_state_from_jax(got, again.model, again.optimizer)
    back = opt_state_to_jax(again.model, again.optimizer)
    _assert_trees_close(back["mu"], got["mu"], rtol=0, atol=0)


# ---- checkpoints ----------------------------------------------------------------

def _texts(rng, n):
    words = ["alpha", "beta", "gamma", "delta", "omega", "sigma", "kappa", "theta"]
    return [" ".join(rng.choice(words, size=rng.integers(2, 7))) for _ in range(n)]


def test_checkpoint_stores_list_items_under_their_index(tmp_path):
    """A list in a param tree is flattened item by item (``layers/0/w``)
    and read back as a list, in params.npz and in opt_state.npz."""
    rng = np.random.default_rng(0)
    tree = {"tower": {"layers": [{"w": rng.normal(size=(2, 3)).astype(np.float32)}
                                 for _ in range(3)],
                      "b": np.zeros(3, np.float32)}}
    path = save_checkpoint({"params": tree, "opt_state": {"mu": tree}}, str(tmp_path),
                           tokenizer_state={"type": "char"}, config={})
    with np.load(f"{path}/params.npz") as data:
        assert sorted(data.files) == ["tower/b", "tower/layers/0/w", "tower/layers/1/w",
                                      "tower/layers/2/w"]
    loaded, _ = load_checkpoint(path)
    for got in (loaded["params"], loaded["opt_state"]["mu"]):
        assert isinstance(got["tower"]["layers"], list) and len(got["tower"]["layers"]) == 3
        _assert_trees_close(got, tree, rtol=0, atol=0)


def test_checkpoint_carries_the_layers_list(tmp_path):
    """``layers`` (a list of dicts) is stored as ``.../layers/<i>/...`` and
    read back as a list: ``np.savez`` cannot hold a list of dicts without
    pickle, which the reader refuses."""
    jax_spec, spec = _specs("transformer", kind="positional", vocab=600)
    tree = _np(init_two_tower(jax.random.PRNGKey(6), jax_spec))
    model = params_from_jax(tree, spec)
    opt = build_optimizer({})
    state = create_train_state(model, opt)
    path = save_checkpoint({"params": tree, "opt_state": opt_state_to_jax(model, state.optimizer)},
                           str(tmp_path), tokenizer_state={"type": "char"}, config={})
    loaded, _ = load_checkpoint(path)
    assert isinstance(loaded["params"]["query_tower"]["layers"], list)
    assert isinstance(loaded["opt_state"]["mu"]["query_tower"]["layers"], list)
    # same paths (a list index is not a dict key to the tree utilities),
    # same bits
    _assert_trees_close(loaded["params"], tree, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_save_checkpoint_then_load_trained_model_encodes_alike(tmp_path, np_rng, arch):
    corpus = _texts(np_rng, 40)
    tok = build_tokenizer("bpe", num_merges=30, max_len=SEQ).fit(corpus)
    jax_tok = jax_build_tokenizer("bpe", num_merges=30, max_len=SEQ).fit(corpus)
    config = {"tokeniser": {"type": "bpe", "max_len": SEQ, "num_merges": 30},
              "embedding": {"type": "positional", "embedding_dim": EMB, "max_len": SEQ},
              "encoder": {"arch": arch, "hidden_dim": HID, "num_layers": 2, "num_heads": 4,
                          "max_len": SEQ, "tied_weights": False, "kernel_size": 2,
                          "dropout": 0.0}}
    _, spec = _specs(arch, tied=False, kind="positional", vocab=tok.vocab_size,
                     kernel_size=2)
    model = TwoTower(spec, torch.Generator().manual_seed(2)).eval()
    opt = build_optimizer({})
    state = create_train_state(model, opt)
    path = save_checkpoint(
        {"params": params_to_jax(model), "opt_state": opt_state_to_jax(model, state.optimizer)},
        str(tmp_path), tokenizer_state=tok.state_dict(), config=config)
    loaded, loaded_spec, loaded_tok, loaded_config = load_trained_model(path, device="cpu")
    assert loaded_spec == spec and loaded_config == config
    assert loaded_tok.state_dict() == tok.state_dict() == jax_tok.state_dict()
    ids = torch.from_numpy(loaded_tok(corpus[:5], SEQ))
    with torch.no_grad():
        for tower in ("query", "document"):
            assert torch.equal(loaded.encode(ids, tower), model.encode(ids, tower))
