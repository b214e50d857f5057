"""The port's losses, optimizer and train step against the JAX package.

Inputs come from a numpy seed and go to both packages; JAX's weights and
optax state are carried into the port with ``convert.py``. The JAX step
runs as on the TPU: ``take_fast_grad`` is patched to ``_take_scatter_grad``
(on the CPU it would take plain ``jnp.take``, whose bf16 transpose sums in
bf16; the TPU route and the port sum in f32), with the scatter-add kernel in
interpret mode at a small tile. No file of the JAX package changes.

Small sizes: vocab 640 (> 512, the word-scale lookup), batch 8, seq 12,
embedding 16, hidden 32. Tolerances and why:

* f32: loss and metrics rtol 1e-5 and gradients rtol/atol 1e-5 (the same
  f32 arithmetic summed in another order); params after 3 AdamW steps atol
  1e-5, a hundredth of lr: Adam turns a gradient element near 0 into an
  lr-sized step, so params are compared in units of lr;
* bf16 (``precision: bf16``): XLA compiles the step into fused kernels that
  round the bf16 lookup and pooling at other places than eager PyTorch
  does (the two agree bit for bit op by op). Loss and similarities within
  2e-3, grad_norm rtol 2e-2, gradients within 3e-2 of the largest, and
  params after 3 steps within 10 lr (1e-2), with their mean difference
  below lr / 4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from twotowers_tpu.kernels import pallas_scatter_add as jax_psa
from twotowers_tpu.models import (
    EmbeddingSpec as JaxEmbeddingSpec, TowerSpec as JaxTowerSpec,
    TwoTowerSpec as JaxTwoTowerSpec, init_two_tower)
from twotowers_tpu.models.losses import build_loss as jax_build_loss
from twotowers_tpu.ops import core as jax_core
from twotowers_tpu.train import build_optimizer as jax_build_optimizer
from twotowers_tpu.train import create_train_state as jax_create_train_state
from twotowers_tpu.train import make_train_step as jax_make_train_step
from twotowers_tpu.train.step import _encode_for_loss as jax_encode_for_loss
from twotowers_tpu_torch.convert import (
    opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax)
from twotowers_tpu_torch.models import (
    EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec, build_loss)
from twotowers_tpu_torch.models.losses import LOSS_REGISTRY
from twotowers_tpu_torch.ops import core
from twotowers_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from twotowers_tpu_torch.train.optim import clip_by_global_norm_, global_norm
from twotowers_tpu_torch.train.step import make_eval_step

VOCAB, BATCH, SEQ, EMB, HID = 640, 8, 12, 16, 32
LR = 1e-3


def route_jax_lookup_through_kernel(monkeypatch):
    """Send JAX's word-scale lookup through the scatter-add kernel, as on
    the TPU (interpret mode, tile 128: the tile changes no sum)."""
    kernel = jax_psa.scatter_add_rows
    monkeypatch.setattr(jax_psa, "take_fast_grad",
                        lambda table, ids, dtype=None: jax_psa._take_scatter_grad(
                            table, ids, table.dtype if dtype is None else dtype))
    monkeypatch.setattr(jax_psa, "scatter_add_rows",
                        lambda g, ids, vocab: kernel(g, ids, vocab, tile_n=128, interpret=True))


@pytest.fixture
def jax_tpu_route(monkeypatch):
    route_jax_lookup_through_kernel(monkeypatch)


def _specs(tied, bf16, arch="mean", hidden=HID):
    jax_spec = JaxTwoTowerSpec(
        embedding=JaxEmbeddingSpec(kind="lookup", vocab_size=VOCAB, embedding_dim=EMB),
        tower=JaxTowerSpec(arch=arch, embedding_dim=EMB, hidden_dim=hidden),
        tied_weights=tied, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    spec = TwoTowerSpec(
        embedding=EmbeddingSpec(kind="lookup", vocab_size=VOCAB, embedding_dim=EMB),
        tower=TowerSpec(arch=arch, embedding_dim=EMB, hidden_dim=hidden),
        tied_weights=tied, compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    return jax_spec, spec


def _batch(rng):
    """(q, p, n, w): ragged padding, an all-PAD query row and two pad rows."""
    q, p, n = (rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32) for _ in range(3))
    q[:, 9:] = 0
    q[3] = 0
    w = np.ones(BATCH, np.float32)
    w[-2:] = 0.0
    for a in (q, p, n):
        a[-2:] = 0
    return q, p, n, w


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_tree(model):
    """The model's .grad in the JAX layout."""
    g_model = copy.deepcopy(model)
    with torch.no_grad():
        for p, src in zip(g_model.parameters(), model.parameters()):
            p.copy_(src.grad if src.grad is not None else torch.zeros_like(src))
    return params_to_jax(g_model)


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ---- losses -------------------------------------------------------------------

def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", sorted(LOSS_REGISTRY.names()))
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(np_rng, name, weighted):
    loss_def, jax_def = build_loss(name), jax_build_loss(name)
    assert loss_def.arity == jax_def.arity
    q, p = _unit(np_rng, 6, 8), _unit(np_rng, 6, 8)
    n = _unit(np_rng, 6, 3, 8) if loss_def.arity == "multi_neg" else _unit(np_rng, 6, 8)
    w = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    args = (q, p) if loss_def.arity == "pair" else (q, p, n)
    got, got_aux = loss_def.fn(*map(torch.from_numpy, args),
                               None if w is None else torch.from_numpy(w))
    want, want_aux = jax_def.fn(*map(jnp.asarray, args), None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    assert set(got_aux) == set(want_aux) == {"pos_similarity", "neg_similarity"}
    for key in got_aux:
        np.testing.assert_allclose(float(got_aux[key]), float(want_aux[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_in_batch_pad_rows_are_never_negatives(np_rng):
    """A pad row's document must not enter any real row's softmax, however
    close it is (the -1e9 mask)."""
    loss_def = build_loss("in_batch")
    q, d = _unit(np_rng, 4, 8), _unit(np_rng, 4, 8)
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    base, _ = loss_def.fn(torch.from_numpy(q), torch.from_numpy(d), w)
    d[3] = q[0]  # the pad row now matches query 0 exactly
    again, _ = loss_def.fn(torch.from_numpy(q), torch.from_numpy(d), w)
    assert float(base) == float(again)


# ---- ops gradients --------------------------------------------------------------

@pytest.mark.parametrize("fn", ["l2_normalize", "cosine_similarity"])
def test_op_gradients_match_jax_at_zero_rows(np_rng, fn):
    """An exactly-zero row (all-PAD pooling) gets a finite gradient, the
    JAX package's."""
    x = np_rng.normal(size=(5, 8)).astype(np.float32)
    x[2] = 0.0
    y = np_rng.normal(size=(5, 8)).astype(np.float32)
    weight = np_rng.normal(size=(5, 8) if fn == "l2_normalize" else (5,)).astype(np.float32)
    port, ref = getattr(core, fn), getattr(jax_core, fn)
    args = (x,) if fn == "l2_normalize" else (x, y)

    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, *map(torch.from_numpy, args[1:]))
    (out * torch.from_numpy(weight)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(ref(a, *map(jnp.asarray, args[1:]))
                                      * jnp.asarray(weight)))(jnp.asarray(x))
    got = xt.grad.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_safe_norm_gradient_is_zero_at_zero_rows(np_rng):
    """``_safe_norm`` clamps inside the sqrt: its gradient at an exactly
    zero row is 0, not NaN (a plain sqrt of the squares' sum gives NaN
    there)."""
    x = np_rng.normal(size=(3, 8)).astype(np.float32)
    x[1] = 0.0
    xt = torch.from_numpy(x).requires_grad_()
    core._safe_norm(xt, -1, keepdim=False, eps=core.NORM_EPS).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_core._safe_norm(a, -1, False, jax_core.NORM_EPS)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy()[1], 0.0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    plain = torch.from_numpy(x).requires_grad_()
    torch.sqrt((plain * plain).sum(-1)).sum().backward()
    assert torch.isnan(plain.grad[1]).all()


# ---- optimizer ------------------------------------------------------------------

@pytest.mark.parametrize("cfg,kind", [
    ({}, "adamw"), ({"optimizer": {"type": "Adam", "lr": 0.01}}, "adam"),
    ({"optimizer": {"type": "sgd", "momentum": 0.5}}, "sgd"),
    ({"optimizer": {"type": "lamb"}}, "adamw")])
def test_build_optimizer_reads_the_config(cfg, kind):
    opt = build_optimizer(cfg)
    assert opt.kind == kind and opt.grad_clip_norm is None
    built = opt.build([torch.nn.Parameter(torch.zeros(2))])
    assert type(built).__name__ == {"adamw": "AdamW", "adam": "Adam", "sgd": "SGD"}[kind]
    group = built.param_groups[0]
    if kind != "sgd":
        assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == (0.01 if kind == "adamw" else 0.0)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_follows_optax(np_rng, max_norm):
    grads = [np_rng.normal(size=(4, 3)).astype(np.float32), np_rng.normal(size=5).astype(np.float32)]
    tgrads = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(tgrads)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    clip_by_global_norm_(tgrads, max_norm, norm)
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    for got, w in zip(tgrads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# ---- the train step -------------------------------------------------------------

def _jax_loss_and_grads(params, jax_spec, loss_def, batch):
    q, p, n, w = map(jnp.asarray, batch)

    def loss_of(prm):
        return jax_encode_for_loss(prm, jax_spec, loss_def, q, p, n, w,
                                   train=True, dropout_rng=None)

    (loss, _), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return float(loss), _np(grads)


def _run_both(jax_spec, spec, config, params, batches, opt_state=None):
    """Both packages' steps over ``batches`` from the same weights; returns
    per-step metrics, the gradients of the first step and the final state."""
    loss_name = "triplet"
    jax_opt = jax_build_optimizer(config)
    jax_step = jax_make_train_step(jax_spec, jax_build_loss(loss_name, margin=0.2), jax_opt)
    jax_state = jax_create_train_state(params, jax_opt)
    opt = build_optimizer(config)
    model = params_from_jax(_np(params), spec)
    state = create_train_state(model, opt)
    if opt_state is not None:
        jax_state = jax_state._replace(opt_state=opt_state)
        opt_state_from_jax(_np(opt_state[0]._asdict()), model, state.optimizer)
    step = make_train_step(build_loss(loss_name, margin=0.2), opt)
    jax_grads = _jax_loss_and_grads(params, jax_spec, jax_build_loss(loss_name, margin=0.2),
                                    batches[0])[1]
    metrics, grads = [], None
    for batch in batches:
        jax_state, jm = jax_step(jax_state, *map(jnp.asarray, batch))
        state, tm = step(state, *map(torch.from_numpy, batch))
        if grads is None:
            grads = _grads_tree(state.model)
        metrics.append(({k: float(v) for k, v in tm.items()}, {k: float(v) for k, v in jm.items()}))
    return metrics, (grads, jax_grads), (state, jax_state)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_train_step_matches_jax(np_rng, jax_tpu_route, tied, bf16):
    jax_spec, spec = _specs(tied, bf16)
    params = init_two_tower(jax.random.PRNGKey(5), jax_spec)
    batches = [_batch(np_rng) for _ in range(3)]
    config = {"optimizer": {"type": "adamw", "lr": LR}}
    metrics, (grads, jax_grads), (state, jax_state) = _run_both(
        jax_spec, spec, config, params, batches)

    for got, want in metrics:
        assert set(got) == set(want) == {"loss", "pos_similarity", "neg_similarity",
                                         "similarity_diff", "grad_norm"}
        for key in got:
            if bf16:
                rtol = 2e-2 if key == "grad_norm" else 0.0
                np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=2e-3, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jax_grads))
    if bf16:
        _assert_trees_close(grads, jax_grads, rtol=0, atol=3e-2 * scale)
    else:
        _assert_trees_close(grads, jax_grads, rtol=1e-5, atol=1e-5 * scale)
    assert state.step == int(jax_state.step) == 3
    got_params = params_to_jax(state.model)
    _assert_trees_close(got_params, _np(jax_state.params), rtol=0, atol=10 * LR if bf16 else 1e-2 * LR)
    if bf16:
        diffs = [np.abs(np.asarray(a) - np.asarray(b)).mean() for a, b in zip(
            jax.tree_util.tree_leaves(got_params), jax.tree_util.tree_leaves(_np(jax_state.params)))]
        assert max(diffs) < LR / 4, diffs


@pytest.mark.parametrize("config", [
    {"optimizer": {"type": "adam", "lr": LR}},
    {"optimizer": {"type": "sgd", "lr": 0.05, "momentum": 0.9}},
    {"optimizer": {"type": "adamw", "lr": LR, "grad_clip_norm": 0.05}},
], ids=["adam", "sgd", "adamw-clip"])
def test_optimizer_variants_match_jax(np_rng, jax_tpu_route, config):
    jax_spec, spec = _specs(tied=False, bf16=False)
    params = init_two_tower(jax.random.PRNGKey(6), jax_spec)
    batches = [_batch(np_rng) for _ in range(3)]
    metrics, _, (state, jax_state) = _run_both(jax_spec, spec, config, params, batches)
    for got, want in metrics:  # grad_norm is taken before clipping in both
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    lr = config["optimizer"]["lr"]
    _assert_trees_close(params_to_jax(state.model), _np(jax_state.params), rtol=0,
                        atol=1e-2 * lr)


def test_optimizer_state_carries_over(np_rng, jax_tpu_route):
    """Two JAX steps; params and the optax AdamW state carried into the
    port; step 3 on both; the state carried back matches optax's."""
    jax_spec, spec = _specs(tied=True, bf16=False)
    config = {"optimizer": {"type": "adamw", "lr": LR}}
    jax_opt = jax_build_optimizer(config)
    jax_step = jax_make_train_step(jax_spec, jax_build_loss("triplet", margin=0.2), jax_opt)
    jax_state = jax_create_train_state(init_two_tower(jax.random.PRNGKey(7), jax_spec), jax_opt)
    for _ in range(2):
        jax_state, _ = jax_step(jax_state, *map(jnp.asarray, _batch(np_rng)))
    params, opt_state = _np(jax_state.params), jax_state.opt_state
    adam = _np(opt_state[0]._asdict())
    assert int(adam["count"]) == 2

    metrics, _, (state, jax_state) = _run_both(
        jax_spec, spec, config, params, [_batch(np_rng)], opt_state=opt_state)
    got, want = metrics[0]
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    _assert_trees_close(params_to_jax(state.model), _np(jax_state.params), rtol=0,
                        atol=1e-2 * LR)
    back = opt_state_to_jax(state.model, state.optimizer)
    want = _np(jax_state.opt_state[0]._asdict())
    assert int(back["count"]) == int(want["count"]) == 3
    _assert_trees_close(back["mu"], want["mu"], rtol=1e-5, atol=1e-8)
    _assert_trees_close(back["nu"], want["nu"], rtol=1e-4, atol=1e-10)


def test_frozen_table_stays_out_of_the_optimizer(np_rng):
    spec = TwoTowerSpec(
        embedding=EmbeddingSpec(kind="lookup", vocab_size=VOCAB, embedding_dim=EMB,
                                trainable=False),
        tower=TowerSpec(arch="mean", embedding_dim=EMB, hidden_dim=HID), tied_weights=True)
    model = TwoTower(spec, torch.Generator().manual_seed(0))
    table = model.embedding.table.detach().clone()
    opt = build_optimizer({"optimizer": {"type": "adamw", "weight_decay": 0.5}})
    state = create_train_state(model, opt)
    held = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    assert id(model.embedding.table) not in held
    step = make_train_step(build_loss("triplet"), opt)
    state, metrics = step(state, *map(torch.from_numpy, _batch(np_rng)))
    assert model.embedding.table.grad is None
    assert torch.equal(model.embedding.table, table)  # no decay either
    state_tree = opt_state_to_jax(model, state.optimizer)
    assert not state_tree["mu"]["embedding"]["table"].any()  # optax keeps zeros there


def test_eval_step_has_no_dropout_and_no_grad(np_rng):
    jax_spec, spec = _specs(tied=False, bf16=False, arch="avg_pool", hidden=24)
    model = params_from_jax(_np(init_two_tower(jax.random.PRNGKey(8), jax_spec)), spec)
    evaluate = make_eval_step(build_loss("triplet"))
    batch = list(map(torch.from_numpy, _batch(np_rng)))
    first, again = evaluate(model, *batch), evaluate(model, *batch)
    assert first == again and not first["loss"].requires_grad
    assert not model.training


def test_dropout_draws_from_the_state_generator(np_rng):
    """avg_pool's training dropout: the same seed gives the same masks and
    the same step; another seed another."""
    _, spec = _specs(tied=False, bf16=False, arch="avg_pool", hidden=24)
    batch = list(map(torch.from_numpy, _batch(np_rng)))
    losses = []
    for seed in (0, 0, 1):
        model = TwoTower(spec, torch.Generator().manual_seed(3))
        opt = build_optimizer({})
        step = make_train_step(build_loss("triplet"), opt)
        _, metrics = step(create_train_state(model, opt, seed=seed), *batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1] != losses[2]
