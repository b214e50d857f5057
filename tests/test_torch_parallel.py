"""The port's parallel layer against the JAX package's, on the CPU.

The JAX package runs its sharded functions in this process on its 8
virtual CPU devices; the port runs the same cases in spawned gloo ranks
(``torch_spawn.spawn_ranks``), one group of 2 ranks and one of 4, each
spawned once, and every rank writes its results to an ``.npz``. Inputs come
from numpy seeds; the weights are the port's initial draw, carried to JAX
with ``convert.params_to_jax``. The cases mirror ``tests/test_parallel.py``
(its TPU-budget case aside: the card's rule is tested on its own terms).

Small sizes: vocab 51 (an uneven split over 2 shards), batch 13 (padded to
14 over 2 data ranks, so pad rows fall unevenly), seq 10, embedding 8,
hidden 16, AdamW lr 0.01. Tolerances are the port's f32 ones: losses,
metrics, activations and gradients rtol 1e-5 (atol 1e-6 where a value can
be near 0: the same f32 arithmetic summed in another order); params after
one AdamW step atol 1e-4, a hundredth of lr (Adam turns a gradient element
near 0 into an lr-sized step, as in ``test_torch_train.py``); lookups and
placements exactly.

Top level imports no JAX: the ranks import this module.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_spawn import spawn_ranks
from twotowers_tpu_torch.convert import (
    load_params, opt_state_from_jax, params_to_jax)
from twotowers_tpu_torch.models import TwoTower, build_loss, spec_from_config
from twotowers_tpu_torch.parallel import (
    create_sharded_train_state, global_in_batch_loss, initialize_distributed, make_mesh,
    make_sharded_embed_fn, make_sharded_eval_step, make_sharded_train_step, mesh_shape,
    param_specs, recommend_model_parallelism, shard_batch, shard_params, sharded_embed_ids,
    sharded_topk_merge)
from twotowers_tpu_torch.parallel.collectives import all_gather_rows
from twotowers_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_index, choose_backend)
from twotowers_tpu_torch.parallel.sharding import table_block
from twotowers_tpu_torch.parallel.train import sharded_state_to_jax, shard_state_tree
from twotowers_tpu_torch.train import (
    build_optimizer, load_checkpoint, load_trained_model, save_checkpoint, train_model)

ROOT = Path(__file__).resolve().parents[1]
VOCAB, DIM, HID, BATCH, SEQ = 51, 8, 16, 13, 10
OPT = {"optimizer": {"type": "adamw", "lr": 0.01}}
LOSSES = ("triplet", "in_batch", "multiple_negatives")
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
F32 = {"rtol": 1e-5, "atol": 1e-6}
PARAMS_TOL = {"rtol": 0, "atol": 1e-4}  # a hundredth of lr


def _config(vocab_kind="lookup"):
    return {"embedding": {"type": vocab_kind, "embedding_dim": DIM, "max_len": SEQ},
            "encoder": {"arch": "mean", "hidden_dim": HID, "tied_weights": True}}


def _model(vocab=VOCAB, seed=1, kind="lookup") -> TwoTower:
    return TwoTower(spec_from_config(_config(kind), vocab), torch.Generator().manual_seed(seed))


def _batch(seed=0, n=BATCH, seq=SEQ, vocab=VOCAB):
    """(q, p, n, w): ragged padding and two pad rows at the end."""
    rng = np.random.default_rng(seed)
    q, p, neg = (rng.integers(1, vocab, size=(n, seq)).astype(np.int32) for _ in range(3))
    q[:, 7:] = 0
    w = np.ones(n, np.float32)
    w[-2:] = 0.0
    for a in (q, p, neg):
        a[-2:] = 0
    return q, p, neg, w


def _negatives(loss, neg):
    if loss == "in_batch":
        return None
    return np.stack([neg, neg[::-1]], axis=1) if loss == "multiple_negatives" else neg


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---- what each rank runs --------------------------------------------------------

def _step_case(shape, loss):
    mesh = make_mesh(*shape, device_type="cpu")
    opt = build_optimizer(OPT)
    state = create_sharded_train_state(_model(), opt, mesh, seed=9)
    step = make_sharded_train_step(build_loss(loss), opt, mesh)
    q, p, n, w = _batch()
    state, metrics = step(state, *shard_batch(mesh, q, p, _negatives(loss, n), w))
    params, _ = sharded_state_to_jax(state, mesh, VOCAB)
    return {**{k: float(v) for k, v in metrics.items()}, "table": params["embedding"]["table"],
            **{k: v for k, v in params["query_tower"].items()},
            "local_rows": state.model.embedding.table.shape[0]}


def _losses_over_steps(vocab, steps):
    mesh = make_mesh(2, 2, device_type="cpu")
    opt = build_optimizer(OPT)
    state = create_sharded_train_state(_model(vocab), opt, mesh)
    step = make_sharded_train_step(build_loss("in_batch"), opt, mesh)
    q, p, _, w = _batch(vocab=vocab)
    batch = shard_batch(mesh, q, p, None, w)
    return {"losses": [float(step(state, *batch)[1]["loss"]) for _ in range(steps)]}


def _mesh_checks(world):
    out = {"default": mesh_shape(make_mesh(device_type="cpu"))}
    if world == 4:
        mesh = make_mesh(2, 2, device_type="cpu")
        out["2d"] = mesh_shape(mesh)
        out["coord"] = mesh.get_coordinate()
        sub = make_mesh(data=1, model=3, device_type="cpu")
        out["sub"] = mesh_shape(sub)
        out["sub_coord"] = sub.get_coordinate() or (-1, -1)
        for key, kwargs in (("oversized", {"data": 3, "model": 2}), ("indivisible", {"model": 3})):
            try:
                make_mesh(**kwargs, device_type="cpu")
                out[key] = "no error"
            except ValueError as exc:
                out[key] = str(exc)
    return out


def _embed_case(model_axis):
    mesh = make_mesh(4 // model_axis, model_axis, device_type="cpu")
    rng = np.random.default_rng(3)
    table = rng.normal(size=(20, 8)).astype(np.float32)
    ids = rng.integers(0, 20, size=(8, 6)).astype(np.int32)
    (local_ids,) = shard_batch(mesh, ids)
    out = sharded_embed_ids(table_block(_t(table), mesh), local_ids, mesh)
    return {"out": out.numpy(), "d": axis_index(mesh, DATA_AXIS)}


def _embed_grad_case():
    mesh = make_mesh(2, 2, device_type="cpu")
    rng = np.random.default_rng(4)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    ids = rng.integers(0, 16, size=(4, 3)).astype(np.int32)
    block = table_block(_t(table), mesh).clone().requires_grad_()
    (local_ids,) = shard_batch(mesh, ids)
    (sharded_embed_ids(block, local_ids, mesh) ** 2).sum().backward()
    grad = block.grad.clone()
    dist.all_reduce(grad, group=axis_group(mesh, DATA_AXIS))
    return {"grad": all_gather_rows(grad, axis_group(mesh, MODEL_AXIS)).numpy()}


def _global_negatives_case(shape, pad, grad):
    mesh = make_mesh(*shape, device_type="cpu")
    rng = np.random.default_rng(5)
    n = 8 if grad else 16
    q, d = (_unit(rng, n, 8) if not grad else rng.normal(size=(n, 4)).astype(np.float32)
            for _ in range(2))
    w = np.ones(n, np.float32)
    if pad:
        w[12:] = 0.0  # an entire data rank's rows are padding
    lq, ld, lw = shard_batch(mesh, q, d, w)
    ld.requires_grad_(grad)
    loss, aux = global_in_batch_loss(lq, ld, lw, mesh, 0.1)
    out = {"loss": float(loss), "pos": float(aux["pos_similarity"]),
           "neg": float(aux["neg_similarity"])}
    if grad:
        loss.backward()
        out["grad"] = all_gather_rows(ld.grad, axis_group(mesh, DATA_AXIS)).numpy()
    return out


def _topk_case(ties):
    mesh = make_mesh(1, 4, device_type="cpu")
    rng = np.random.default_rng(6)
    dense = (rng.integers(0, 4, size=(3, 256)) if ties else rng.normal(size=(3, 256)))
    dense = dense.astype(np.float32)
    s = axis_index(mesh, MODEL_AXIS)
    block = _t(dense[:, s * 64:(s + 1) * 64])
    vals, idx = torch.sort(block, dim=1, descending=True, stable=True)
    got_s, got_i = sharded_topk_merge(vals[:, :5], idx[:, :5] + s * 64, mesh, 5)
    return {"scores": got_s.numpy(), "indices": got_i.numpy()}


def _placement_case():
    mesh = make_mesh(2, 2, device_type="cpu")
    q, p, n, w = _batch(n=13, seq=12, vocab=50)
    rows = shard_batch(mesh, q, p, n, w)
    return {**{f"a{i}": r.numpy() for i, r in enumerate(rows)},
            "coord": mesh.get_coordinate()}


def _eval_case(loss):
    mesh = make_mesh(2, 2, device_type="cpu")
    model = shard_params(_model(seed=3), mesh, shard_vocab=True)
    q, p, n, w = _batch(seed=7, n=16, seq=12)
    metrics = make_sharded_eval_step(build_loss(loss), mesh)(
        model, *shard_batch(mesh, q, p, _negatives(loss, n), w))
    return {k: float(v) for k, v in metrics.items()}


def _checkpoint_case(workdir):
    mesh = make_mesh(2, 2, device_type="cpu")
    opt = build_optimizer(OPT)
    state = create_sharded_train_state(_model(seed=5), opt, mesh)
    step = make_sharded_train_step(build_loss("triplet"), opt, mesh)
    q, p, n, w = _batch()
    state, _ = step(state, *shard_batch(mesh, q, p, n, w))
    params, opt_state = sharded_state_to_jax(state, mesh, VOCAB)
    if dist.get_rank() == 0:
        save_checkpoint({"params": params, "opt_state": opt_state}, str(workdir / "ckpt"),
                        checkpoint_name="sharded", save_best=False)
    dist.barrier()
    # a fresh sharded state, as a resuming rank builds it, reads the whole file
    tree, _ = load_checkpoint(str(workdir / "ckpt" / "sharded"))
    shard_state_tree(tree["params"], tree["opt_state"], mesh)
    fresh = create_sharded_train_state(_model(seed=11), opt, mesh)
    load_params(fresh.model, tree["params"])
    opt_state_from_jax(tree["opt_state"], fresh.model, fresh.optimizer)
    table = state.model.embedding.table
    moments = state.optimizer.state[table]
    fresh_moments = fresh.optimizer.state[fresh.model.embedding.table]
    return {"table_equal": torch.equal(fresh.model.embedding.table, table),
            "w1_equal": torch.equal(fresh.model.query_tower.fc1.weight,
                                    state.model.query_tower.fc1.weight),
            "moments_equal": all(torch.equal(fresh_moments[k], moments[k])
                                 for k in ("exp_avg", "exp_avg_sq")),
            "table": params["embedding"]["table"], "mu": opt_state["mu"]["embedding"]["table"]}


def _positional_case():
    mesh = make_mesh(1, 2, device_type="cpu")
    vocab = 60
    ids = np.random.default_rng(8).integers(0, vocab, size=(5, SEQ)).astype(np.int32)
    ids[:, 6:] = 0
    model = _model(vocab, seed=2, kind="positional").eval()
    whole = model.encode(_t(ids)).detach().numpy()
    shard_params(model, mesh, shard_vocab=True)
    with torch.no_grad():
        sharded = model.encode(_t(ids), embed_fn=make_sharded_embed_fn(mesh)).numpy()
    return {"whole": whole, "sharded": sharded}


def _train_model_case(workdir):
    config = json.loads((workdir / "config.json").read_text())
    train_model({**config, "mesh": {"data": 2, "model": 2},
                 "checkpoint_dir": str(workdir / "mesh_ckpt"),
                 "log_dir": str(workdir / "mesh_logs")}, seed=3, device="cpu")
    # the single process's checkpoint, resumed under the mesh for one epoch
    state, _ = train_model({**config, "mesh": {"data": 2, "model": 2}, "epochs": 3,
                            "resume": str(workdir / "single_ckpt" / "best_model"),
                            "checkpoint_dir": str(workdir / "resumed_ckpt"),
                            "log_dir": str(workdir / "resumed_logs")}, seed=3, device="cpu")
    return {"step": state.step}


def _world_checks(world, workdir):
    checks = {"mesh": lambda: _mesh_checks(world)}
    for shape in MESHES[world]:
        for loss in LOSSES:
            checks[f"step{shape}{loss}"] = lambda shape=shape, loss=loss: _step_case(shape, loss)
    if world == 2:
        checks["positional"] = _positional_case
        return checks
    checks.update({
        "embed2": lambda: _embed_case(2), "embed4": lambda: _embed_case(4),
        "embed_grad": _embed_grad_case,
        "negs": lambda: _global_negatives_case((4, 1), pad=False, grad=False),
        "negs_pad": lambda: _global_negatives_case((4, 1), pad=True, grad=False),
        "negs_grad": lambda: _global_negatives_case((2, 2), pad=False, grad=True),
        "topk": lambda: _topk_case(False), "topk_ties": lambda: _topk_case(True),
        "converge": lambda: _losses_over_steps(50, 15),
        "uneven": lambda: _losses_over_steps(51, 10),
        "placement": _placement_case,
        "eval_in_batch": lambda: _eval_case("in_batch"),
        "eval_triplet": lambda: _eval_case("triplet"),
        "checkpoint": lambda: _checkpoint_case(workdir),
        "train_model": lambda: _train_model_case(workdir),
    })
    return checks


def _rank_main(rank, world, workdir):
    for name, check in _world_checks(world, workdir).items():
        out = check()
        np.savez(workdir / f"{name}.r{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})


class Ranks:
    """The results the ranks of one spawned group wrote."""

    def __init__(self, workdir: Path):
        self.workdir = workdir

    def __call__(self, name: str, rank: int = 0):
        with np.load(self.workdir / f"{name}.r{rank}.npz") as data:
            return {k: data[k] for k in data.files}


def _write_train_data(workdir: Path) -> dict:
    rng = np.random.default_rng(12)
    words = [f"w{i}" for i in range(90)]
    with open(workdir / "triplets.tsv", "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for _ in range(40):
            q = rng.choice(words, size=6)
            p = np.where(rng.random(6) < 0.3, rng.choice(words, size=6), q)
            f.write(f"{' '.join(q)}\t{' '.join(p)}\t{' '.join(rng.choice(words, size=5))}\n")
    config = {"data": str(workdir / "triplets.tsv"), "val_data": str(workdir / "triplets.tsv"),
              "batch_size": 16, "epochs": 2,
              "tokeniser": {"type": "word", "max_len": 8},
              "embedding": {"type": "lookup", "embedding_dim": DIM},
              "encoder": {"arch": "mean", "hidden_dim": HID, "tied_weights": True},
              "loss": {"type": "triplet", "margin": 0.2}, **OPT}
    (workdir / "config.json").write_text(json.dumps(config))
    return config


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    """The single-process train_model runs that the mesh runs are held
    against; written before the ranks start (they resume from one)."""
    workdir = tmp_path_factory.mktemp("world4")
    config = _write_train_data(workdir)
    state, _ = train_model({**config, "checkpoint_dir": str(workdir / "single_ckpt"),
                            "log_dir": str(workdir / "single_logs")}, seed=3, device="cpu")
    resumed, _ = train_model({**config, "epochs": 3,
                              "resume": str(workdir / "single_ckpt" / "best_model"),
                              "checkpoint_dir": str(workdir / "single_resumed_ckpt"),
                              "log_dir": str(workdir / "single_resumed_logs")},
                             seed=3, device="cpu")
    return workdir, state, resumed


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("world2")
    spawn_ranks(_rank_main, 2, workdir)
    return Ranks(workdir)


@pytest.fixture(scope="module")
def world4(single_runs):
    workdir = single_runs[0]
    spawn_ranks(_rank_main, 4, workdir)
    return Ranks(workdir)


# ---- the JAX package's side -----------------------------------------------------

def _jax_params(model):
    import jax.numpy as jnp
    import jax

    return jax.tree_util.tree_map(jnp.asarray, params_to_jax(model))


def _jax_spec(vocab=VOCAB, kind="lookup"):
    from twotowers_tpu.models.towers import spec_from_config as jax_spec_from_config

    return jax_spec_from_config(_config(kind), vocab)


def _jax_step(shape, loss):
    import jax
    from twotowers_tpu.models import build_loss as jax_build_loss
    from twotowers_tpu.parallel import make_mesh as jax_mesh
    from twotowers_tpu.parallel import (
        create_sharded_train_state as jax_state, make_sharded_train_step as jax_train_step,
        shard_batch as jax_shard_batch)
    from twotowers_tpu.train import build_optimizer as jax_build_optimizer

    mesh = jax_mesh(*shape)
    opt = jax_build_optimizer(OPT)
    step = jax_train_step(_jax_spec(), jax_build_loss(loss), opt, mesh)
    state = jax_state(_jax_params(_model()), opt, mesh, rng=jax.random.PRNGKey(9))
    q, p, n, w = _batch()
    state, metrics = step(state, *jax_shard_batch(mesh, q, p, _negatives(loss, n), w))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, state.params))


# ---- mesh -----------------------------------------------------------------------

class TestMesh:
    def test_default_all_data(self, world2, world4):
        assert tuple(world2("mesh")["default"]) == (2, 1)
        assert tuple(world4("mesh")["default"]) == (4, 1)

    def test_2d_mesh(self, world4):
        for rank in range(4):
            got = world4("mesh", rank)
            assert tuple(got["2d"]) == (2, 2)
            assert tuple(got["coord"]) == divmod(rank, 2)  # rank = d * model + m

    def test_submesh_allowed(self, world4):
        for rank in range(4):
            got = world4("mesh", rank)
            assert tuple(got["sub"]) == (1, 3)
            assert tuple(got["sub_coord"]) == ((0, rank) if rank < 3 else (-1, -1))

    def test_oversized_mesh_raises(self, world4):
        got = world4("mesh")
        assert "needs more than the 4 devices" in str(got["oversized"])
        assert "torchrun" in str(got["oversized"])
        assert "not divisible by model=3" in str(got["indivisible"])

    def test_no_process_group_names_torchrun(self):
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
            make_mesh(2, 1, device_type="cpu")

    def test_single_process_initialize_is_a_no_op(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert initialize_distributed(device_type="cpu") is None
        assert not dist.is_initialized()

    @pytest.mark.parametrize("device_type,local_ranks,cards,backend", [
        ("cpu", 4, 0, "gloo"), ("cuda", 4, 1, "gloo"), ("cuda", 1, 1, "nccl"),
        ("cuda", 4, 4, "nccl")])
    def test_backend_rule(self, monkeypatch, device_type, local_ranks, cards, backend):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        assert choose_backend(device_type, local_ranks) == backend


# ---- the row-sharded lookup -----------------------------------------------------

class TestShardedEmbedding:
    @pytest.mark.parametrize("model_axis", [2, 4])
    def test_matches_dense_gather(self, world4, model_axis):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        from twotowers_tpu.parallel import (
            pad_table_for_sharding as jax_pad, sharded_embed_ids as jax_embed)

        rng = np.random.default_rng(3)
        table = rng.normal(size=(20, 8)).astype(np.float32)
        ids = rng.integers(0, 20, size=(8, 6)).astype(np.int32)
        mesh = jax_mesh(data=4 // model_axis, model=model_axis)
        want = np.asarray(jax.jit(lambda t, i: jax_embed(t, i, mesh))(
            jax.device_put(jax_pad(table, model_axis), NamedSharding(mesh, P("model", None))),
            jax.device_put(ids, NamedSharding(mesh, P("data", None)))))
        rows = 8 // (4 // model_axis)
        for rank in range(4):
            got = world4(f"embed{model_axis}", rank)
            block = slice(int(got["d"]) * rows, (int(got["d"]) + 1) * rows)
            np.testing.assert_array_equal(got["out"], table[ids[block]])
            np.testing.assert_array_equal(got["out"], want[block])

    def test_gradient_is_local_scatter_add(self, world4):
        import jax
        import jax.numpy as jnp
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        from twotowers_tpu.parallel import sharded_embed_ids as jax_embed

        rng = np.random.default_rng(4)
        table = rng.normal(size=(16, 4)).astype(np.float32)
        ids = rng.integers(0, 16, size=(4, 3)).astype(np.int32)
        mesh = jax_mesh(data=2, model=2)
        want = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(jax_embed(t, ids, mesh) ** 2)))(jnp.asarray(table)))
        dense = np.zeros_like(table)
        np.add.at(dense, ids.reshape(-1), 2 * table[ids.reshape(-1)])
        for rank in range(4):
            got = world4("embed_grad", rank)["grad"]
            np.testing.assert_allclose(got, dense, **F32)
            np.testing.assert_allclose(got, want, **F32)

    def test_positional_term_kept_where_jax_drops_it(self, world2):
        """A deviation on purpose: under model=2 the JAX package's sharded
        lookup replaces ``embed_ids`` and loses the learned positions; the
        port's adds them, so its sharded encode is its unsharded one and
        JAX's unsharded one."""
        import jax
        from twotowers_tpu.models.towers import encode as jax_encode
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        from twotowers_tpu.parallel import make_sharded_embed_fn as jax_embed_fn

        ids = np.random.default_rng(8).integers(0, 60, size=(5, SEQ)).astype(np.int32)
        ids[:, 6:] = 0
        params, spec = _jax_params(_model(60, seed=2, kind="positional")), _jax_spec(60,
                                                                                  "positional")
        jax_whole = np.asarray(jax_encode(params, spec, ids))
        embed_fn = jax_embed_fn(jax_mesh(data=1, model=2))
        jax_sharded = np.asarray(jax.jit(
            lambda p, i: jax_encode(p, spec, i, embed_fn=embed_fn))(params, ids))
        assert np.abs(jax_sharded - jax_whole).max() > 1e-3  # the reference's fault
        for rank in range(2):
            got = world2("positional", rank)
            np.testing.assert_allclose(got["sharded"], got["whole"], **F32)
            np.testing.assert_allclose(got["sharded"], jax_whole, **F32)


# ---- global negatives ------------------------------------------------------------

class TestGlobalNegatives:
    def _jax(self, pad):
        import jax
        import jax.numpy as jnp
        from twotowers_tpu.models.losses import in_batch_sampled_softmax_loss
        from twotowers_tpu.parallel import global_in_batch_loss as jax_global
        from twotowers_tpu.parallel import make_mesh as jax_mesh

        rng = np.random.default_rng(5)
        q, d = _unit(rng, 16, 8), _unit(rng, 16, 8)
        w = np.ones(16, np.float32)
        if pad:
            w[12:] = 0.0
        mesh = jax_mesh(data=4, model=1)
        sharded = jax.jit(lambda q, d, w: jax_global(q, d, w, mesh, 0.1))(q, d, w)
        local = in_batch_sampled_softmax_loss(jnp.asarray(q), jnp.asarray(d), jnp.asarray(w),
                                              temperature=0.1)
        return sharded, local

    @pytest.mark.parametrize("pad", [False, True], ids=["all_real", "pad_rows_excluded"])
    def test_matches_single_device_in_batch(self, world4, pad):
        for (loss, aux) in self._jax(pad):
            for rank in range(4):
                got = world4("negs_pad" if pad else "negs", rank)
                np.testing.assert_allclose(got["loss"], float(loss), **F32)
                np.testing.assert_allclose(got["pos"], float(aux["pos_similarity"]), **F32)
                np.testing.assert_allclose(got["neg"], float(aux["neg_similarity"]), rtol=1e-5,
                                           atol=1e-6)

    def test_gradients_flow_through_all_gather(self, world4):
        import jax
        import jax.numpy as jnp
        from twotowers_tpu.models.losses import in_batch_sampled_softmax_loss
        from twotowers_tpu.parallel import global_in_batch_loss as jax_global
        from twotowers_tpu.parallel import make_mesh as jax_mesh

        rng = np.random.default_rng(5)
        q, d = (jnp.asarray(rng.normal(size=(8, 4)).astype(np.float32)) for _ in range(2))
        w = jnp.ones(8, jnp.float32)
        mesh = jax_mesh(data=2, model=1)
        g_global = jax.jit(jax.grad(lambda d: jax_global(q, d, w, mesh, 0.1)[0]))(d)
        g_local = jax.grad(lambda d: in_batch_sampled_softmax_loss(q, d, w, temperature=0.1)[0])(d)
        for rank in range(4):
            got = world4("negs_grad", rank)
            np.testing.assert_allclose(got["grad"], np.asarray(g_global), **F32)
            np.testing.assert_allclose(got["grad"], np.asarray(g_local), **F32)


# ---- the top-k merge -------------------------------------------------------------

class TestShardedTopKMerge:
    @pytest.mark.parametrize("ties", [False, True], ids=["exact_merge", "ties_to_lower_index"])
    def test_exact_merge(self, world4, ties):
        import jax

        rng = np.random.default_rng(6)
        dense = (rng.integers(0, 4, size=(3, 256)) if ties else rng.normal(size=(3, 256)))
        dense = dense.astype(np.float32)
        want_s, want_i = (np.asarray(a) for a in jax.lax.top_k(dense, 5))
        np.testing.assert_array_equal(want_i, np.argsort(-dense, axis=1, kind="stable")[:, :5])
        for rank in range(4):
            got = world4("topk_ties" if ties else "topk", rank)
            np.testing.assert_array_equal(got["scores"], want_s)
            np.testing.assert_array_equal(got["indices"], want_i)


# ---- the sharded train step --------------------------------------------------------

class TestShardedTrainStep:
    @pytest.mark.parametrize("shape,world", [((2, 1), 2), ((1, 2), 2), ((2, 2), 4)])
    @pytest.mark.parametrize("loss", LOSSES)
    def test_matches_jax_sharded_step(self, request, shape, world, loss):
        """One step from the same weights on the same batch of 13 (vocab
        51 split unevenly where model=2): the loss, the five metrics, the
        updated towers and the unpadded table."""
        ranks = request.getfixturevalue(f"world{world}")
        want, params = _jax_step(shape, loss)
        got = ranks(f"step{shape}{loss}")
        for key in ("loss", "pos_similarity", "neg_similarity", "similarity_diff", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **F32)
        for key in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(got[key], params["query_tower"][key], err_msg=key,
                                       **PARAMS_TOL)
        np.testing.assert_allclose(got["table"], params["embedding"]["table"][:VOCAB],
                                   **PARAMS_TOL)

    def test_table_sharding_preserved_after_step(self, world2, world4):
        for rank in range(2):
            assert int(world2("step(1, 2)triplet", rank)["local_rows"]) == 26
            assert int(world2("step(2, 1)triplet", rank)["local_rows"]) == VOCAB
        for rank in range(4):
            assert int(world4("step(2, 2)triplet", rank)["local_rows"]) == 26

    def test_multiple_steps_converge(self, world4):
        losses = world4("converge")["losses"]
        assert losses[-1] < losses[0]


# ---- feeds, eval, checkpoints, the loop and the runner -------------------------------

class TestMultiHostPaths:
    def test_per_process_placement_matches_jax(self, world4):
        """Each rank's rows of a batch of 13 are the JAX package's shards
        of the same batch on the device at its mesh coordinate."""
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        from twotowers_tpu.parallel import shard_batch as jax_shard_batch

        mesh = jax_mesh(data=2, model=2)
        placed = jax_shard_batch(mesh, *_batch(n=13, seq=12, vocab=50), per_process=True)
        for rank in range(4):
            got = world4("placement", rank)
            device = mesh.devices[tuple(int(c) for c in got["coord"])]
            for i, array in enumerate(placed):
                shard = next(s for s in array.addressable_shards if s.device == device)
                np.testing.assert_array_equal(got[f"a{i}"], np.asarray(shard.data))

    @pytest.mark.parametrize("loss", ["in_batch", "triplet"])
    def test_sharded_eval_matches_unsharded(self, world4, loss):
        from twotowers_tpu.models import build_loss as jax_build_loss
        from twotowers_tpu.train.step import make_eval_step as jax_eval_step

        q, p, n, w = _batch(seed=7, n=16, seq=12)
        want = jax_eval_step(_jax_spec(), jax_build_loss(loss))(
            _jax_params(_model(seed=3)), q, p, _negatives(loss, n), w)
        for rank in range(4):
            got = world4(f"eval_{loss}", rank)
            for key in ("loss", "pos_similarity", "neg_similarity", "similarity_diff"):
                np.testing.assert_allclose(got[key], float(want[key]), err_msg=key, **F32)

    def test_sharded_checkpoint_roundtrip(self, world4):
        """Under an uneven split (vocab 51 over 2 shards) rank 0 writes the
        whole, unpadded table; every rank reads it back into a fresh
        sharded state bit for bit, and a single process loads it."""
        for rank in range(4):
            got = world4("checkpoint", rank)
            assert got["table_equal"] and got["w1_equal"] and got["moments_equal"]
        tree, _ = load_checkpoint(str(world4.workdir / "ckpt" / "sharded"))
        assert tree["params"]["embedding"]["table"].shape == (VOCAB, DIM)
        np.testing.assert_array_equal(tree["params"]["embedding"]["table"],
                                      world4("checkpoint")["table"])
        model = load_params(_model(), tree["params"])
        optimizer = build_optimizer(OPT).build(model.parameters())
        opt_state_from_jax(tree["opt_state"], model, optimizer)
        np.testing.assert_array_equal(optimizer.state[model.embedding.table]["exp_avg"].numpy(),
                                      world4("checkpoint")["mu"])

    def test_jax_cannot_load_its_uneven_split_checkpoint(self, tmp_path):
        """The reference's fault, left in it: under an uneven split the JAX
        package saves the padded table, and its own ``load_trained_model``
        (an unpadded template) refuses it. The port saves the unpadded
        table (the test above)."""
        import jax
        from twotowers_tpu.parallel import create_sharded_train_state as jax_state
        from twotowers_tpu.parallel import make_mesh as jax_mesh
        from twotowers_tpu.train import build_optimizer as jax_build_optimizer
        from twotowers_tpu.train.checkpoint import load_trained_model as jax_load
        from twotowers_tpu.train.checkpoint import save_checkpoint as jax_save
        from twotowers_tpu_torch.tokenizers import CharTokenizer

        tok = CharTokenizer().fit(["abcdefghij klmnopq", "rstuvw xyz"])  # vocab 28
        config = {**_config(), **OPT}
        model = TwoTower(spec_from_config(config, tok.vocab_size))
        opt = jax_build_optimizer(OPT)
        state = jax_state(_jax_params(model), opt, jax_mesh(data=2, model=3))
        assert state.params["embedding"]["table"].shape == (30, DIM)
        path = jax_save({"params": state.params, "opt_state": state.opt_state},
                        str(tmp_path), tokenizer_state=tok.state_dict(), config=config)
        with pytest.raises(ValueError, match="not compatible with the stored shape"):
            jax_load(path)

    def test_uneven_vocab_split_step(self, world4):
        losses = world4("uneven")["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]

    def test_mesh_and_single_device_losses_close(self, single_runs, world4):
        """train_model under mesh {data: 2, model: 2} against the port's
        single process from the same seed: the steps, the epoch losses and
        the trained weights; rank 0 alone wrote the metrics and checkpoints."""
        workdir, single, _ = single_runs

        def epoch_metrics(logs):
            (path,) = (workdir / logs).glob("*_metrics.jsonl")
            records = [json.loads(line) for line in path.read_text().splitlines()]
            return [[r[key] for r in records if key in r]
                    for key in ("train/epoch_loss", "val/loss", "val/pos_similarity")]

        # the epoch losses, and val_data: through the sharded eval step
        mesh_metrics = epoch_metrics("mesh_logs")
        assert [len(m) for m in mesh_metrics] == [2, 2, 2]
        np.testing.assert_allclose(mesh_metrics, epoch_metrics("single_logs"), **F32)
        mesh_model, _, _, _ = load_trained_model(str(workdir / "mesh_ckpt" / "best_model"),
                                                 device="cpu")
        assert mesh_model.embedding.table.shape == single.model.embedding.table.shape
        for (name, a), b in zip(mesh_model.named_parameters(), single.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), err_msg=name,
                                       rtol=0, atol=1e-5)  # a hundredth of lr 1e-3
        assert len(list((workdir / "mesh_ckpt").iterdir())) == \
            len(list((workdir / "single_ckpt").iterdir()))

    def test_checkpoint_of_one_process_resumes_under_a_mesh(self, single_runs, world4):
        workdir, _, resumed = single_runs
        assert int(world4("train_model")["step"]) == resumed.step == 9
        mesh_model, _, _, _ = load_trained_model(str(workdir / "resumed_ckpt" / "best_model"),
                                                 device="cpu")
        for (name, a), b in zip(mesh_model.named_parameters(), resumed.model.parameters()):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), err_msg=name,
                                       rtol=0, atol=1e-5)

    def test_scripts_train_under_torchrun(self, tmp_path):
        """``torchrun --standalone`` (a free port) starts 2 ranks of the
        runner on a ``mesh: {data: 2}`` config; rank 0 alone writes the run
        directory and the group JSON."""
        config = _write_train_data(tmp_path)
        config.update(mesh={"data": 2}, epochs=1, checkpoint_dir=str(tmp_path / "ckpt"))
        (tmp_path / "mesh.json").write_text(json.dumps(config))
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "twotowers_tpu_torch.scripts.train",
             "--config", str(tmp_path / "mesh.json"), "--device", "cpu",
             "--log_dir", str(tmp_path / "logs")],
            cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs = [p for p in (tmp_path / "logs").iterdir() if p.is_dir()]
        groups = list((tmp_path / "logs").glob("experiment_group_*.json"))
        assert len(runs) == 1 and len(groups) == 1
        assert json.loads(groups[0].read_text())["succeeded"] == 1
        assert (tmp_path / "ckpt" / "best_model" / "params.npz").exists()


# ---- the card's rule for the model axis ------------------------------------------

CARD = 80 * 2**30  # an H100's 80 GiB


class TestRecommendModelParallelism:
    """Smallest power of two whose table shard, with its f32 gradient and
    two Adam moments, fits a quarter of the card's memory."""

    def test_small_vocab_stays_unsharded(self):
        assert recommend_model_parallelism(32_768, 64, max_shards=8, device_bytes=CARD) == 1
        assert recommend_model_parallelism(102_400, 64, max_shards=8, device_bytes=CARD) == 1

    def test_word_scale_vocab_wants_4way(self):
        # 50M x 256: 205 GB of table state; a quarter of 80 GiB holds 21.5 GB
        assert recommend_model_parallelism(50_000_000, 256, max_shards=16,
                                           device_bytes=CARD) == 16
        assert recommend_model_parallelism(12_000_000, 256, max_shards=16,
                                           device_bytes=CARD) == 4

    def test_caps_at_max_shards(self):
        assert recommend_model_parallelism(50_000_000, 256, max_shards=2,
                                           device_bytes=CARD) == 2

    @pytest.mark.parametrize("vocab", [96, 8_192, 1_000_000, 12_000_000, 40_000_000])
    def test_smallest_power_of_two_that_fits(self, vocab):
        from twotowers_tpu_torch.parallel.mesh import TABLE_STATE_COPIES, TABLE_STATE_SHARE

        def fits(shards):
            return TABLE_STATE_COPIES * -(-vocab // shards) * 256 * 4 <= TABLE_STATE_SHARE * CARD

        shards = recommend_model_parallelism(vocab, 256, max_shards=64, device_bytes=CARD)
        assert shards & (shards - 1) == 0 and fits(shards)
        assert shards == 1 or not fits(shards // 2)


def test_param_specs_row_shard_only_the_table():
    specs = param_specs(_model(), shard_vocab=True)
    assert specs.pop("embedding.table") == (MODEL_AXIS, None)
    assert specs and set(specs.values()) == {()}
    assert set(param_specs(_model(), shard_vocab=False).values()) == {()}


# ---- the kernels' build across processes ------------------------------------------

_BUILD_SCRIPT = """
import sys
from pathlib import Path
from twotowers_tpu_torch.kernels import build
root = Path(sys.argv[1])
build.CSRC_DIR, build.BUILD_DIR = root / "csrc", root / "build"
print(build.build(["fake"]))
"""

_FAKE_NVCC = """#!/bin/sh
# records its run, takes a while, and writes the file that -o names
echo "start $$" >> "$NVCC_LOG"
sleep 1
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
echo "end $$" >> "$NVCC_LOG"
"""


def test_concurrent_builds_run_nvcc_once(tmp_path):
    """Two processes that find one stale library at once: the file lock
    lets one run nvcc, and the other finds the library fresh."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake.cu").write_text("// fake\n")
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    env = {**os.environ, "CUDA_HOME": str(tmp_path / "cuda"),
           "NVCC_LOG": str(tmp_path / "nvcc.log"),
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(2)]
    seconds = sorted(float(p.communicate(timeout=120)[0].split()[-1]) for p in procs)
    assert [p.returncode for p in procs] == [0, 0]
    log = (tmp_path / "nvcc.log").read_text().split()
    assert log[0::2] == ["start", "end"]  # one run, never two at once
    assert seconds[0] == 0.0 and seconds[1] >= 1.0
    assert (tmp_path / "build" / "libfake.so").read_text() == "lib\n"
