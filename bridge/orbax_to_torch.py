#!/usr/bin/env python
"""Convert checkpoints of the JAX package into the PyTorch port's layout.

The JAX package (``twotowers_tpu``) writes a checkpoint directory as an
orbax ``state/`` (params and optax state) beside a ``meta.json``; the port
(``twotowers_tpu_torch``) reads ``params.npz`` + ``opt_state.npz`` +
``meta.json``, the same trees under ``/``-joined paths. This script restores
the orbax state through the JAX package's own ``load_checkpoint``, with the
template its ``load_trained_model`` builds from ``meta.json``, and writes
the port's files:

* ``params.npz``: the param tree as it is (the port keeps the JAX layout,
  the transformer's ``layers`` list included);
* ``opt_state.npz``: optax's adam / adamw state as ``count``, ``mu/...``,
  ``nu/...``, or sgd's ``trace/...`` (a frozen table keeps its zero
  moments), what ``twotowers_tpu_torch.convert.opt_state_from_jax`` reads;
* ``meta.json``: SRC's, byte for byte.

A checkpoint written under a ``mesh:`` whose model axis does not divide the
vocabulary holds the table padded to a multiple of it
(``twotowers_tpu/parallel/sharding.py:pad_table_for_sharding``); its rows
and moments are cut back to the tokenizer's vocabulary, the port's whole
layout. The port loads the result as a checkpoint of its own
(``load_trained_model``, ``resume:``), which this script checks on the CPU
before it returns.

SRC is one checkpoint directory (``best_model``, ``two_tower_*_epochN``) or
a directory of them (a ``checkpoint_dir``): then each one found goes to the
same name under DST.

``--to-orbax`` goes the way back: a checkpoint of the port (``params.npz``,
``opt_state.npz``, ``meta.json``) becomes an orbax ``state/`` with optax's
state for the config's optimizer, which the JAX package's
``load_trained_model`` and ``resume:`` read.

Usage:
    python bridge/orbax_to_torch.py SRC DST
    python bridge/orbax_to_torch.py --to-orbax SRC DST

Only this directory and the parity tests import both packages; nothing in
``twotowers_tpu_torch`` imports it.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Any, Dict, List, Tuple

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import jax  # noqa: E402
import numpy as np  # noqa: E402

META_FILE = "meta.json"


def is_orbax_checkpoint(path: Path) -> bool:
    """A directory the JAX package's ``save_checkpoint`` wrote."""
    return (path / "state").is_dir() and (path / META_FILE).is_file()


def checkpoints_under(src: Path) -> List[Path]:
    """``src`` itself if it is a checkpoint, else its checkpoint children."""
    if is_orbax_checkpoint(src):
        return [src]
    found = sorted(p for p in src.iterdir() if p.is_dir() and is_orbax_checkpoint(p))
    if not found:
        raise FileNotFoundError(f"{src} holds no checkpoint of the JAX package "
                                f"(a directory with state/ and {META_FILE})")
    return found


def _stored_table_rows(path: Path) -> int:
    """Rows of the embedding table as orbax stored it (padded under an
    uneven ``mesh:`` split)."""
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().metadata(path / "state").item_metadata
    return int(tree["params"]["embedding"]["table"].shape[0])


def _pad_table(tree: Dict[str, Any], rows: int) -> Dict[str, Any]:
    """``tree`` (a param-shaped dict) with its embedding table zero-padded to
    ``rows``, as ``pad_table_for_sharding`` leaves it."""
    table = np.asarray(tree["embedding"]["table"])
    padded = np.zeros((rows,) + table.shape[1:], table.dtype)
    padded[: table.shape[0]] = table
    return {**tree, "embedding": {**tree["embedding"], "table": padded}}


def _adam_or_trace(opt_state: Any) -> Dict[str, Any]:
    """The moments of optax's chain: the ``ScaleByAdamState`` (adam, adamw)
    or the ``TraceState`` (sgd), wherever a ``chain`` nests it."""
    fields = getattr(opt_state, "_fields", None)
    if fields and {"count", "mu", "nu"} <= set(fields):
        return {"count": opt_state.count, "mu": opt_state.mu, "nu": opt_state.nu}
    if fields and "trace" in fields:
        return {"trace": opt_state.trace}
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            try:
                return _adam_or_trace(item)
            except ValueError:
                continue
    raise ValueError(f"no adam or sgd state in the optimizer state {type(opt_state)!r}")


def _host(tree: Any) -> Any:
    return jax.tree_util.tree_map(lambda leaf: np.array(leaf), tree)


def _cut_table(tree: Dict[str, Any], rows: int) -> Dict[str, Any]:
    table = tree["embedding"]["table"]
    return {**tree, "embedding": {**tree["embedding"], "table": table[:rows]}}


def restore(src: Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``({"params", "opt_state"}, meta)`` of a JAX checkpoint, numpy trees
    in the port's layout with the table cut to the vocabulary."""
    from twotowers_tpu.models.towers import init_two_tower, spec_from_config
    from twotowers_tpu.tokenizers import tokenizer_from_state
    from twotowers_tpu.train import build_optimizer
    from twotowers_tpu.train.checkpoint import load_checkpoint, load_metadata

    meta = load_metadata(str(src))
    if not meta.get("tokenizer") or meta.get("config") is None:
        raise ValueError(f"Checkpoint {src} lacks tokenizer/config metadata")
    config = meta["config"]
    vocab = tokenizer_from_state(meta["tokenizer"]).vocab_size
    spec = spec_from_config(config, vocab_size=vocab)
    params = init_two_tower(jax.random.PRNGKey(0), spec)
    rows = _stored_table_rows(src)
    if rows != vocab:
        if rows < vocab:
            raise ValueError(f"{src}: a table of {rows} rows for a vocabulary of {vocab}")
        params = _pad_table(_host(params), rows)
    optimizer = build_optimizer(config)
    template = {"params": params, "opt_state": optimizer.init(params)}
    state, _ = load_checkpoint(str(src), template)

    moments = _adam_or_trace(state["opt_state"])
    params = _cut_table(_host(state["params"]), vocab)
    opt_state = {key: (np.asarray(value) if key == "count"
                       else _cut_table(_host(value), vocab))
                 for key, value in moments.items()}
    return {"params": params, "opt_state": opt_state}, meta


def convert_one(src: Path, dst: Path) -> Path:
    """Convert one checkpoint directory; returns ``dst``."""
    from twotowers_tpu_torch.train.checkpoint import save_arrays

    tree, _ = restore(src)
    if dst.exists():
        shutil.rmtree(dst)
    save_arrays(dst, tree)
    shutil.copyfile(src / META_FILE, dst / META_FILE)
    return dst


def check_loads(dst: Path) -> None:
    """The port rebuilds the model and its optimizer state from ``dst``
    (keys and shapes against the spec; raises on any mismatch)."""
    from twotowers_tpu_torch.convert import opt_state_from_jax
    from twotowers_tpu_torch.train import build_optimizer, load_checkpoint
    from twotowers_tpu_torch.train.checkpoint import load_trained_model
    from twotowers_tpu_torch.train.step import trainable_parameters

    model, _, _, config = load_trained_model(str(dst), device="cpu")
    tree, _ = load_checkpoint(str(dst))
    optimizer = build_optimizer(config).build(trainable_parameters(model))
    opt_state_from_jax(tree["opt_state"], model, optimizer)


def convert(src: str, dst: str) -> List[str]:
    """Convert ``src`` (a checkpoint or a directory of them) into ``dst``;
    returns the directories written."""
    src_path, dst_path = Path(src), Path(dst)
    found = checkpoints_under(src_path)
    written = []
    for path in found:
        out = dst_path if path == src_path else dst_path / path.name
        convert_one(path, out)
        check_loads(out)
        written.append(str(out))
    return written


def _like(template: Any, tree: Any) -> Any:
    """``tree``'s arrays in ``template``'s structure (the same keys; a list
    in the template may be a list or index-keyed in ``tree``); shapes must
    match."""
    def leaf(path, want):
        value = tree
        for key in path:
            value = value[key.key if hasattr(key, "key") else key.idx]
        value = np.asarray(value)
        if value.shape != np.shape(want):
            raise ValueError(f"{jax.tree_util.keystr(path)}: shape {value.shape} "
                             f"!= {np.shape(want)}")
        return value
    return jax.tree_util.tree_map_with_path(leaf, template)


def _with_moments(opt_state: Any, params: Any, moments: Dict[str, Any]) -> Any:
    """optax's chain state with its ``ScaleByAdamState`` / ``TraceState``
    taken from the port's ``count``, ``mu``, ``nu`` or ``trace``."""
    fields = getattr(opt_state, "_fields", None)
    if fields and set(moments) <= set(fields):
        return opt_state._replace(**{
            key: np.asarray(value, np.int32) if key == "count" else _like(params, value)
            for key, value in moments.items()})
    if isinstance(opt_state, tuple) and not fields:
        return tuple(_with_moments(item, params, moments) for item in opt_state)
    return opt_state


def to_orbax(src: str, dst: str) -> str:
    """Write the port's checkpoint ``src`` as a JAX package checkpoint at
    ``dst`` (orbax ``state/`` + ``src``'s ``meta.json``); returns ``dst``."""
    import orbax.checkpoint as ocp

    from twotowers_tpu.models.towers import init_two_tower, spec_from_config
    from twotowers_tpu.tokenizers import tokenizer_from_state
    from twotowers_tpu.train import build_optimizer
    from twotowers_tpu_torch.train import load_checkpoint

    tree, meta = load_checkpoint(src)
    config = meta["config"]
    spec = spec_from_config(config, tokenizer_from_state(meta["tokenizer"]).vocab_size)
    params = _like(init_two_tower(jax.random.PRNGKey(0), spec), tree["params"])
    opt_state = build_optimizer(config).init(params)
    if tree["opt_state"] is not None:
        opt_state = _with_moments(opt_state, params, tree["opt_state"])
    out = Path(dst).resolve()
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(out / "state", {"params": params, "opt_state": opt_state})
    checkpointer.wait_until_finished()
    shutil.copyfile(Path(src) / META_FILE, out / META_FILE)
    return str(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert JAX (orbax) checkpoints into the PyTorch port's layout")
    parser.add_argument("src", help="a checkpoint directory, or a directory of them")
    parser.add_argument("dst", help="where the converted checkpoint(s) go")
    parser.add_argument("--to-orbax", action="store_true",
                        help="the way back: one checkpoint of the port into the JAX layout")
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    for path in [to_orbax(args.src, args.dst)] if args.to_orbax else convert(args.src, args.dst):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
