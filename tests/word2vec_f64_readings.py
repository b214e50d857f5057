"""Whose error is the word2vec epoch's worst weight? A reading, not a test.

For each hash salt given, in a process of that salt: one epoch (5 Adam
steps) of configs/word2vec_skipgram.yml from JAX's initial weights in JAX
(f32), in the port (f32) and in the port at float64 (every ``.float()`` kept
at f64). At the weight where the two f32 programs end farthest apart it
prints each one's distance from f64 in units of lr, its gradients at every
step against f64, both programs' gradient error over the towers, and what
optax's and torch's Adam make of the same f32 gradients.

    JAX_PLATFORMS=cpu python tests/word2vec_f64_readings.py 9 12
"""

import copy
import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _capture_grads(state, sink):
    """Record the model's gradients (JAX layout) before each optimizer step."""
    from twotowers_tpu_torch.convert import params_to_jax

    step = state.optimizer.step

    def recorded(*args, **kwargs):
        grads = copy.deepcopy(state.model)
        with torch.no_grad():
            for g, p in zip(grads.parameters(), state.model.parameters()):
                g.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        sink.append(params_to_jax(grads))
        return step(*args, **kwargs)

    state.optimizer.step = recorded


def readings(out_dir):
    import jax
    import numpy as np
    import optax
    import pytest

    from test_torch_loop import _word_tsv
    from test_torch_pretrained import LR, word2vec_config
    from test_torch_train import _np, route_jax_lookup_through_kernel
    from twotowers_tpu.train import build_optimizer as jax_build_optimizer
    from twotowers_tpu.train import build_pipeline as jax_build_pipeline
    from twotowers_tpu.train import create_train_state as jax_create_train_state
    from twotowers_tpu.train import make_train_step as jax_make_train_step
    from twotowers_tpu.train import train_epoch as jax_train_epoch
    from twotowers_tpu.train.step import _encode_for_loss as jax_encode_for_loss
    from twotowers_tpu_torch.convert import load_params, params_to_jax
    from twotowers_tpu_torch.train import (
        build_pipeline, create_train_state, make_train_step, train_epoch)

    data, _ = _word_tsv(out_dir / "train.tsv", np.random.default_rng(0), n=80)
    config = word2vec_config(out_dir, data)
    jax_grads = []
    with pytest.MonkeyPatch.context() as mp:
        route_jax_lookup_through_kernel(mp)
        jax_pipe = jax_build_pipeline(config, seed=2)
        pipe = build_pipeline(config, seed=2, device="cpu")
        load_params(pipe.model, _np(jax_pipe.params))
        initial = copy.deepcopy(pipe.model)
        jitted = jax_make_train_step(jax_pipe.spec, jax_pipe.loss_def, jax_pipe.optimizer)

        def jax_step(state, q, p, n, w):  # the step's gradients, taken eagerly
            grads, _ = jax.grad(lambda prm: jax_encode_for_loss(
                prm, jax_pipe.spec, jax_pipe.loss_def, q, p, n, w, train=True,
                dropout_rng=None), has_aux=True)(state.params)
            jax_grads.append(_np(grads))
            return jitted(state, q, p, n, w)

        jax_state = jax_create_train_state(jax_pipe.params, jax_pipe.optimizer)
        jax_state, _ = jax_train_epoch(jax_step, jax_state, jax_pipe, 16, epoch=1, seed=2)

    def port_epoch(model, sink):
        pipe.model = model
        state = create_train_state(model, pipe.optimizer, seed=2)
        _capture_grads(state, sink)
        state, _ = train_epoch(make_train_step(pipe.loss_def, pipe.optimizer), state, pipe,
                               16, epoch=1, seed=2)
        return params_to_jax(state.model)

    port_grads, f64_grads = [], []
    port = port_epoch(copy.deepcopy(initial), port_grads)
    wide = copy.deepcopy(initial).double()
    wide.spec = dataclasses.replace(wide.spec, compute_dtype=torch.float64)
    narrow = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        f64 = port_epoch(wide, f64_grads)
    finally:
        torch.Tensor.float = narrow

    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    got, want, exact = flat(port), flat(_np(jax_state.params)), flat(f64)
    key = max(got, key=lambda k: np.abs(got[k] - want[k]).max())
    at = np.unravel_index(np.abs(got[key] - want[key]).argmax(), got[key].shape)
    print(f"hash salt {os.environ.get('PYTHONHASHSEED')}: weight {key}{list(map(int, at))}")
    print(f"  |port - jax| {abs(got[key] - want[key])[at] / LR:.4f} lr; "
          f"port - f64 {abs(got[key] - exact[key])[at] / LR:.4f} lr; "
          f"jax - f64 {abs(want[key] - exact[key])[at] / LR:.4f} lr")
    for name, tree in (("port", got), ("jax", want)):
        dist = np.concatenate([np.abs(tree[k] - exact[k]).ravel() for k in tree]) / LR
        print(f"  {name} - f64 over all weights: max {dist.max():.4f} lr, mean {dist.mean():.2e} lr")
    for t, (g64, gp, gj) in enumerate(zip(map(flat, f64_grads), map(flat, port_grads),
                                          map(flat, jax_grads))):
        towers = [k for k in g64 if "table" not in k]
        errs = {name: np.concatenate([(g[k] - g64[k]).ravel() for k in towers])
                for name, g in (("port", gp), ("jax", gj))}
        small = np.concatenate([np.abs(g64[k]).ravel() < 1e-7 for k in towers])
        print(f"  step {t + 1}: gradient f64 {g64[key][at]:+.4e}, port {gp[key][at]:+.4e}, "
              f"jax {gj[key][at]:+.4e}; over the towers rms error port "
              f"{np.sqrt(np.mean(errs['port'] ** 2)):.2e} jax {np.sqrt(np.mean(errs['jax'] ** 2)):.2e}, "
              f"max |g| {max(np.abs(g64[k]).max() for k in towers):.2e}; over the {small.sum()} "
              f"below 1e-7 error mean / max port {np.abs(errs['port'][small]).mean():.2e} / "
              f"{np.abs(errs['port'][small]).max():.2e} jax {np.abs(errs['jax'][small]).mean():.2e} / "
              f"{np.abs(errs['jax'][small]).max():.2e}")
    g1, e_port, e_jax = (flat(g)[key][at] for g in (f64_grads[0], port_grads[0], jax_grads[0]))
    gain = 1e-8 / (abs(g1) + 1e-8) ** 2  # d(lr * g / (|g| + eps)) / dg, in lr, at step 1
    print(f"  step 1 alone moves it by port {gain * abs(e_port - g1):.4f} lr, "
          f"jax {gain * abs(e_jax - g1):.4f} lr")

    start = float(flat(params_to_jax(initial))[key][at])
    grads = [np.float32(flat(g)[key][at]) for g in f64_grads]
    jax_opt = jax_build_optimizer({"optimizer": {"type": "adam", "lr": LR}})
    jp = np.asarray([start], np.float32)
    js = jax_opt.init(jp)
    for g in grads:
        update, js = jax_opt.update(np.asarray([g]), js, jp)
        jp = optax.apply_updates(jp, update)
    param = torch.nn.Parameter(torch.tensor([start]))
    adam = torch.optim.Adam([param], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        param.grad = torch.tensor([g])
        adam.step()
    print(f"  optax and torch Adam on the same f32 gradients: "
          f"{abs(param.item() - float(jp[0])) / LR:.2e} lr apart")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.path[:0] = [str(HERE), str(HERE.parent)]
        import jax
        import torch

        jax.config.update("jax_platforms", "cpu")
        readings(Path(sys.argv[2]))
    else:
        for seed in sys.argv[1:] or ["9", "12"]:
            with tempfile.TemporaryDirectory() as tmp:
                subprocess.run([sys.executable, __file__, "--child", tmp], check=True,
                               env={**os.environ, "PYTHONHASHSEED": seed})
