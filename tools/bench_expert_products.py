#!/usr/bin/env python
"""Time the held experts' SwiGLU products of ``models/moe.py`` two ways on
one CUDA card: ``ExpertProducts`` (one ``torch._grouped_mm`` a product, the
segments' ends on the device), against a loop of library GEMMs over the
same segments (their lengths read on the host), forward and backward.

    python3 tools/bench_expert_products.py [--rows 12288 73728 86016] [--seed 0]

Shapes are those of ``train-moonlight-b512``'s expert layer: 8 held
experts, rows of width 2,048, expert width 1,408, bf16; ``--rows`` are the
held token-expert pairs of a call (12,288 and 73,728 are a query call's
and a passage call's under uniform routing), split into 8 uneven segments.
Both ways compute the SiLU gate in f32 as ``ExpertProducts`` does; the
line says whether their outputs and gradients are the same bits. One JSON
line a size, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from twotowers_tpu_torch.models.moe import ExpertProducts, _silu_gate, _silu_gate_grad  # noqa: E402

HELD, DIM, INNER = 8, 2048, 1408


def loop_forward(rows, w_gate_up, w_down, lengths):
    """``ExpertProducts.forward`` by a GEMM a segment: (out, h), h kept for
    the backward as the grouped call keeps it."""
    h = rows.new_empty(rows.shape[0], w_gate_up.shape[-1])
    out = torch.empty_like(rows)
    start = 0
    for e, n in enumerate(lengths):
        torch.matmul(rows[start:start + n], w_gate_up[e], out=h[start:start + n])
        torch.matmul(_silu_gate(h[start:start + n]), w_down[e], out=out[start:start + n])
        start += n
    return out, h


def loop_backward(rows, h, w_gate_up, w_down, lengths, grad):
    """``ExpertProducts.backward`` by a GEMM a segment: the gate recomputed
    from h, as the grouped call recomputes it."""
    act = _silu_gate(h)
    d_rows = torch.empty_like(rows)
    d_gate_up, d_down = torch.empty_like(w_gate_up), torch.empty_like(w_down)
    start = 0
    for e, n in enumerate(lengths):
        x, g = rows[start:start + n], grad[start:start + n]
        torch.matmul(act[start:start + n].t(), g, out=d_down[e])
        d_h = _silu_gate_grad(h[start:start + n], g @ w_down[e].t())
        torch.matmul(d_h, w_gate_up[e].t(), out=d_rows[start:start + n])
        torch.matmul(x.t(), d_h, out=d_gate_up[e])
        start += n
    return d_rows, d_gate_up, d_down


def loop_products(rows, w_gate_up, w_down, lengths, grad):
    """The forward and backward of ``ExpertProducts`` by a GEMM a segment,
    with the same work: the forward keeps h, the backward recomputes the
    gate from it."""
    out, h = loop_forward(rows, w_gate_up, w_down, lengths)
    return (out, *loop_backward(rows, h, w_gate_up, w_down, lengths, grad))


def grouped_products(rows, w_gate_up, w_down, offsets, grad):
    rows, w_gate_up, w_down = (t.detach().requires_grad_() for t in (rows, w_gate_up, w_down))
    out = ExpertProducts.apply(rows, w_gate_up, w_down, offsets, 0, rows.shape[0])
    out.backward(grad)
    return out.detach(), rows.grad, w_gate_up.grad, w_down.grad


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[12_288, 73_728, 86_016])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    w_gate_up = (torch.rand(HELD, DIM, 2 * INNER, device=dev, generator=gen) - 0.5) * DIM ** -0.5
    w_down = (torch.rand(HELD, INNER, DIM, device=dev, generator=gen) - 0.5) * INNER ** -0.5
    w_gate_up, w_down = w_gate_up.bfloat16(), w_down.bfloat16()
    for a in args.rows:
        share = torch.rand(HELD, device=dev, generator=gen) + 0.5  # uneven: 1 to 3 x apart
        lengths = (share / share.sum() * a).long()
        lengths[-1] += a - int(lengths.sum())
        offsets = lengths.cumsum(0).to(torch.int32)
        rows = torch.randn(a, DIM, device=dev, generator=gen).bfloat16()
        grad = torch.randn(a, DIM, device=dev, generator=gen).bfloat16() * 1e-2
        host = lengths.tolist()
        grouped = grouped_products(rows, w_gate_up, w_down, offsets, grad)
        loop = loop_products(rows, w_gate_up, w_down, host, grad)
        same = all(torch.equal(x, y) for x, y in zip(grouped, loop))
        gap = max(float((x.float() - y.float()).abs().max()) for x, y in zip(grouped, loop))
        grouped_ms = [cuda_ms(lambda: grouped_products(rows, w_gate_up, w_down, offsets, grad))
                      for _ in range(2)]
        loop_ms = [cuda_ms(lambda: loop_products(rows, w_gate_up, w_down,
                                                  lengths.tolist(), grad)) for _ in range(2)]
        bound_ms = 18 * a * DIM * INNER / 989e12 * 1e3  # 3 products forward, 6 backward
        print(json.dumps({"rows": a, "segments": host, "grouped_ms": grouped_ms,
                          "loop_ms": loop_ms, "bound_ms": bound_ms, "same_bits": same,
                          "max_abs_gap": gap}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
