"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--n-docs 1000000]

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  -- the card's name and power limit; no card is a failure.
2. build   -- every CUDA source of the port (one nvcc each, started
              together) and the native tokenizer, from this checkout.
3. kernels -- each kernel against its plain PyTorch version on the card at
              the main path's shapes and at edge cases, then timed beside
              the plain version, a library yardstick and its bound.
4. serve   -- the default config (char tokenizer, max_len 64, lookup
              embedding 64, mean tower 128, f32) at full width with random
              weights from the seed, over ``--n-docs`` synthetic texts:
              ``RetrievalService`` add / health / embed / 8 searches, then
              ``TwoTowerSearch`` index + one 256-query ``search_batch``
              checked against the plain version. The kernel launch counts
              are zeroed before this phase and read after it.

Then the kernel table, the nvidia-smi line and, last, the result line.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 CUDA cores; bf16 tensor cores
DEFAULT_CONFIG = {  # configs/default_config.yml, as a dict: yaml may be absent
    "data": "data/processed/classic_triplets.parquet",
    "checkpoint_dir": "checkpoints",
    "log_dir": "logs",
    "precision": "float32",
    "tokeniser": {"type": "char", "max_len": 64},
    "embedding": {"type": "lookup", "embedding_dim": 64},
    "encoder": {"arch": "mean", "hidden_dim": 128, "tied_weights": False},
    "loss": {"type": "triplet", "margin": 0.2},
    "optimizer": {"type": "adamw", "lr": 0.001},
    "batch_size": 256,
    "learning_rate": 0.001,
    "epochs": 3,
    "max_sequence_length": 64,
    "use_wandb": False,
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---- 1. device ----------------------------------------------------------------

def device_phase() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "count": torch.cuda.device_count()}
    emit("device", **card, torch=torch.__version__, cuda=torch.version.cuda)
    return card


# ---- 2. build -----------------------------------------------------------------

def build_phase() -> None:
    import twotowers_tpu_torch
    from twotowers_tpu_torch.kernels import build
    from twotowers_tpu_torch.native import tokenize

    if Path(twotowers_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError(f"twotowers_tpu_torch imported from outside this checkout: "
                           f"{twotowers_tpu_torch.__file__}")
    for name in build.sources():
        build.library_path(name).unlink(missing_ok=True)  # build from the sources, always
    seconds = build.build()
    start = time.perf_counter()
    if not tokenize.available():
        raise RuntimeError("native tokenizer did not build")
    ptxas = {name: [line.strip() for line in (build.BUILD_DIR / f"{name}.log").read_text()
                    .splitlines() if "registers" in line or "spill" in line]
             for name in build.sources()}
    emit("build", kernels=sorted(build.sources()), nvcc_s=seconds,
         tokenizer_s=time.perf_counter() - start, ptxas=ptxas)


# ---- 3. kernels ---------------------------------------------------------------

def agree(docs, queries, got, want, n_docs=None, rel=1e-5):
    """Hold a top-k against the plain version's. Scores within rtol 1e-5,
    atol 1e-6. Indices equal, except where the two candidates' scores,
    recomputed in f64, differ by less than ``rel`` relative: cuBLAS and the
    kernel sum in other orders, and near-ties at the k-th place of 1M docs
    happen. Returns (max_abs_err, near-tie swaps)."""
    gv, gi = got
    wv, wi = want
    torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-6)
    differ = gi != wi
    if differ.any():
        q_idx, pos = differ.nonzero(as_tuple=True)
        q64 = queries.to(docs.dtype).double()[q_idx]

        def rescore(idx):
            idx = idx[q_idx, pos].long()
            s = (q64 * docs[idx].double()).sum(1)
            return s if n_docs is None else torch.where(idx < n_docs, s, -1e30)

        sg, sw = rescore(gi), rescore(wi)
        near = (sg - sw).abs() <= rel * torch.maximum(sg.abs(), sw.abs())
        if not bool(near.all()):
            raise AssertionError(f"{int((~near).sum())} indices differ beyond a near-tie")
    return float((gv - wv).abs().max()), int(differ.sum())


def cuda_ms(fn, target_s: float = 0.3) -> float:
    """Mean ms of ``fn`` on the card from CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(200, max(5, target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def topk_bound(n, dim, q, k, dtype):
    """Least time for the work: each input read once and each output
    written once at the HBM rate, against 2*Q*N*D operations at the peak
    rate of the docs' type. Returns (ms, 'bytes' | 'operations')."""
    item = torch.finfo(dtype).bits // 8
    bytes_ms = ((n + q) * dim * item + q * k * 8) / H100_BYTES_PER_S * 1e3
    ops_ms = 2.0 * q * n * dim / H100_FLOPS[dtype] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def kernels_phase(card: dict, n_docs: int, seed: int) -> dict:
    from twotowers_tpu_torch.kernels.topk import score_topk_cuda
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def unit(*shape):
        x = torch.randn(*shape, device=dev, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    def check(case, docs, queries, k, n_real=None, exact=False):
        got = score_topk_cuda(docs, queries, k, n_real)
        torch.cuda.synchronize()
        want = score_topk_reference(docs, queries, k, n_real)
        err, swaps = agree(docs, queries, got, want, n_real, rel=0.0 if exact else 1e-5)
        if exact and not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{case}: not bit-equal to the plain version")
        emit("kernels", case=case, n=docs.shape[0], d=docs.shape[1], q=queries.shape[0],
             k=k, dtype=str(docs.dtype), max_abs_err=err, near_tie_swaps=swaps)
        return err

    docs = unit(n_docs, 128)
    docs_bf16 = docs.bfloat16()
    queries = {q: unit(q, 128) for q in (1, 32, 256)}
    errs = []
    for q, qs in queries.items():
        errs.append(check(f"main f32 q{q}", docs, qs, 10))
        errs.append(check(f"main bf16 q{q}", docs_bf16, qs, 10))
    ragged = n_docs - 17
    check("ragged n", docs[:ragged], queries[32], 10)
    padded = docs[:8192].clone()
    padded[5000:] = 50.0  # rows past n_docs would win if not masked
    check("n_docs < N", padded, queries[32], 10, n_real=5000)
    tied = torch.zeros(8192, 16, device=dev)
    tied[:, 0] = 1.0
    ones = torch.zeros(4, 16, device=dev)
    ones[:, 0] = 1.0
    check("all scores tied", tied, ones, 256)
    got_i = score_topk_cuda(docs, torch.zeros(2, 128, device=dev), 10)[1]
    if not torch.equal(got_i.cpu(), torch.arange(10, dtype=torch.int32).repeat(2, 1)):
        raise AssertionError("an all-zero query must return docs 0..k-1")
    check("all-zero query", docs, torch.zeros(2, 128, device=dev), 10)
    check("k=1", docs, queries[32], 1)
    check("k=256", docs, queries[32], 256)
    check("N=1000 < 4096", docs[:1000], queries[32], 10)
    ints = torch.randint(-2, 3, (n_docs // 4, 64), device=dev, generator=gen).float()
    qints = torch.randint(-2, 3, (64, 64), device=dev, generator=gen).float()
    check("integer-valued", ints, qints, 32, exact=True)

    timings = {}
    for (q, dtype) in [(1, torch.float32), (32, torch.float32), (256, torch.float32),
                       (1, torch.bfloat16), (256, torch.bfloat16)]:
        d = docs if dtype == torch.float32 else docs_bf16
        qs = queries[q]
        bound, bound_by = topk_bound(n_docs, 128, q, 10, dtype)
        row = {
            "ms": cuda_ms(lambda: score_topk_cuda(d, qs, 10)),
            "plain_ms": cuda_ms(lambda: score_topk_reference(d, qs, 10)),
            "library_ms": cuda_ms(lambda: torch.topk(qs.to(dtype) @ d.T, 10)),
            "bound_ms": bound, "bound_by": bound_by,
        }
        timings[(q, dtype)] = row
        emit("kernels", case=f"time q{q} {dtype}", n=n_docs, d=128, k=10, **row,
             card=card["nvidia_smi"])
    return {"max_abs_err": max(errs), **timings[(256, torch.float32)]}


# ---- 4. serve -----------------------------------------------------------------

def synthetic_texts(n: int, seed: int):
    """``n`` unique texts of 16-64 lowercase letters and spaces."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
    lengths = rng.integers(16, 65, size=n)
    data = alphabet[rng.integers(0, len(alphabet), size=int(lengths.sum()))].tobytes().decode()
    ends = np.cumsum(lengths)
    texts = [data[e - l:e] for e, l in zip(ends.tolist(), lengths.tolist())]
    if len(set(texts)) != n:
        raise RuntimeError("synthetic texts are not unique")
    return texts


def default_weights(vocab: int, rng: np.random.Generator) -> dict:
    """Default-config weights in the JAX layout from numpy: N(0,1) table with
    a zero pad row, U(+-1/sqrt(fan_in)) linears. The document tower is a copy
    of the query tower, so an indexed text retrieves itself at cosine 1."""
    def linear(fan_in, fan_out):
        bound = 1.0 / np.sqrt(fan_in)
        return (rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32),
                rng.uniform(-bound, bound, fan_out).astype(np.float32))

    table = rng.standard_normal((vocab, 64)).astype(np.float32)
    table[0] = 0.0
    w1, b1 = linear(64, 128)
    w2, b2 = linear(128, 128)
    tower = {"w1": w1, "b1": b1, "w2": w2, "b2": b2}
    return {"embedding": {"table": table}, "query_tower": tower,
            "document_tower": {name: a.copy() for name, a in tower.items()}}


def serve_phase(card: dict, n_docs: int, seed: int, device="cuda") -> dict:
    from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference
    from twotowers_tpu_torch.serve.app import ModelRuntime
    from twotowers_tpu_torch.serve.service import RetrievalService
    from twotowers_tpu_torch.tokenizers import build_tokenizer
    from twotowers_tpu_torch.train.checkpoint import load_trained_model, save_params

    rng = np.random.default_rng(seed)
    start = time.perf_counter()
    texts = synthetic_texts(n_docs, seed)
    tokenizer = build_tokenizer("char", max_len=64).fit(texts)
    ckpt = save_params(str(ROOT / "build" / "chip_smoke" / "checkpoint"),
                       default_weights(tokenizer.vocab_size, rng),
                       tokenizer.state_dict(), DEFAULT_CONFIG)
    setup_s = time.perf_counter() - start
    position = {t: i for i, t in enumerate(texts)}
    exact = [texts[i] for i in rng.choice(n_docs, size=4, replace=False)]
    fresh = synthetic_texts(4, seed + 1)

    topk.LAUNCHES = 0  # the main path starts here
    runtime = ModelRuntime(ckpt, device=device)
    service = RetrievalService(model=runtime, device=device)
    start = time.perf_counter()
    chunk = 50_000
    for lo in range(0, n_docs, chunk):
        batch = texts[lo:lo + chunk]
        out = service.add(batch, ids=[f"doc{i}" for i in range(lo, lo + len(batch))])
    add_s = time.perf_counter() - start
    health = service.health()
    if out["total"] != n_docs or health != {"status": "ok", "model_loaded": True,
                                            "documents": n_docs}:
        raise AssertionError(f"add/health: {out} {health}")
    emb = np.asarray(service.embed([exact[0]])["embeddings"])
    if emb.shape != (1, 128) or not np.allclose(np.linalg.norm(emb), 1.0, atol=1e-5):
        raise AssertionError(f"embed gave {emb.shape}")
    search_ms = []
    for query in exact + fresh:
        start = time.perf_counter()
        result = service.search(query, top_k=10)["results"]
        search_ms.append((time.perf_counter() - start) * 1e3)
        dists = [r["distance"] for r in result]
        if len(result) != 10 or not all(np.isfinite(dists)) or dists != sorted(dists):
            raise AssertionError(f"search for {query!r}: {result[:2]}")
        if query in exact:
            top = [r["document"] for r in result if r["distance"] <= dists[0] + 1e-6]
            if query not in top:
                raise AssertionError(f"indexed text {query!r} not at rank 1: {result[:2]}")

    model, spec, tokenizer, _ = load_trained_model(ckpt, device)
    search = TwoTowerSearch(model, spec, tokenizer, max_length=64, encode_batch_size=4096,
                            device=device)
    start = time.perf_counter()
    search.index_documents(texts)
    search._doc_matrix.sum().item()  # wait for the device
    index_s = time.perf_counter() - start
    batch_queries = [texts[i] for i in rng.choice(n_docs, size=128, replace=False)] \
        + synthetic_texts(128, seed + 2)
    start = time.perf_counter()
    results = search.search_batch(batch_queries, top_k=10)
    batch_ms = (time.perf_counter() - start) * 1e3
    launches = topk.LAUNCHES  # the main path ends here

    q_vecs = search._encode_texts_device(batch_queries, "query")
    got_v = torch.tensor([[s for _, s in row] for row in results], device=q_vecs.device)
    got_i = torch.tensor([[position[d] for d, _ in row] for row in results],
                         dtype=torch.int32, device=q_vecs.device)
    want = score_topk_reference(search._doc_matrix, q_vecs, 10, n_docs)
    err, swaps = agree(search._doc_matrix, q_vecs, (got_v, got_i), want, n_docs)
    searches = len(exact) + len(fresh) + 1
    if launches < searches:
        raise AssertionError(f"{launches} kernel launches for {searches} searches")
    serve = {"n_docs": n_docs, "setup_s": setup_s, "add_docs_per_s": n_docs / add_s,
             "index_docs_per_s": n_docs / index_s, "search_p50_ms": statistics.median(search_ms),
             "search_ms": search_ms, "search_batch_256_ms": batch_ms,
             "batch_max_abs_err": err, "batch_near_tie_swaps": swaps,
             "score_topk_launches": launches, "card": card["nvidia_smi"]}
    emit("serve", **serve)
    return serve


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-docs", type=int, default=1_000_000)
    args = parser.parse_args()

    card = device_phase()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version sums in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    topk_row = kernels_phase(card, args.n_docs, args.seed)
    serve = serve_phase(card, args.n_docs, args.seed)
    print(json.dumps({"kernels": [{
        "name": "score_topk", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/score_topk.cu",
        "replaces": "twotowers_tpu/kernels/pallas_topk.py:52",
        "launches": serve["score_topk_launches"],
        "max_abs_err": topk_row["max_abs_err"],
        "tolerance": "scores rtol 1e-5 atol 1e-6; indices equal but for near-ties "
                     "(f64 rescores within 1e-5 relative); integer case bit-equal",
        "ms": topk_row["ms"], "kernel_ms": topk_row["ms"], "plain_ms": topk_row["plain_ms"],
        "bound_ms": topk_row["bound_ms"], "bound_by": topk_row["bound_by"],
        "library_ms": topk_row["library_ms"],
        "shape": {"n": args.n_docs, "d": 128, "q": 256, "k": 10, "dtype": "float32"},
        "card": card["nvidia_smi"],
    }]}), flush=True)
    print(card["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
