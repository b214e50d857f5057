"""Drive the PyTorch port's serving and training paths on one CUDA card and
check them.

    python3 chip_smoke.py [--seed 0] [--n-docs 1000000]

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  -- the card's name and power limit; no card is a failure.
2. build   -- every CUDA source of the port (one nvcc each, started
              together) and the native tokenizer, from this checkout.
3. kernels -- the score + top-k kernel against its plain PyTorch version on
              the card at the serve path's shapes and at edge cases, then
              timed beside the plain version, a library yardstick and its
              bound.
4. serve   -- the default config (char tokenizer, max_len 64, lookup
              embedding 64, mean tower 128, f32) at full width with random
              weights from the seed, over ``--n-docs`` synthetic texts:
              ``RetrievalService`` add / health / embed / 8 searches, then
              ``TwoTowerSearch`` index + one 256-query ``search_batch``
              checked against the plain version, then one ``top_k=300``
              search (the route for k > 256).
5. embed   -- the embedding scatter-add and gather kernels, checked and
              timed as in phase 3, at the train path's shapes and at edge
              cases.
6. train   -- the word-vocab configuration of ``bench.py``'s
              ``word_vocab_32k_train`` at full width (word vocab 32,768,
              seq 64, batch 16,384, embedding 64, mean tower 128, tied,
              bf16, triplet loss, AdamW 1e-3): ``train_model`` for 2 epochs
              over 4 x 16,384 + 100 synthetic Zipf(1.07) triplets (the last
              batch padded), checks on
              the loss, metrics, launches and checkpoints, a ``resume:
              latest`` epoch, retrieval from ``best_model``, one step held
              against the same step with the plain versions swapped in, and
              the step's time.

The launch counts are zeroed just before each main path (serve, train) and
read just after it. Then the kernel table, the nvidia-smi line and, last,
the result line. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
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
    from twotowers_tpu_torch.ops import topk_score
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
    topk_score.TORCH_ROUTE_CALLS = 0
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
    batch_ms = []
    for _ in range(2):  # the first call, then the same call again
        start = time.perf_counter()
        results = search.search_batch(batch_queries, top_k=10)
        batch_ms.append((time.perf_counter() - start) * 1e3)

    # k > 256: the route rule sends it to score_topk_torch before any launch.
    # It runs after the batch: before it, it made the first search_batch
    # 13-18 ms slower (PERF.md, section 7)
    launches_before = topk.LAUNCHES
    wide = service.search(exact[1], top_k=300)["results"]
    if topk.LAUNCHES != launches_before or topk_score.TORCH_ROUTE_CALLS != 1:
        raise AssertionError("top_k=300 did not take the torch route alone")
    collection = service.collection
    device_unit, n_index = collection._device_index()
    q_vec = collection._unit_queries(runtime.encode_device([exact[1]], "query"))
    want_v, want_i = score_topk_reference(device_unit, q_vec, 300, n_index)
    got_i = torch.tensor([[position[r["document"]] for r in wide]], dtype=torch.int32)
    got_v = torch.tensor([[1.0 - r["distance"] for r in wide]])
    if len(wide) != 300 or not torch.equal(got_i, want_i.cpu()):
        raise AssertionError(f"top_k=300: {len(wide)} results, not the plain version's")
    wide_err = float((got_v - want_v.cpu()).abs().max())
    if wide_err > 1e-6:  # 1 - (1 - s) in f64 on the host
        raise AssertionError(f"top_k=300 scores differ by {wide_err}")

    launches = topk.LAUNCHES  # the main path ends here
    torch_route_calls = topk_score.TORCH_ROUTE_CALLS

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
             "search_ms": search_ms, "search_batch_256_ms": batch_ms[0],
             "search_batch_256_again_ms": batch_ms[1],
             "batch_max_abs_err": err, "batch_near_tie_swaps": swaps,
             "top300_max_abs_err": wide_err, "score_topk_launches": launches,
             "score_topk_torch_route_calls": torch_route_calls, "card": card["nvidia_smi"]}
    emit("serve", **serve)
    return serve


# ---- 5. the embedding kernels ------------------------------------------------

WORD_VOCAB, WORD_SEQ, WORD_BATCH, WORD_EMB, WORD_HID = 32768, 64, 16384, 64, 128
MAIN_ROWS = WORD_BATCH * WORD_SEQ  # rows of one encode's lookup: 1,048,576
TRAIN_ROWS = 4 * WORD_BATCH + 100  # synthetic triplets: the last batch is padded


def zipf_ids(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    """Ids drawn Zipf(1.07) over ranks 1..vocab-1 (bench.py's word-vocab
    inputs and tools/exp_pallas_embed*.py's zipf_ids)."""
    ranks = np.arange(1, vocab)
    weights = 1.0 / np.power(ranks, 1.07)
    return rng.choice(ranks, size=n, p=weights / weights.sum()).astype(np.int32)


def bytes_bound(n_bytes: float) -> tuple:
    """Least time to move ``n_bytes`` at the HBM rate; the adds and casts of
    these kernels (one per element) are far below any compute limit."""
    return n_bytes / H100_BYTES_PER_S * 1e3, "bytes"


def embed_kernels_phase(card: dict, seed: int) -> dict:
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import gather, scatter_add

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"scatter_add_rows": 0.0, "gather_rows": 0.0}

    def scatter_check(case, g, ids, vocab, out_dtype=torch.float32, exact=False):
        """Kernel against the plain version. Tolerance: both sum f32 in other
        orders (the plain index_add_ by atomics, in an order that changes
        from run to run), so |kernel - plain| <= 1e-5 * the row's sum of
        |g| + 1e-6; bit-equal where the sums are exact (integer g)."""
        got = scatter_add.scatter_add_rows(g, ids, vocab, out_dtype)
        torch.cuda.synchronize()
        want = scatter_add.scatter_add_rows_reference(g, ids, vocab, out_dtype)
        diff = (got.float() - want.float()).abs()
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"scatter {case}: not bit-equal to the plain version")
        else:
            scale = scatter_add.scatter_add_rows_reference(g.abs(), ids, vocab)
            step = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0  # one bf16 ulp
            tol = 1e-5 * scale + 1e-6 + step * want.float().abs()
            if bool((diff > tol).any()):
                raise AssertionError(f"scatter {case}: max err {float(diff.max())} beyond tolerance")
        if not torch.equal(scatter_add.scatter_add_rows(g, ids, vocab, out_dtype), got):
            raise AssertionError(f"scatter {case}: two runs differ")
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"], float(diff.max()))
        emit("kernels", kernel="scatter_add_rows", case=case, n=g.shape[0], d=g.shape[1],
             v=vocab, g=str(g.dtype), out=str(out_dtype), max_abs_err=float(diff.max()),
             bit_equal=bool(torch.equal(got, want)))

    def normal(n, d, dtype=torch.float32):
        return torch.randn(n, d, device=dev, generator=gen).to(dtype)

    def uniform_ids(vocab, n):
        return torch.randint(0, vocab, (n,), device=dev, generator=gen, dtype=torch.int32)

    main_ids = torch.from_numpy(zipf_ids(rng, WORD_VOCAB, MAIN_ROWS)).to(dev)
    g_main = normal(MAIN_ROWS, WORD_EMB, torch.bfloat16)
    scatter_check("main bf16 g", g_main, main_ids, WORD_VOCAB)
    scatter_check("main f32 g (#4 exp_pallas_embed shape)", g_main.float(), main_ids, WORD_VOCAB)
    exp2_ids = torch.from_numpy(zipf_ids(rng, WORD_VOCAB, 3 * MAIN_ROWS)).to(dev)
    scatter_check("#5 exp_pallas_embed2 shape", normal(3 * MAIN_ROWS, WORD_EMB), exp2_ids,
                  WORD_VOCAB)
    scatter_check("n 5000", normal(5000, 64), uniform_ids(640, 5000), 640)
    scatter_check("d 32", normal(4096, 32), uniform_ids(130, 4096), 130)
    scatter_check("d 130", normal(4096, 130), uniform_ids(640, 4096), 640)
    scatter_check("v 612", normal(4096, 64), uniform_ids(612, 4096), 612)
    scatter_check("v 30522", normal(MAIN_ROWS, 64), uniform_ids(30522, MAIN_ROWS), 30522)
    geo = torch.from_numpy(np.minimum(rng.geometric(0.3, size=MAIN_ROWS) - 1, 639)
                           .astype(np.int32)).to(dev)
    scatter_check("geometric(0.3)", normal(MAIN_ROWS, 64), geo, 640)
    scatter_check("all ids equal", normal(MAIN_ROWS, 64),
                  torch.full((MAIN_ROWS,), 7, dtype=torch.int32, device=dev), 640)
    scatter_check("bf16 table from bf16 g", g_main, main_ids, WORD_VOCAB, torch.bfloat16)
    ints = torch.randint(-3, 4, (MAIN_ROWS, 64), device=dev, generator=gen).float()
    scatter_check("integer-valued g", ints, main_ids, WORD_VOCAB, exact=True)

    table = normal(WORD_VOCAB, WORD_EMB)
    for case, tab, ids, out_dtype in [
            ("main f32 -> bf16", table, main_ids, torch.bfloat16),
            ("main f32 -> f32", table, main_ids, torch.float32),
            ("#3 exp_pallas_embed bf16 -> bf16", table.bfloat16(), main_ids, torch.bfloat16),
            ("#6 exp_pallas_embed2 bf16 -> bf16", table.bfloat16(), exp2_ids, torch.bfloat16),
            ("d 130 f32 -> bf16", normal(640, 130), uniform_ids(640, 5000), torch.bfloat16)]:
        got = gather.gather_rows(tab, ids, out_dtype)
        torch.cuda.synchronize()
        want = gather.gather_rows_reference(tab, ids, out_dtype)
        err = float((got.float() - want.float()).abs().max())
        errs["gather_rows"] = max(errs["gather_rows"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"gather {case}: not bit-equal to the plain version "
                                 f"(max err {err})")
        emit("kernels", kernel="gather_rows", case=case, n=ids.shape[0], d=tab.shape[1],
             table=str(tab.dtype), out=str(out_dtype), max_abs_err=err, bit_equal=True)

    # times at the main path's shape: bf16 g rows of one encode into the f32
    # table; the f32 table gathered into the bf16 compute dtype. No single
    # library call takes these dtypes: index_add_ reads g widened to f32
    # (256 MB, not 128), F.embedding reads the table cast to bf16 beforehand;
    # both read int64 ids
    sorted_ids, perm = scatter_add.sort_ids(main_ids)
    ids64, g32, table_bf16 = main_ids.long(), g_main.float(), table.bfloat16()
    scatter_row = {
        "ms": cuda_ms(lambda: scatter_add.scatter_add_rows(g_main, main_ids, WORD_VOCAB)),
        "kernel_only_ms": cuda_ms(lambda: scatter_add.scatter_add_sorted(
            g_main, sorted_ids, perm, WORD_VOCAB)),
        "sort_ms": cuda_ms(lambda: scatter_add.sort_ids(main_ids)),
        "plain_ms": cuda_ms(lambda: scatter_add.scatter_add_rows_reference(
            g_main, main_ids, WORD_VOCAB)),
        "library_ms": cuda_ms(lambda: torch.zeros(WORD_VOCAB, WORD_EMB, device=dev)
                              .index_add_(0, ids64, g32)),
    }
    scatter_row["bound_ms"], scatter_row["bound_by"] = bytes_bound(
        MAIN_ROWS * WORD_EMB * 2 + MAIN_ROWS * 4 + WORD_VOCAB * WORD_EMB * 4)
    gather_row = {
        "ms": cuda_ms(lambda: gather.gather_rows(table, main_ids, torch.bfloat16)),
        "plain_ms": cuda_ms(lambda: gather.gather_rows_reference(table, main_ids,
                                                                 torch.bfloat16)),
        "library_ms": cuda_ms(lambda: F.embedding(ids64, table_bf16)),
    }
    gather_row["bound_ms"], gather_row["bound_by"] = bytes_bound(
        MAIN_ROWS * 4 + WORD_VOCAB * WORD_EMB * 4 + MAIN_ROWS * WORD_EMB * 2)
    emit("kernels", kernel="scatter_add_rows", case="time main bf16 g", n=MAIN_ROWS,
         d=WORD_EMB, v=WORD_VOCAB, **scatter_row, card=card["nvidia_smi"])
    emit("kernels", kernel="gather_rows", case="time main f32 -> bf16", n=MAIN_ROWS,
         d=WORD_EMB, v=WORD_VOCAB, **gather_row, card=card["nvidia_smi"])
    return {"scatter_add_rows": {"max_abs_err": errs["scatter_add_rows"], **scatter_row},
            "gather_rows": {"max_abs_err": errs["gather_rows"], **gather_row}}


# ---- 6. train -----------------------------------------------------------------

WORD_CONFIG = {  # bench.py's word_vocab_32k_train, as a training config
    "tokeniser": {"type": "word", "max_len": WORD_SEQ, "max_vocab_size": WORD_VOCAB},
    "embedding": {"type": "lookup", "embedding_dim": WORD_EMB},
    "encoder": {"arch": "mean", "hidden_dim": WORD_HID, "tied_weights": True},
    "precision": "bf16",
    "loss": {"type": "triplet", "margin": 0.2},
    "optimizer": {"type": "adamw", "lr": 1e-3},
    "batch_size": WORD_BATCH,
    "epochs": 2,
    "max_sequence_length": WORD_SEQ,
    "use_wandb": False,
}


def word_triplets_tsv(path: Path, n_rows: int, seed: int) -> list:
    """Write ``n_rows`` triplets of words ``w<rank>``, ranks drawn Zipf(1.07)
    over 1..32,766, 16-64 words a text. The positive is its query with a
    quarter of the words redrawn; the negative is drawn afresh. Returns the
    positives."""
    rng = np.random.default_rng(seed)
    names = np.array([f"w{r}" for r in range(WORD_VOCAB)], dtype=object)
    ranks = np.arange(1, WORD_VOCAB - 1)
    weights = 1.0 / np.power(ranks, 1.07)
    weights /= weights.sum()
    lengths = rng.integers(16, 65, size=(2, n_rows))
    words = rng.choice(ranks, size=int(lengths.sum()), p=weights)
    query_words = np.split(words[:lengths[0].sum()], np.cumsum(lengths[0])[:-1])
    negative_words = np.split(words[lengths[0].sum():], np.cumsum(lengths[1])[:-1])
    fresh = rng.choice(ranks, size=int(lengths[0].sum()), p=weights)
    redraw = rng.random(int(lengths[0].sum())) < 0.25
    positive_flat = np.where(redraw, fresh, words[:lengths[0].sum()])
    positive_words = np.split(positive_flat, np.cumsum(lengths[0])[:-1])
    text = lambda ids: " ".join(names[ids])  # noqa: E731
    positives = [text(w) for w in positive_words]
    with open(path, "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        for q, p, n in zip(query_words, positives, negative_words):
            f.write(f"{text(q)}\t{p}\t{text(n)}\n")
    return positives


def _device_batch(pipeline):
    from twotowers_tpu_torch.data import iterate_batches, place_on_device

    batch = place_on_device(next(iterate_batches(pipeline.dataset.arrays(), WORD_BATCH)),
                            "cuda")
    return batch.queries, batch.positives, batch.negatives, batch.weights


class plain_embedding_kernels:
    """Swap the lookup's kernels for their plain versions (on the card)."""

    def __enter__(self):
        from twotowers_tpu_torch.kernels import gather, scatter_add
        from twotowers_tpu_torch.models import embeddings

        self.saved = (embeddings.gather_rows, embeddings.scatter_add_rows)
        embeddings.gather_rows = gather.gather_rows_reference
        embeddings.scatter_add_rows = scatter_add.scatter_add_rows_reference

    def __exit__(self, *exc):
        from twotowers_tpu_torch.models import embeddings

        embeddings.gather_rows, embeddings.scatter_add_rows = self.saved


def _step_ms(base, pipeline, config, batch, seed, steps=5):
    """Mean ms of one train step on the card (CUDA events), from a copy of
    ``base``, after two warm-up steps."""
    from twotowers_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    opt = build_optimizer(config)
    state = create_train_state(copy.deepcopy(base), opt, seed)
    step = make_train_step(pipeline.loss_def, opt)
    for _ in range(2):
        step(state, *batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        step(state, *batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, state, step


def _profile_step(state, step, batch) -> dict:
    """Device time of 3 train steps by kernel name (torch.profiler): the
    device's busy time per step and the lookup kernels' part of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, *batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # an op's kernels are listed apart; a device range named after an op
    # (record_function's annotation) spans kernels already counted
    ops = {event.key for event in events if event.device_type == DeviceType.CPU}
    rows = []
    for event in events:
        if event.device_type == DeviceType.CPU or event.key in ops:
            continue
        self_us = getattr(event, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(event, "self_cuda_time_total", 0.0)
        if self_us > 0:
            rows.append((event.key, self_us / 3e3, event.count / 3))
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in rows)
    ours = sum(ms for name, ms, _ in rows
               if any(k in name for k in ("scatter_chunks", "scatter_spans",
                                          "gather_rows_kernel")))
    return {"device_ms_per_step": total, "lookup_kernels_ms_per_step": ours,
            "lookup_kernels_share_of_device": ours / total if total else None,
            "launches_per_step": sum(n for _, _, n in rows),
            "top": [[name[:70], ms, n] for name, ms, n in rows[:14]]}


def train_phase(card: dict, seed: int, kernel_ms: dict) -> dict:
    from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
    from twotowers_tpu_torch.kernels import gather, scatter_add
    from twotowers_tpu_torch.train import (
        build_optimizer, create_train_state, latest_checkpoint, load_checkpoint,
        load_trained_model, make_train_step, train_model)

    work = ROOT / "build" / "chip_smoke" / "train"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    start = time.perf_counter()
    positives = word_triplets_tsv(work / "triplets.tsv", TRAIN_ROWS, seed)
    data_s = time.perf_counter() - start
    config = {**WORD_CONFIG, "data": str(work / "triplets.tsv"),
              "checkpoint_dir": str(work / "ckpt"), "log_dir": str(work / "logs")}

    scatter_add.LAUNCHES = 0  # the main path starts here
    gather.LAUNCHES = 0
    start = time.perf_counter()
    state, pipeline = train_model(config, seed=seed)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = {"scatter_add_rows": scatter_add.LAUNCHES,
                "gather_rows": gather.LAUNCHES}  # the main path ends here

    steps_per_epoch = math.ceil(TRAIN_ROWS / WORD_BATCH)
    vocab = pipeline.dataset.vocab_size
    if state.step != 2 * steps_per_epoch or vocab <= 512:
        raise AssertionError(f"{state.step} steps at vocab {vocab}")
    with open(next((work / "logs").glob("*_metrics.jsonl"))) as f:
        records = [json.loads(line) for line in f]
    values = [v for r in records for k, v in r.items() if isinstance(v, float)]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("a metric is not finite")
    epoch_loss = [r["train/epoch_loss"] for r in records if "train/epoch_loss" in r]
    if len(epoch_loss) != 2 or not epoch_loss[1] < epoch_loss[0]:
        raise AssertionError(f"epoch losses {epoch_loss}: epoch 2 must be below epoch 1")
    if launches["scatter_add_rows"] != 3 * state.step or \
            launches["gather_rows"] < launches["scatter_add_rows"]:
        raise AssertionError(f"launches {launches} for {state.step} steps")
    best = work / "ckpt" / "best_model"
    latest = latest_checkpoint(str(work / "ckpt"))
    if not (best / "params.npz").exists() or not (best / "opt_state.npz").exists() or not latest:
        raise AssertionError("best_model / latest checkpoint missing")
    trained_step = state.step

    # resume: latest restarts at epoch 3 with the step count carried
    resumed, _ = train_model({**config, "epochs": 3, "resume": "latest"}, seed=seed)
    _, meta = load_checkpoint(latest_checkpoint(str(work / "ckpt")))
    if resumed.step != trained_step + steps_per_epoch or meta["epoch"] != 3:
        raise AssertionError(f"resume: step {resumed.step}, latest epoch {meta['epoch']}")

    # the trained model serves: an indexed positive comes first for its own text
    model, spec, tokenizer, _ = load_trained_model(str(best))
    search = TwoTowerSearch(model, spec, tokenizer, max_length=WORD_SEQ,
                            encode_batch_size=4096)
    search.index_documents(positives)
    rng = np.random.default_rng(seed)
    for i in rng.choice(len(positives), size=8, replace=False):
        top = search.search(positives[i], top_k=2)
        if top[0][0] != positives[i] and top[0][1] - top[1][1] > 1e-6:
            raise AssertionError(f"positive {i} not at rank 1: {top[0][1]}")

    # one step from the same weights through the kernels and through the
    # plain versions: the forward is bit-equal, the table gradient sums f32
    # in another order (the plain index_add_ by atomics)
    batch = _device_batch(pipeline)
    base = copy.deepcopy(state.model)
    outcome = []
    for plain in (False, True):
        opt = build_optimizer(config)
        ab_state = create_train_state(copy.deepcopy(base), opt, seed)
        step = make_train_step(pipeline.loss_def, opt)
        if plain:
            with plain_embedding_kernels():
                _, metrics = step(ab_state, *batch)
        else:
            _, metrics = step(ab_state, *batch)
        torch.cuda.synchronize()
        outcome.append((float(metrics["loss"]), ab_state.model.embedding.table.grad.clone()))
    (loss_k, grad_k), (loss_p, grad_p) = outcome
    scale = float(grad_p.abs().max())
    grad_err = float((grad_k - grad_p).abs().max())
    if abs(loss_k - loss_p) > 1e-6 * abs(loss_p):
        raise AssertionError(f"step loss {loss_k} through the kernels, {loss_p} plain")
    torch.testing.assert_close(grad_k, grad_p, rtol=1e-3, atol=1e-4 * scale)

    # the step's time, kernels and plain versions in turns
    times = {"kernels": [], "plain": []}
    for plain in (False, True, True, False):
        if plain:
            with plain_embedding_kernels():
                ms, _, _ = _step_ms(base, pipeline, config, batch, seed)
        else:
            ms, prof_state, prof_step = _step_ms(base, pipeline, config, batch, seed)
        times["plain" if plain else "kernels"].append(ms)
    step_ms = statistics.mean(times["kernels"])
    profile = _profile_step(prof_state, prof_step, batch)
    lookup_ms = 3 * (kernel_ms["scatter_add_rows"]["ms"] + kernel_ms["gather_rows"]["ms"])
    train = {
        "rows": TRAIN_ROWS, "vocab": vocab, "steps": trained_step, "data_s": data_s,
        "train_model_s": train_s, "epoch_loss": epoch_loss, "launches": launches,
        "step_ms": step_ms, "step_ms_runs": times["kernels"],
        "step_ms_plain_runs": times["plain"], "pairs_per_s": WORD_BATCH / step_ms * 1e3,
        "lookup_kernels_ms_per_step": lookup_ms, "lookup_kernels_share": lookup_ms / step_ms,
        "ab_loss": [loss_k, loss_p], "ab_table_grad_max_abs_err": grad_err,
        "ab_table_grad_max": scale, "profile": profile, "card": card["nvidia_smi"],
    }
    emit("train", **train)
    return train


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
    embed_rows = embed_kernels_phase(card, args.seed)
    train = train_phase(card, args.seed, embed_rows)
    embed_shape = {"n": MAIN_ROWS, "d": WORD_EMB, "v": WORD_VOCAB}
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
    }, {
        "name": "scatter_add_rows", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "twotowers_tpu/kernels/pallas_scatter_add.py:82",
        "launches": train["launches"]["scatter_add_rows"],
        "max_abs_err": embed_rows["scatter_add_rows"]["max_abs_err"],
        "tolerance": "|kernel - plain| <= 1e-5 * sum|g| of the row + 1e-6 (f32 sums in "
                     "another order); integer-valued g bit-equal",
        **{k: embed_rows["scatter_add_rows"][k] for k in (
            "ms", "kernel_only_ms", "sort_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "library": "torch.zeros(V, D).index_add_(0, ids.long(), g.float()), g widened beforehand",
        "shape": {**embed_shape, "g": "bfloat16", "ids": "Zipf(1.07)"},
        "card": card["nvidia_smi"],
    }, {
        "name": "gather_rows", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/gather_rows.cu",
        "replaces": "tools/exp_pallas_embed.py:81",
        "launches": train["launches"]["gather_rows"],
        "max_abs_err": embed_rows["gather_rows"]["max_abs_err"],
        "tolerance": "bit-equal",
        **{k: embed_rows["gather_rows"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "F.embedding(ids.long(), table.bfloat16()), the table cast beforehand",
        "shape": {**embed_shape, "table": "float32", "out": "bfloat16"},
        "card": card["nvidia_smi"],
    }]}), flush=True)
    print(card["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
