"""Drive the PyTorch port's serving, training and search paths on one CUDA
card and check them.

    python3 chip_smoke.py [--seed 0] [--n-docs 1000000]

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device  -- the card's name and power limit; no card is a failure.
2. build   -- every CUDA source of the port (one nvcc each, started
              together) and the native tokenizer, from this checkout.
3. kernels -- the score + top-k kernel's Q <= 4 block and Q >= 5 block
              (registers, local bytes, shared-memory bytes and blocks per
              SM; the Q >= 5 block at k=256 and, bf16, k=10, its two
              selections, and its engine: FFMA on the CUDA cores for f32
              docs, mma.sync on the tensor cores for bf16; and the f32 ring pass,
              ``score_topk_tiles_ring``, which takes f32 docs at Q >= 5
              and k <= 14, at Q=32 and 256: no spills, 2 blocks an SM),
              then the kernel against its plain PyTorch version on the card
              at the serve path's shapes and at edge cases (Q=1 twins of
              the batch's; Q >= 5 at k=256: bf16, Q=257, all scores tied,
              n_docs < N; the bf16 tensor-core pass on integer-valued
              inputs bit-equal at Q=64, k=32 and Q=257, k=256, and on
              float inputs at Q=257, D=1024, k=10 and 256; the bf16
              Q = 2-4 pass on the tensor cores, ``score_topk_stream_mma``,
              at k=10, 100 and 256, ragged N, n_docs < N, integer-valued
              inputs bit-equal, two calls the same bits, its pass 1 alone
              bit-equal to the plain per-split top-k, docs off 16-byte
              alignment or at D=100 on ``score_topk_stream`` by the route
              rule, and that path, ``score_topk`` on bf16 docs at Q = 2-4,
              driven with its launch counts zeroed before and read after),
              then pass 1 alone (``score_topk_candidates``)
              at Q=32, k=256 bit-equal to the plain per-split top-k
              (``candidates_reference``) on integer-valued inputs, and
              barred by a sample run's k-th pairs (the Q >= 5 wide
              selection's bar) at Q=32 and 257, k=256, f32 and bf16 on
              integer-valued, all-tied and signed-zero docs, with the
              sample run's sums held bit-equal to the main run's on float
              docs (``sample_pairs_in_main``), then
              pass 2 alone (``merge_topk_cuda``, its blocks per level)
              bit-equal to the plain merge on the real pass-1 lists of Q=1,
              k=256 (f32, bf16) and on crafted lists at S = 1, 33, 1024,
              then timed beside the plain version, a library yardstick and
              its bound, with pass 1 and each level of pass 2 apart at Q=1
              and at k=100 and 256. Last, two calls of ``score_topk`` that
              take the torch route (no kernel launch) with bf16 docs and
              f32 queries: k=300 at D=128, scored unrounded as JAX's
              ``score_topk_xla`` scores it (``score_topk_unrounded``, held
              against an f64 rescoring), and k=10 at D=1040, where the
              route keeps the Pallas kernel's cast (``score_topk_reference``).
4. serve   -- the default config (char tokenizer, max_len 64, lookup
              embedding 64, mean tower 128, f32) at full width with random
              weights from the seed, over ``--n-docs`` synthetic texts:
              ``RetrievalService`` add / health / embed / 8 searches, then
              ``TwoTowerSearch`` index + one 256-query ``search_batch``
              (twice; both on the ring pass, counted) checked against the
              plain version, then one ``top_k=300`` search (the route for
              k > 256).
5. embed   -- the embedding scatter-add and gather kernels, checked and
              timed as in phase 3, at the train path's shapes, at the
              experiments' shapes and at edge cases (runs that straddle a
              chunk, short N, ids outside [0, V), a misaligned g), with the
              scatter-add's plan, blocks per SM and device time by kernel;
              the gather also at the Hub-serve encode's shape, a model
              rank's shard (most ids outside it), D = 1 to 1,024 at N = 1,
              31 and 5,003, a table 4 bytes off alignment and an output of
              more than 2**31 elements (bit-equal to the plain version),
              with its plan, blocks per SM and a call's host time beside
              ``F.embedding``'s. Then both at an expert layer's dispatch
              and combine in ``train-moonlight-b512`` (``models/moe.py``):
              rows of width 2,048, ids that are token positions in expert
              order, for the cell's passage and query calls (98,304 and
              16,384 tokens): the dispatch gather bf16 -> bf16 and the
              combine's backward gather bf16 -> f32 bit-equal to the plain
              version, the combine's scatter-add f32 -> bf16 and the
              dispatch's backward scatter-add bf16 -> bf16 bit-equal on
              integer-valued rows and within the tolerance on float rows;
              each timed beside the plain version, a library call and its
              bound.
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
7. transformer -- ``configs/transformer_tower.yml`` at full width (BPE 2,000
              merges, max_len 48, positional embedding 128, pre-LN
              transformer 128 x 2 layers x 4 heads, tied, dropout 0.1,
              in_batch loss t=0.1, bf16, batch 256, AdamW 1e-3), from the
              dict ``TRANSFORMER_CONFIG`` (the file as ``load_config``
              resolves it; pyyaml may be absent) with its paths under
              ``build/chip_smoke/transformer/`` and its depth cut from 3
              epochs to 2: ``train_model`` over 16,384 + 100 synthetic
              triplets (the last batch padded), checks on the BPE vocab,
              the loss, launches and checkpoints; one step held against
              the same step with the plain versions swapped in;
              ``evaluate_model`` of the trained and the initial weights on
              100 held-out tuples; ``ModelRuntime`` + ``RetrievalService``
              over 20,000 texts from ``best_model``, 8 searches; then
              ``bench.py``'s transformer_tower_train step (vocab 8,192,
              seq 48, batch 4,096) timed and profiled, and the cnn, rnn and
              transformer towers in f32 on the card against the CPU.
8. pretrained -- ``configs/word2vec_skipgram.yml`` at full width (word
              tokenizer, max_len 32; a frozen ``pretrained`` table 300 wide,
              gensim's vectors absent so the seeded fallback; tied ``mean``
              tower 256; triplet loss, margin 0.3; Adam 5e-4; batch 128;
              f32), from the dict ``WORD2VEC_CONFIG`` with its paths under
              ``build/chip_smoke/pretrained/``, its depth cut from 5 epochs
              to 2 and ``profile:`` on: ``train_model`` over 16,384 + 100
              synthetic Zipf triplets (vocab ~32k, so the lookup is the
              gather kernel), checks that the table on the card is the
              CPU's fallback table bit for bit before and after, that the
              gather launches are 3 a step and the scatter-add's 0, that
              the loss falls, that the trace names ``gather_rows_kernel``
              and that a resumed epoch carries the step count and Adam's
              state; then the search CLI (``index.cli.main``: build-index
              from ``best_model`` over 100,000 texts, 8 searches) and
              ``GloVeSearch`` (50-wide hashed vectors) over the same texts,
              each search found first and held against the plain version;
              the gather at D=300 and kernel #1 at D=256 and D=50 checked
              and timed; the step's time and busy share.
9. parallel -- 4 spawned ranks as a {data: 2, model: 2} mesh (gloo on one
              card, NCCL on four): ``train_model`` under ``mesh:`` over
              phase 6's data, the sharded step at vocab 102,400 against
              the single-rank step, kernels #3 and #2 on each shard's own
              ids, ``ShardedDocIndex`` over 1M x 128, then a 1-rank NCCL
              group.
10. hub_serve -- phase 6's ``best_model`` staged by
              ``hub.save_model_for_hub`` into ``build/chip_smoke/hub/``
              (layout and model card checked), then served as the app
              builds its service (``serve.app.build_service``, the default
              device) with ``MODEL_CHECKPOINT`` on the staged copy and
              ``CHROMA_HOST`` on a closed localhost port: the Chroma backend
              fails and the in-process store on the card takes over, which
              is asserted. Phase 6's ~65k distinct positives are added and
              8 of them searched: each comes first for itself, equals a
              ``TwoTowerSearch`` of ``best_model`` within 1e-6 and agrees
              with the plain version on the store's matrix; kernel #1 is
              launched exactly 8 times.

The launch counts are zeroed just before each main path (serve, train,
transformer, pretrained, parallel, hub_serve) and read just after it. Then the kernel table, the nvidia-smi
line and, last, the result line. No path is cut in width; depth is cut as
named above. Imports nothing of JAX and nothing of the JAX package.
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

from twotowers_tpu_torch.kernels.topk import agree

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


def crafted_lists(q, s, k, kind, gen):
    """(Q, S, k) candidate lists as pass 1 leaves them, on ``gen``'s
    device: each sorted best first, unique indices within a query, a
    random number of real pairs a list (list 0 full, so k are real) and the
    rest (-inf, NO_INDEX). ``kind`` picks the values: random normal, all
    tied, integers in [-2, 2], or -0.0 and +0.0 mixed with -1."""
    from twotowers_tpu_torch.kernels.topk import NO_INDEX, merge_topk_reference

    dev = gen.device
    n = s * k
    index = torch.argsort(torch.rand(q, 2 * n, generator=gen, device=dev), dim=1)[:, :n]
    if kind == "random":
        values = torch.randn(q, n, generator=gen, device=dev)
    elif kind == "tied":
        values = torch.ones(q, n, device=dev)
    elif kind == "integer":
        values = torch.randint(-2, 3, (q, n), generator=gen, device=dev).float()
    elif kind == "signed-zero":  # -0.0 or -1, then half the zeros made +0.0
        values = -(torch.rand(q, n, generator=gen, device=dev) < 0.25).float()
        positive = torch.rand(q, n, generator=gen, device=dev) < 0.5
        values = values.masked_fill((values == 0) & positive, 0.0)
        values[:, 0] = -0.0  # list 0 is full: one -0.0 at least is real
    else:
        raise KeyError(kind)
    real = torch.randint(0, k + 1, (q, s, 1), generator=gen, device=dev)
    real[:, 0] = k
    pad = torch.arange(k, device=dev) >= real
    values = values.view(q, s, k).masked_fill(pad, -math.inf)
    index = index.int().view(q, s, k).masked_fill(pad, NO_INDEX)
    sv, si = merge_topk_reference(values.view(q * s, 1, k), index.view(q * s, 1, k))
    return sv.view(q, s, k).contiguous(), si.view(q, s, k).contiguous()


def sample_pairs_in_main(sample_v, sample_i, cand_v, cand_i, split_len: int) -> int:
    """Hold a sample run's sums against the main run's: each of the sample
    run's (Q, k) top pairs that the pass-1 list of the main run's split
    holding its doc holds too has the very same bits there. Raises if one
    differs or none is held; returns how many pairs were held."""
    q, _, k = cand_v.shape
    idx = sample_i.long()
    split = idx // split_len
    at = torch.arange(q, device=idx.device)[:, None]
    lists_i, lists_v = cand_i[at, split], cand_v[at, split]  # (Q, k, k)
    match = lists_i == sample_i[..., None]
    held = match.any(-1)
    got = lists_v.gather(-1, match.int().argmax(-1, keepdim=True)).squeeze(-1)
    same = got.view(torch.int32) == sample_v.view(torch.int32)
    if not bool(same[held].all()) or not bool(held.any()):
        raise AssertionError(f"{int((~same[held]).sum())} of {int(held.sum())} sample pairs "
                             "differ from the main run's sums")
    return int(held.sum())


def pass2_ms(by_kernel: dict) -> float:
    """Device ms of pass 2 (every level) in a ``device_ms_by_kernel`` row."""
    return sum(ms for name, ms in by_kernel.items() if "score_topk_merge" in name)


def kernels_phase(card: dict, n_docs: int, seed: int) -> dict:
    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.kernels.topk import (
        NO_INDEX, STREAM_MMA_STAGE_BYTES, STREAM_MMA_STAGES, STREAM_WARPS,
        STREAM_WIDE_K, WIDE_K, call_plan, candidates_reference, kth, merge_occupancy,
        merge_plan, merge_topk_cuda, merge_topk_reference, plan, ring_block, ring_occupancy,
        ring_smem, ring_takes, score_topk_candidates, score_topk_cuda, score_topk_sample,
        stream_mma_occupancy, stream_mma_smem, stream_occupancy, stream_smem, tiles_occupancy,
        tiles_smem)
    from twotowers_tpu_torch.ops.topk_score import score_topk, score_topk_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tiles_blocks, stream_blocks = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        # score_topk_tiles: k=10 takes the narrow selection (one thread a
        # query; bf16 alone, f32 takes the ring below), k=256 the wide one
        # (warps); each needs no spills and 2 blocks an SM, 3 at k=10. f32
        # docs sum on the CUDA cores, bf16 on the tensor cores
        engine = "mma.sync m16n8k16 bf16" if dtype == torch.bfloat16 else "fmaf f32"
        ks = (10, 256) if dtype == torch.bfloat16 else (256,)
        occupancy = {f"k{k}": {**tiles_occupancy(dev, dtype, k),
                               "selection": "wide" if k > WIDE_K else "narrow",
                               "engine": engine}
                     for k in ks}
        tiles_blocks[str(dtype)] = occupancy
        emit("kernels", case="Q >= 5 pass-1 block", dtype=str(dtype), engine=engine,
             **occupancy)
        for k, block in zip(ks, occupancy.values()):
            if (block["local_bytes"] or block["blocks_per_sm"] < (3 if k == 10 else 2)
                    or block["smem_bytes"] != tiles_smem(k)):
                raise AssertionError(f"Q >= 5 pass 1 at k={k}: spills, too few blocks "
                                     f"per SM or not topk.tiles_smem's bytes: {block}")
        # the Q <= 4 pass keeps 8 rows x 16 bytes in flight a lane, 32 KB a
        # block, where the card needs ~18 KB an SM; its launch bound asks for
        # 3 blocks an SM at Q=1 with the narrow selection (k <= STREAM_WIDE_K),
        # 2 with the wide one. It needs those, a block at Q=4, no spills
        for q, k in ((1, 10), (4, 10), (1, 256), (4, 256)):
            block = {**stream_occupancy(dev, dtype, q, 128, k),
                     "selection": "wide" if k > STREAM_WIDE_K else "narrow"}
            stream_blocks[f"{str(dtype)[6:]} q{q} k{k}"] = block
            emit("kernels", case="Q <= 4 pass-1 block", dtype=str(dtype), q=q, d=128, k=k,
                 in_flight_bytes_per_sm=block["blocks_per_sm"] * 8 * 32 * 8 * 16, **block)
            need = (3 if k <= STREAM_WIDE_K else 2) if q == 1 else 1
            if (block["local_bytes"] or block["blocks_per_sm"] < need
                    or block["smem_bytes"] != stream_smem(q, 128, k)):
                raise AssertionError(f"Q <= 4 pass 1 at Q={q}, k={k}: spills, too few blocks "
                                     f"per SM or not topk.stream_smem's bytes: {block}")
    # bf16 docs at Q = 2-4 take score_topk_stream_mma (the tensor cores): each
    # warp keeps STREAM_MMA_STAGES - 1 stages of 4 KB in flight in its own
    # cp.async ring, where the card needs ~18 KB an SM; no spills, a block an
    # SM, topk.stream_mma_smem's bytes
    mma_blocks = {}
    for q in (2, 3, 4):
        for k in (10, 256):
            block = {**stream_mma_occupancy(dev, q, 128, k), "selection": "wide",
                     "engine": "mma.sync m16n8k16 bf16"}
            block["in_flight_bytes_per_sm"] = (block["blocks_per_sm"] * STREAM_WARPS
                                               * (STREAM_MMA_STAGES - 1) * STREAM_MMA_STAGE_BYTES)
            mma_blocks[f"q{q} k{k}"] = block
            emit("kernels", case="Q <= 4 pass-1 block", kernel="score_topk_stream_mma",
                 dtype="torch.bfloat16", q=q, d=128, k=k, **block)
            if (block["local_bytes"] or block["blocks_per_sm"] < 1
                    or block["smem_bytes"] != stream_mma_smem(q, 128, k)
                    or block["in_flight_bytes_per_sm"] < 18 * 1024):
                raise AssertionError(f"bf16 Q <= 4 pass 1 at Q={q}, k={k}: spills, no block an "
                                     "SM, not topk.stream_mma_smem's bytes or under 18 KB in "
                                     f"flight: {block}")

    # f32 docs at Q >= 5 and k <= WIDE_K take score_topk_tiles_ring: a TMA
    # ring of doc tiles, fmaf on the CUDA cores, a selection a warp's own. Each
    # block (4 x 2 warps of queries x docs at Q <= 32, 8 x 1 above, with 6
    # docs a lane on splits of RING_LONG_SPLIT docs or more): no spills,
    # topk.ring_smem's bytes and topk.ring_block's shape, 2 blocks an SM
    ring_blocks = {}
    for q, split_len, name in ((32, 0, "q32"), (256, 0, "q256"),
                               (256, topk.RING_LONG_SPLIT, "q256 long splits")):
        block = {**ring_occupancy(dev, q, 10, split_len), "selection": "narrow, a warp's own",
                 "engine": "fmaf f32, TMA ring refilled by each slot's last reader"}
        ring_blocks[name] = block
        emit("kernels", case="Q >= 5 pass-1 block", kernel="score_topk_tiles_ring",
             dtype="torch.float32", q=q, k=10, split_len=split_len, **block)
        if (block["local_bytes"] or block["blocks_per_sm"] < 2
                or block["smem_bytes"] != ring_smem(q, split_len)
                or (block["block_queries"], block["tile_docs"]) != ring_block(q, split_len)):
            raise AssertionError(f"f32 Q >= 5 ring pass at Q={q}, splits of {split_len}: spills, "
                                 "under 2 blocks an SM, or not topk.ring_smem's bytes or "
                                 f"ring_block's shape: {block}")

    def unit(*shape):
        x = torch.randn(*shape, device=dev, generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    def check(case, docs, queries, k, n_real=None, exact=False, mma=None):
        """Hold score_topk_cuda against the plain version; ``mma``: whether
        pass 1 must (True) or must not (False) take score_topk_stream_mma.
        Pass 1 takes score_topk_tiles_ring exactly where topk.ring_takes."""
        before, ring_before = topk.STREAM_MMA_LAUNCHES, topk.RING_LAUNCHES
        got = score_topk_cuda(docs, queries, k, n_real)
        torch.cuda.synchronize()
        if mma is not None and topk.STREAM_MMA_LAUNCHES - before != int(mma):
            raise AssertionError(f"{case}: pass 1 {'did not take' if mma else 'took'} "
                                 "score_topk_stream_mma")
        ring = ring_takes(docs.dtype, queries.shape[0], k)
        if topk.RING_LAUNCHES - ring_before != int(ring):
            raise AssertionError(f"{case}: pass 1 {'did not take' if ring else 'took'} "
                                 "score_topk_tiles_ring")
        want = score_topk_reference(docs, queries, k, n_real)
        err, swaps = agree(docs, queries, got, want, n_real, rel=0.0 if exact else 1e-5)
        if exact and not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{case}: not bit-equal to the plain version")
        emit("kernels", case=case, n=docs.shape[0], d=docs.shape[1], q=queries.shape[0],
             k=k, dtype=str(docs.dtype), max_abs_err=err, near_tie_swaps=swaps,
             ring=ring)
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
    check("q33 n-1", docs[:n_docs - 1], unit(33, 128), 10)
    docs100, q100 = unit(n_docs, 100), unit(257, 100)
    check("q257 d100 f32", docs100, q100, 10)
    check("q257 d100 bf16 (scalar staging)", docs100.bfloat16(), q100, 10)
    del docs100
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
    # the Q >= 5 pass at large k (the wide selection)
    check("k=256 bf16", docs_bf16, queries[32], 256)
    check("q257 k=256", docs, unit(257, 128), 256)
    check("n_docs < N k=256", padded, queries[32], 256, n_real=5000)
    ones32 = torch.zeros(32, 16, device=dev)
    ones32[:, 0] = 1.0
    check("all scores tied q32 k=256", tied, ones32, 256)
    got_i = score_topk_cuda(tied, ones32, 256)[1]
    if not torch.equal(got_i.cpu(), torch.arange(256, dtype=torch.int32).repeat(32, 1)):
        raise AssertionError("all scores tied at Q=32, k=256 must return docs 0..255")
    check("N=1000 < 4096", docs[:1000], queries[32], 10)
    ints = torch.randint(-2, 3, (n_docs // 4, 64), device=dev, generator=gen).float()
    qints = torch.randint(-2, 3, (64, 64), device=dev, generator=gen).float()
    check("integer-valued", ints, qints, 32, exact=True)
    # the f32 ring pass (k <= WIDE_K) on integers, bit-equal: both block
    # shapes, and docs one float past 16-byte alignment (its 4-byte copies)
    check("integer-valued q64 k14 (ring)", ints, qints, 14, exact=True)
    check("integer-valued q32 k10 (ring)", ints, qints[:32], 10, exact=True)
    ints_off32 = ints.view(-1)[1:1 + (ints.shape[0] - 1) * 64].view(-1, 64)
    check("off alignment q33 k10 f32 (ring, 4-byte copies)", ints_off32, qints[:33], 10,
          exact=True)
    del ints_off32
    for q, k in ((32, 10), (64, 14)):  # its pass 1 alone: each split's top-k
        got = score_topk_candidates(ints, qints[:q], k, 240_000)
        pass1, _, split_len = call_plan(ints, q, k)
        want = candidates_reference(ints, qints[:q], k, split_len, 240_000)
        if pass1 != topk.PASS_TILES_RING or not (
                torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"ring pass 1 q{q} k{k}: not the plain per-split top-k")
        emit("kernels", case=f"ring pass-1 lists q{q} k{k}", n=ints.shape[0], d=64,
             n_splits=got[0].shape[1], split_len=split_len, bit_equal=True)
    long_row = ring_long_splits(card, check, call_plan, topk_bound, seed)
    # bf16 docs at Q >= 5 sum on the tensor cores: exact on integers, in
    # another order than cuBLAS on floats (data from its own generator)
    mma_gen = torch.Generator(device=dev).manual_seed(seed + 2)
    check("integer-valued bf16 q64 (tensor cores)", ints.bfloat16(), qints, 32, exact=True)
    q257 = torch.randint(-2, 3, (257, 64), device=dev, generator=mma_gen).float()
    check("integer-valued bf16 q257 k=256 (tensor cores)", ints.bfloat16(), q257, 256,
          exact=True)
    wide = torch.randn(n_docs // 4, 1024, device=dev, generator=mma_gen)
    wide = (wide / wide.norm(dim=1, keepdim=True)).bfloat16()
    q1024 = torch.randn(257, 1024, device=dev, generator=mma_gen)
    q1024 /= q1024.norm(dim=1, keepdim=True)
    for k in (10, 256):
        check(f"bf16 q257 d1024 k={k} (tensor cores)", wide, q1024, k)
    del wide
    # the Q <= 4 pass: twins of the cases above at Q=1 (and Q=4)
    check("ragged n q1", docs[:ragged], queries[1], 10)
    check("ragged n q4 bf16", docs_bf16[:ragged], unit(4, 128), 10)
    check("n_docs < N q1", padded, queries[1], 10, n_real=5000)
    check("n_docs < N q3 bf16", padded.bfloat16(), unit(3, 128), 10, n_real=5000)
    docs100, q100 = unit(n_docs, 100), unit(1, 100)
    check("q1 d100 f32", docs100, q100, 10)
    check("q1 d100 bf16 (scalar fill)", docs100.bfloat16(), q100, 10)
    del docs100
    check("all scores tied q1", tied, ones[:1], 256)
    check("k=256 q1", docs, queries[1], 256)
    check("k=256 q4 bf16", docs_bf16, unit(4, 128), 256)
    check("integer-valued q1", ints, qints[:1], 32, exact=True)
    check("integer-valued q4 bf16", ints.bfloat16(), qints[:4], 256, exact=True)
    # the Q <= 4 pass's wide selection (k > STREAM_WIDE_K): survivors batched
    # a warp, the warp lists merged by a tree; and both sides of the threshold
    queries[4] = unit(4, 128)
    check("k=256 q2", docs, unit(2, 128), 256)
    check("k=256 q3 bf16", docs_bf16, unit(3, 128), 256)
    for q in (1, 4):
        for k in (STREAM_WIDE_K, STREAM_WIDE_K + 1):
            check(f"k={k} q{q} (STREAM_WIDE_K {STREAM_WIDE_K})", docs, queries[q], k)
        check(f"all scores tied q{q} k=256", tied, ones[:q], 256)
        got_i = score_topk_cuda(tied, ones[:q], 256)[1]
        if not torch.equal(got_i.cpu(), torch.arange(256, dtype=torch.int32).repeat(q, 1)):
            raise AssertionError(f"all scores tied at Q={q}, k=256 must return docs 0..255")
        check(f"integer-valued q{q} k=256", ints, qints[:q], 256, exact=True)
        # zero rows of either sign score 0 and tie; the rest score below
        signed = -torch.rand(8192, 16, device=dev, generator=gen)
        zero = torch.rand(8192, device=dev, generator=gen) < 0.25
        signed[zero] = torch.where(torch.rand(int(zero.sum()), 16, device=dev, generator=gen) < 0.5,
                                   -0.0, 0.0)
        check(f"signed zeros tied q{q} k=256", signed, torch.ones(q, 16, device=dev), 256,
              exact=True)
        got_i = score_topk_cuda(signed, torch.ones(q, 16, device=dev), 256)[1]
        if not torch.equal(got_i.cpu(), zero.nonzero()[:256, 0].int().cpu().repeat(q, 1)):
            raise AssertionError(f"zero scores of either sign at Q={q} must tie by index")
    check("split shorter than k q1 k=256", docs[:1000], queries[1], 256)
    check("n_docs < N q1 k=256", padded, queries[1], 256, n_real=5000)
    # bf16 docs at Q = 2-4 on the tensor cores (score_topk_stream_mma): float
    # docs by agree, ragged N, rows past n_docs, integer-valued docs bit-equal
    # (exact sums in any order), the same bits from two calls; off 16-byte
    # alignment (a view one element in, or D=100) score_topk_stream by the
    # route rule (topk.stream_mma_takes), bit-equal on integers
    ints_bf16 = ints.bfloat16()
    flat = ints_bf16.view(-1)
    ints_off = flat[1:1 + (ints.shape[0] - 1) * 64].view(-1, 64)  # 2 bytes past alignment
    for q in (2, 3):
        queries[q] = unit(q, 128)
    for q in (2, 3, 4):
        for k in (10, 100, 256):
            check(f"tensor-core stream q{q} k={k} bf16", docs_bf16, queries[q], k, mma=True)
        check(f"tensor-core stream ragged n q{q} bf16", docs_bf16[:ragged], queries[q], 256,
              mma=True)
        check(f"tensor-core stream n_docs < N q{q} bf16", padded.bfloat16(), queries[q], 10,
              n_real=5000, mma=True)
        for k in (10, 256):
            check(f"tensor-core stream integer-valued q{q} k={k} bf16", ints_bf16, qints[:q], k,
                  exact=True, mma=True)
            check(f"off alignment q{q} k={k} bf16 (score_topk_stream)", ints_off, qints[:q], k,
                  exact=True, mma=False)
        once, twice = (score_topk_cuda(docs_bf16, queries[q], 256) for _ in range(2))
        if not (torch.equal(once[0].view(torch.int32), twice[0].view(torch.int32))
                and torch.equal(once[1], twice[1])):
            raise AssertionError(f"tensor-core stream q{q}: two calls gave other bits")
    check("d100 q3 bf16 (score_topk_stream)", unit(4096, 100).bfloat16(), unit(3, 100), 10,
          mma=False)
    del ints_off, flat
    # pass 1 alone on the tensor cores: each split's lists bit for bit the
    # plain per-split top-k under the call's plan (integer-valued)
    for q, k in ((2, 10), (4, 256)):
        got = score_topk_candidates(ints_bf16, qints[:q], k, 240_000)
        pass1, _, split_len = call_plan(ints_bf16, q, k)
        want = candidates_reference(ints_bf16, qints[:q], k, split_len, 240_000)
        if pass1 != topk.PASS_STREAM_MMA or not (
                torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"tensor-core stream pass 1 q{q} k{k}: not the plain "
                                 "per-split top-k")
        emit("kernels", case=f"tensor-core stream pass-1 lists q{q} k{k}", n=ints.shape[0],
             d=64, n_splits=got[0].shape[1], split_len=split_len, bit_equal=True)

    # the bf16 small-batch path (a caller's score_topk against a bf16 index
    # at Q = 2-4): the counts zeroed just before it and read just after
    topk.LAUNCHES = topk.STREAM_MMA_LAUNCHES = 0  # the path starts here
    small = {(q, k): score_topk(docs_bf16, queries[q], k) for q in (2, 3, 4) for k in (10, 256)}
    torch.cuda.synchronize()
    small_launches = {"score_topk": topk.LAUNCHES,
                      "score_topk_stream_mma": topk.STREAM_MMA_LAUNCHES}  # the path ends here
    emit("kernels", case="bf16 small-batch path", launches=small_launches)
    if small_launches != {"score_topk": len(small), "score_topk_stream_mma": len(small)}:
        raise AssertionError(f"bf16 Q = 2-4 searches: {small_launches}")
    for (q, k), got in small.items():
        agree(docs_bf16, queries[q], got, score_topk_reference(docs_bf16, queries[q], k))

    # pass 1 alone: the Q >= 5 pass's lists at Q=32, k=256 against the plain
    # per-split top-k under the same plan, bit for bit (integer-valued)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        d, qs = ints.to(dtype), qints[:32]
        got = score_topk_candidates(d, qs, 256)
        split_len = plan(32, d.shape[0], sm_count,
                         tiles_occupancy(dev, dtype, 256)["blocks_per_sm"])[2]
        want = candidates_reference(d, qs, 256, split_len)
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"pass 1 q32 k256 {dtype}: not the plain per-split top-k")
        real = torch.isfinite(want[0])  # the padding's -inf - -inf is nan
        emit("kernels", case=f"pass-1 lists q32 k256 {dtype}", n=d.shape[0], d=64,
             n_splits=got[0].shape[1], split_len=split_len, bit_equal=True,
             max_abs_err=float((got[0][real] - want[0][real]).abs().max()))

    # pass 1 barred (the Q >= 5 wide selection): each query's k-th pair of
    # the call's sample run (tiles spread over the docs) bars every split,
    # which keeps its top-k among the pairs at or before it; bit for bit the
    # plain barred per-split top-k, on integer-valued, all-tied and
    # signed-zero docs
    bar_gen = torch.Generator(device=dev).manual_seed(seed + 3)  # leaves `gen` as it was
    tied_n = 524_288
    tied_big = torch.zeros(tied_n, 16, device=dev)
    tied_big[:, 0] = 1.0
    signed_big = -torch.rand(tied_n, 16, device=dev, generator=bar_gen)
    zero_rows = torch.rand(tied_n, device=dev, generator=bar_gen) < 0.25
    signed_big[zero_rows] = torch.where(
        torch.rand(int(zero_rows.sum()), 16, device=dev, generator=bar_gen) < 0.5, -0.0, 0.0)
    barred_lists = {}
    for kind, base, qsets in (("integer", ints, (qints[:32], q257)),
                              ("tied", tied_big, (torch.ones(32, 16, device=dev),
                                                  torch.ones(257, 16, device=dev))),
                              ("signed-zero", signed_big, (torch.ones(32, 16, device=dev),
                                                           torch.ones(257, 16, device=dev)))):
        for dtype in (torch.float32, torch.bfloat16):
            d = base.to(dtype)
            for qs in qsets:
                q = qs.shape[0]
                top = score_topk_sample(d, qs, 256)
                if top is None:
                    raise AssertionError(f"barred pass 1 {kind} q{q}: the call takes no bar")
                bar = kth(top, 256)
                got = score_topk_candidates(d, qs, 256, bar=bar)
                split_len = plan(q, d.shape[0], sm_count,
                                 tiles_occupancy(dev, dtype, 256)["blocks_per_sm"])[2]
                want = candidates_reference(d, qs, 256, split_len, bar=bar)
                if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"barred pass 1 {kind} q{q} k256 {dtype}: not the "
                                         "plain barred per-split top-k")
                real = int((got[1] != NO_INDEX).sum())
                case = f"barred pass-1 lists {kind} q{q} k256 {str(dtype)[6:]}"
                barred_lists[case] = {"n": d.shape[0], "n_splits": got[0].shape[1],
                                      "real_pairs_per_list": real / (q * got[0].shape[1]),
                                      "sample_plan": top[2]}
                emit("kernels", case=case, **barred_lists[case], bit_equal=True)
    del tied_big, signed_big
    # the bar is exact only if the sample run sums each (query, doc) pair
    # as the main run does: float docs, the sample run's top pairs that the
    # main run's lists hold have the same bits there
    sample_sums = {}
    for dtype, d in ((torch.float32, docs), (torch.bfloat16, docs_bf16)):
        for qs in (queries[32], q1024[:, :128].contiguous()):
            q = qs.shape[0]
            sample_v, sample_i, sample = score_topk_sample(d, qs, 256)
            cands = score_topk_candidates(d, qs, 256)
            split_len = plan(q, d.shape[0], sm_count,
                             tiles_occupancy(dev, dtype, 256)["blocks_per_sm"])[2]
            held = sample_pairs_in_main(sample_v, sample_i, *cands, split_len)
            sample_sums[f"q{q} {str(dtype)[6:]}"] = held
            emit("kernels", case=f"sample sums q{q} k256 {dtype}", pairs_bit_equal=held,
                 sample_plan=sample, split_len=split_len)

    # pass 2 alone: the kernel's merge of the same lists as the plain
    # merge's, bit for bit; level 1 writes in place, so it gets a copy
    def merge_check(case, cand_v, cand_i, final=None):
        want = merge_topk_reference(cand_v, cand_i)
        got = merge_topk_cuda(cand_v.clone(), cand_i.clone())
        torch.cuda.synchronize()
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"merge {case}: not bit-equal to the plain merge")
        if final is not None and not (torch.equal(got[0], final[0])
                                      and torch.equal(got[1], final[1])):
            raise AssertionError(f"merge {case}: not score_topk_cuda's result")
        q, s, k = cand_v.shape
        group, levels, smem = merge_plan(s, k)
        emit("kernels", case=f"merge {case}", q=q, s=s, k=k, group=group, levels=levels,
             smem_bytes=smem, max_abs_err=float((got[0] - want[0]).abs().max()),
             bit_equal=True)

    merge_blocks = {}
    for dtype, d in ((torch.float32, docs), (torch.bfloat16, docs_bf16)):
        cands = score_topk_candidates(d, queries[1], 256)
        merge_check(f"pass-1 lists q1 k256 {dtype}", *cands,
                    final=score_topk_cuda(d, queries[1], 256))
        group, levels, _ = merge_plan(cands[0].shape[1], 256)
        groups = -(-cands[0].shape[1] // group)
        merge_blocks[str(dtype)] = {
            "n_splits": cands[0].shape[1], "group": group, "levels": levels,
            "level1": merge_occupancy(dev, False, group, 256) if levels == 2 else None,
            "last": merge_occupancy(dev, True, groups if levels == 2 else group, 256)}
        emit("kernels", case="pass-2 blocks q1 k256", dtype=str(dtype), **merge_blocks[str(dtype)])
        if any(b and b["local_bytes"] for b in (merge_blocks[str(dtype)]["level1"],
                                                 merge_blocks[str(dtype)]["last"])):
            raise AssertionError(f"pass 2 spills: {merge_blocks[str(dtype)]}")
    merge_gen = torch.Generator(device=dev).manual_seed(seed + 1)  # leaves `gen` as it was
    for s_, k_, kind in ((1, 256, "random"), (33, 256, "random"), (1024, 256, "random"),
                         (1024, 10, "random"), (1024, 256, "tied")):
        merge_check(f"crafted s{s_} k{k_} {kind}", *crafted_lists(4, s_, k_, kind, merge_gen))

    timings = {}
    for (q, dtype, k) in [(1, torch.float32, 10), (4, torch.float32, 10),
                          (32, torch.float32, 10), (256, torch.float32, 10),
                          (1, torch.bfloat16, 10), (4, torch.bfloat16, 10),
                          (32, torch.bfloat16, 10), (256, torch.bfloat16, 10),
                          (1, torch.float32, 256), (1, torch.bfloat16, 256),
                          (32, torch.float32, 256), (256, torch.float32, 256),
                          (32, torch.bfloat16, 256), (256, torch.bfloat16, 256),
                          (32, torch.float32, 100), (4, torch.float32, 256),
                          (4, torch.bfloat16, 256), (1, torch.float32, 100),
                          (2, torch.bfloat16, 10), (3, torch.bfloat16, 10),
                          (2, torch.bfloat16, 256), (3, torch.bfloat16, 256)]:
        d = docs if dtype == torch.float32 else docs_bf16
        qs = queries[q]
        bound, bound_by = topk_bound(n_docs, 128, q, k, dtype)
        row = {
            "ms": cuda_ms(lambda: score_topk_cuda(d, qs, k)),
            "plain_ms": cuda_ms(lambda: score_topk_reference(d, qs, k)),
            "library_ms": cuda_ms(lambda: torch.topk(qs.to(dtype) @ d.T, k)),
            "bound_ms": bound, "bound_by": bound_by,
        }
        if q == 1 or k >= 100:  # pass 1 and each level of pass 2 apart
            row["device_ms_by_kernel"] = device_ms_by_kernel(lambda: score_topk_cuda(d, qs, k))
            row["pass2_ms"] = pass2_ms(row["device_ms_by_kernel"])
            row["pass1_ms"] = sum(ms for name, ms in row["device_ms_by_kernel"].items()
                                  if "score_topk_tiles" in name or "score_topk_stream" in name)
            # pass1_ms and pass2_ms hold its sample runs' too
            top = score_topk_sample(d, qs, k)
            row["sample_plan"] = top and top[2]
            row["sample_ms"] = cuda_ms(lambda: score_topk_sample(d, qs, k)) if top else 0.0
        timings[(q, dtype, k)] = row
        emit("kernels", case=f"time q{q} {dtype} k{k}", n=n_docs, d=128, k=k, **row,
             card=card["nvidia_smi"])
    return {"max_abs_err": max(errs), **timings[(256, torch.float32, 10)],
            "q1_f32": timings[(1, torch.float32, 10)],
            "q1_k256": {"f32": timings[(1, torch.float32, 256)],
                        "bf16": timings[(1, torch.bfloat16, 256)],
                        "q4 f32": timings[(4, torch.float32, 256)],
                        "q4 bf16": timings[(4, torch.bfloat16, 256)],
                        "k100 f32": timings[(1, torch.float32, 100)]},
            "batch_large_k": {f"q{q} k{k} {str(dtype)[6:]}": timings[(q, dtype, k)]
                              for q, dtype, k in ((32, torch.float32, 256),
                                                  (256, torch.float32, 256),
                                                  (32, torch.bfloat16, 256),
                                                  (256, torch.bfloat16, 256),
                                                  (32, torch.float32, 100))},
            "barred_lists": barred_lists, "sample_sums": sample_sums,
            "batch_bf16": {f"q{q} k{k}": timings[(q, torch.bfloat16, k)]
                           for q in (32, 256) for k in (10, 256)},
            "tiles_blocks": tiles_blocks, "stream_blocks": stream_blocks,
            "merge_blocks": merge_blocks, "stream_mma_blocks": mma_blocks,
            "ring_blocks": ring_blocks,
            "batch_f32": {**{f"q{q}": timings[(q, torch.float32, 10)] for q in (32, 256)},
                          f"q256 n{SERVE_DOCS}": long_row},
            "stream_bf16": {f"q{q} k{k}": timings[(q, torch.bfloat16, k)]
                            for q in (2, 3, 4) for k in (10, 256)},
            "small_batch_launches": small_launches,
            "torch_route": torch_route_rows(card, docs_bf16, queries[32], gen)}


SERVE_DOCS = 8_841_823  # the benchmark's MS MARCO-sized index (serve-batch256-msmarco)


def ring_long_splits(card: dict, check, call_plan, topk_bound, seed: int) -> dict:
    """The ring pass's block of long splits (6 docs a lane above 32 queries
    on splits of ``topk.RING_LONG_SPLIT`` docs or more, the block of the
    batch searches over the serve index): integer-valued docs bit-equal to
    the plain version at Q=256 and 257 over 4,400,000 rows of D=128 (splits
    of 66,688 and 83,072 docs, each split's last tile of 192 ragged), its
    route asserted by ``call_plan`` and ``RING_LAUNCHES``; then Q=256, k=10
    over ``SERVE_DOCS`` unit docs (the serve cell's shape) held by ``agree``
    and timed against the plain version, the bound and the library."""
    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.kernels.topk import score_topk_cuda
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)  # leaves the phase's own as it was
    ints = torch.randint(-2, 3, (4_400_000, 128), device=dev, generator=gen).float()
    qints = torch.randint(-2, 3, (257, 128), device=dev, generator=gen).float()
    for q, k in ((256, 10), (257, 14)):
        split_len = call_plan(ints, q, k)[2]
        if split_len < topk.RING_LONG_SPLIT or topk.ring_lane_docs(q, split_len) != 6:
            raise AssertionError(f"q{q} over {ints.shape[0]} rows: splits of {split_len} docs "
                                 "do not take the ring's block of long splits")
        check(f"integer-valued q{q} k{k} (ring, splits of {split_len}: 6 docs a lane)", ints,
              qints[:q], k, exact=True)
    del ints
    docs = torch.randn(SERVE_DOCS, 128, device=dev, generator=gen)
    docs /= docs.norm(dim=1, keepdim=True)
    queries = torch.randn(256, 128, device=dev, generator=gen)
    queries /= queries.norm(dim=1, keepdim=True)
    check("serve index q256 k10 f32 (ring, 6 docs a lane)", docs, queries, 10)
    bound, bound_by = topk_bound(SERVE_DOCS, 128, 256, 10, torch.float32)
    row = {"ms": cuda_ms(lambda: score_topk_cuda(docs, queries, 10)),
           "plain_ms": cuda_ms(lambda: score_topk_reference(docs, queries, 10)),
           "library_ms": cuda_ms(lambda: torch.topk(queries @ docs.T, 10)),
           "bound_ms": bound, "bound_by": bound_by,
           "split_len": call_plan(docs, 256, 10)[2]}
    emit("kernels", case=f"time q256 torch.float32 k10 n{SERVE_DOCS}", n=SERVE_DOCS, d=128,
         k=10, **row, card=card["nvidia_smi"])
    del docs
    torch.cuda.empty_cache()
    return row


def torch_route_rows(card: dict, docs_bf16, queries, gen) -> list:
    """``score_topk`` on bf16 docs and f32 queries at shapes the kernel does
    not take, so the torch route: queries rounded as the JAX dispatcher
    rounds them. k=300 at D=128 is scored unrounded (``score_topk_xla``'s
    rule): its results are ``score_topk_unrounded``'s, its scores within
    1e-5 of an f64 rescoring of its indices with unrounded queries, and the
    casting version's scores are not. k=10 at D=1040 keeps the Pallas
    kernel's cast (``score_topk_reference``), held the same way with the
    queries rounded to bf16."""
    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.ops import topk_score

    plain = {"unrounded": topk_score.score_topk_unrounded, "cast": topk_score.score_topk_reference}
    dev = docs_bf16.device
    wide = torch.randn(docs_bf16.shape[0], 1040, device=dev, generator=gen)
    wide = (wide / wide.norm(dim=1, keepdim=True)).bfloat16()
    q_wide = torch.randn(queries.shape[0], 1040, device=dev, generator=gen)
    q_wide = q_wide / q_wide.norm(dim=1, keepdim=True)
    rows = []
    for docs, q, k, rule, other in ((docs_bf16, queries, 300, "unrounded", "cast"),
                                    (wide, q_wide, 10, "cast", "unrounded")):
        launches, calls = topk.LAUNCHES, topk_score.TORCH_ROUTE_CALLS
        got_v, got_i = topk_score.score_topk(docs, q, k)
        torch.cuda.synchronize()
        if topk.LAUNCHES != launches or topk_score.TORCH_ROUTE_CALLS != calls + 1:
            raise AssertionError(f"D={docs.shape[1]} k={k}: not the torch route alone")
        want_v, want_i = plain[rule](docs, q, k)
        if not (torch.equal(got_i, want_i) and torch.equal(got_v, want_v)):
            raise AssertionError(f"D={docs.shape[1]} k={k}: not {plain[rule].__name__}'s result")

        def f64_gap(scores, idx, rounding):  # |scores - f64 scores of idx| by a rule
            q64 = q.double() if rounding == "unrounded" else q.to(docs.dtype).double()
            want64 = (docs[idx.long()].double() * q64[:, None, :]).sum(-1)  # (Q, k)
            return float((scores.double() - want64).abs().max())

        err = f64_gap(got_v, got_i, rule)
        other_err = f64_gap(*plain[other](docs, q, k), rule)
        if err > 1e-5 or other_err <= 1e-5:
            raise AssertionError(f"D={docs.shape[1]} k={k}: {err} from the {rule} f64 scores, "
                                 f"the {other} version {other_err}")
        row = {"case": f"torch route {rule} bf16 docs f32 queries", "n": docs.shape[0],
               "d": docs.shape[1], "q": q.shape[0], "k": k, "rule": rule,
               "plain": plain[rule].__name__, "max_abs_err_f64": err,
               f"{other}_max_abs_err_f64": other_err,
               "ms": cuda_ms(lambda: topk_score.score_topk_torch(docs, q, k)),
               "card": card["nvidia_smi"]}
        emit("kernels", **row)
        rows.append(row)
    return rows


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
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference, score_topk_unrounded
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

    topk.LAUNCHES = topk.RING_LAUNCHES = 0  # the main path starts here
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
    want_v, want_i = score_topk_unrounded(device_unit, q_vec, 300, n_index)
    got_i = torch.tensor([[position[r["document"]] for r in wide]], dtype=torch.int32)
    got_v = torch.tensor([[1.0 - r["distance"] for r in wide]])
    if len(wide) != 300 or not torch.equal(got_i, want_i.cpu()):
        raise AssertionError(f"top_k=300: {len(wide)} results, not the plain version's")
    wide_err = float((got_v - want_v.cpu()).abs().max())
    if wide_err > 1e-6:  # 1 - (1 - s) in f64 on the host
        raise AssertionError(f"top_k=300 scores differ by {wide_err}")

    launches = topk.LAUNCHES  # the main path ends here
    ring_launches = topk.RING_LAUNCHES
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
    if ring_launches != len(batch_ms):  # each 256-query search_batch, f32 at k=10
        raise AssertionError(f"{ring_launches} score_topk_tiles_ring launches for "
                             f"{len(batch_ms)} batch searches")
    serve = {"n_docs": n_docs, "setup_s": setup_s, "add_docs_per_s": n_docs / add_s,
             "index_docs_per_s": n_docs / index_s, "search_p50_ms": statistics.median(search_ms),
             "search_ms": search_ms, "search_batch_256_ms": batch_ms[0],
             "search_batch_256_again_ms": batch_ms[1],
             "batch_max_abs_err": err, "batch_near_tie_swaps": swaps,
             "top300_max_abs_err": wide_err, "score_topk_launches": launches,
             "score_topk_ring_launches": ring_launches,
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


def scatter_error(got, want, g, ids, vocab: int, out_dtype) -> tuple:
    """(max |kernel - plain|, whether it is within the tolerance) of a
    scatter-add. Tolerance: both sum f32 in other orders (the plain
    index_add_ by atomics, in an order that changes from run to run), so
    |kernel - plain| <= 1e-5 * the row's sum of |g| + 1e-6, plus one bf16
    ulp of the value for a bf16 output."""
    from twotowers_tpu_torch.kernels import scatter_add

    diff = (got.float() - want.float()).abs()
    scale = scatter_add.scatter_add_rows_reference(g.abs(), ids, vocab)
    step = 2.0 ** -7 if out_dtype == torch.bfloat16 else 0.0  # one bf16 ulp
    tol = 1e-5 * scale + 1e-6 + step * want.float().abs()
    return float(diff.max()), not bool((diff > tol).any())


# train-moonlight-b512's expert layer: tokens of a passage call (512 x 192)
# and of a query call (512 x 32), rows of width 2,048, 6 of 64 experts a
# token, experts 0-7 held
MOE_TOKENS, MOE_DIM, MOE_EXPERTS, MOE_HELD, MOE_TOP_K = (98_304, 16_384), 2048, 64, 8, 6


def moe_token_ids(n: int, gen: torch.Generator) -> torch.Tensor:
    """The ids of one expert layer's dispatch as ``MoE.order`` makes them:
    each of ``n`` tokens picks ``MOE_TOP_K`` of ``MOE_EXPERTS`` experts
    (uniformly here), and the picks of held experts, ordered by expert
    (stably, so by token within an expert), give their token positions."""
    scores = torch.rand(n, MOE_EXPERTS, device=gen.device, generator=gen)
    chosen = scores.topk(MOE_TOP_K, dim=-1).indices.flatten()
    key = torch.where(chosen < MOE_HELD, chosen, MOE_HELD)
    held = int((key < MOE_HELD).sum())
    return (torch.sort(key, stable=True).indices[:held] // MOE_TOP_K).to(torch.int32)


def embed_kernels_phase(card: dict, seed: int) -> dict:
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import gather, scatter_add

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    errs = {"scatter_add_rows": 0.0, "gather_rows": 0.0}
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count

    def scatter_check(case, g, ids, vocab, out_dtype=torch.float32, exact=False):
        """Kernel against the plain version (``scatter_error``); bit-equal
        where the sums are exact (integer g)."""
        got = scatter_add.scatter_add_rows(g, ids, vocab, out_dtype)
        torch.cuda.synchronize()
        want = scatter_add.scatter_add_rows_reference(g, ids, vocab, out_dtype)
        err, within = scatter_error(got, want, g, ids, vocab, out_dtype)
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"scatter {case}: not bit-equal to the plain version")
        elif not within:
            raise AssertionError(f"scatter {case}: max err {err} beyond tolerance")
        if not torch.equal(scatter_add.scatter_add_rows(g, ids, vocab, out_dtype), got):
            raise AssertionError(f"scatter {case}: two runs differ")
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"], err)
        emit("kernels", kernel="scatter_add_rows", case=case, n=g.shape[0], d=g.shape[1],
             v=vocab, g=str(g.dtype), out=str(out_dtype), max_abs_err=err,
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
    # the redesigned kernel's paths: runs that straddle a chunk, short N,
    # ids outside [0, V) in runs that cross chunks, scalar loads
    chunk = scatter_add.CHUNK
    for length in (chunk - 1, chunk, chunk + 1, 3 * chunk + 5):
        ids = np.concatenate([np.full(7, 3)] + [np.full(length, i) for i in range(5, 405)])
        ids = torch.from_numpy(rng.permutation(ids).astype(np.int32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            scatter_check(f"runs of {length} {dtype}", normal(len(ids), 64, dtype), ids, 640)
    scatter_check("n < chunk", normal(chunk // 2 + 3, 64), uniform_ids(16, chunk // 2 + 3), 16)
    scatter_check("n = 1", normal(1, 64, torch.bfloat16), uniform_ids(16, 1), 16)
    scatter_check("n = 1 integer-valued", ints[:1], main_ids[:1], WORD_VOCAB, exact=True)
    mixed = torch.cat([torch.full((3 * chunk,), -4, dtype=torch.int32, device=dev),
                       torch.full((2 * chunk + 9,), 640, dtype=torch.int32, device=dev),
                       torch.full((chunk + 1,), 2**31 - 1, dtype=torch.int32, device=dev),
                       uniform_ids(640, 50_000), torch.full((3 * chunk,), 9, dtype=torch.int32,
                                                            device=dev)])
    mixed = mixed[torch.randperm(len(mixed), device=dev, generator=gen)]
    for dtype in (torch.float32, torch.bfloat16):
        scatter_check(f"ids outside [0, V) in crossing runs {dtype}", normal(len(mixed), 64, dtype),
                      mixed, 640)
    for dtype in (torch.bfloat16, torch.float32):
        storage = normal(MAIN_ROWS * WORD_EMB + 1, 1, dtype).reshape(-1)
        g_off = storage[1:].view(MAIN_ROWS, WORD_EMB)  # a contiguous view, off 16-byte alignment
        if scatter_add.plan(MAIN_ROWS, WORD_EMB, dtype, g_off.data_ptr(), sm_count).vector:
            raise AssertionError("a misaligned g must take the scalar loads")
        scatter_check(f"g {g_off.element_size()} bytes off alignment {dtype}", g_off, main_ids,
                      WORD_VOCAB)

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
    gather_extra = gather_edge_cases(card, table, main_ids, rng, gen, sm_count)

    # the bounds at the experiments' shapes (#4-#6 of PERF.md's table): each
    # input read once, each output written once
    table_bytes = WORD_VOCAB * WORD_EMB * 4
    emit("kernels", case="bounds at the experiments' shapes", bound_by="bytes", bound_ms={
        "#4 scatter N 1,048,576 f32 g": bytes_bound(MAIN_ROWS * (WORD_EMB * 4 + 4)
                                                    + table_bytes)[0],
        "#5 scatter N 3,145,728 f32 g": bytes_bound(3 * MAIN_ROWS * (WORD_EMB * 4 + 4)
                                                    + table_bytes)[0],
        "#6 gather N 3,145,728 bf16 -> bf16": bytes_bound(3 * MAIN_ROWS * (4 + WORD_EMB * 2)
                                                          + table_bytes // 2)[0]})

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
    p = scatter_add.plan(MAIN_ROWS, WORD_EMB, g_main.dtype, g_main.data_ptr(), sm_count)
    scatter_row["plan"] = {"chunk": p.chunk, "team_lanes": p.team_lanes, "warps": p.warps,
                           "span_warps": p.span_warps, "span_blocks": p.span_blocks,
                           "smem_bytes": p.smem_bytes}
    scatter_row["blocks_per_sm"] = dict(zip(("pass1", "pass2"), scatter_add.occupancy(
        dev, g_main.dtype, torch.float32, p)))
    scatter_row["device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: scatter_add.scatter_add_sorted(g_main, sorted_ids, perm, WORD_VOCAB))
    emit("kernels", kernel="scatter_add_rows", case="time main bf16 g", n=MAIN_ROWS,
         d=WORD_EMB, v=WORD_VOCAB, **scatter_row, card=card["nvidia_smi"])
    emit("kernels", kernel="gather_rows", case="time main f32 -> bf16", n=MAIN_ROWS,
         d=WORD_EMB, v=WORD_VOCAB, **gather_row, card=card["nvidia_smi"])

    # times at the experiments' shapes (#4-#6 of PERF.md's table); the
    # library yardsticks read what the kernels read (f32 g; a bf16 table)
    g4, g5, ids5 = g_main.float(), normal(3 * MAIN_ROWS, WORD_EMB), exp2_ids.long()
    sorted5, perm5 = scatter_add.sort_ids(exp2_ids)
    for case, g, ids, ids64, s_ids, s_perm in [
            ("#4 exp_pallas_embed N 1,048,576 f32 g", g4, main_ids, ids64, sorted_ids, perm),
            ("#5 exp_pallas_embed2 N 3,145,728 f32 g", g5, exp2_ids, ids5, sorted5, perm5)]:
        n = g.shape[0]
        row = {
            "ms": cuda_ms(lambda: scatter_add.scatter_add_rows(g, ids, WORD_VOCAB)),
            "kernel_only_ms": cuda_ms(lambda: scatter_add.scatter_add_sorted(
                g, s_ids, s_perm, WORD_VOCAB)),
            "sort_ms": cuda_ms(lambda: scatter_add.sort_ids(ids)),
            "plain_ms": cuda_ms(lambda: scatter_add.scatter_add_rows_reference(
                g, ids, WORD_VOCAB)),
            "library_ms": cuda_ms(lambda: torch.zeros(WORD_VOCAB, WORD_EMB, device=dev)
                                  .index_add_(0, ids64, g)),
        }
        row["bound_ms"], row["bound_by"] = bytes_bound(n * (WORD_EMB * 4 + 4) + table_bytes)
        emit("kernels", kernel="scatter_add_rows", case=f"time {case}", n=n, d=WORD_EMB,
             v=WORD_VOCAB, **row, card=card["nvidia_smi"])
    table6 = table.bfloat16()
    row = {"ms": cuda_ms(lambda: gather.gather_rows(table6, exp2_ids, torch.bfloat16)),
           "plain_ms": cuda_ms(lambda: gather.gather_rows_reference(table6, exp2_ids,
                                                                   torch.bfloat16)),
           "library_ms": cuda_ms(lambda: F.embedding(ids5, table6))}
    row["bound_ms"], row["bound_by"] = bytes_bound(3 * MAIN_ROWS * (4 + WORD_EMB * 2)
                                                   + table_bytes // 2)
    emit("kernels", kernel="gather_rows", case="time #6 exp_pallas_embed2 N 3,145,728 bf16 -> bf16",
         n=3 * MAIN_ROWS, d=WORD_EMB, v=WORD_VOCAB, **row, card=card["nvidia_smi"])
    gather_row["plan"] = gather_extra.pop("plan")
    gather_row["blocks_per_sm"] = gather_extra.pop("blocks_per_sm")
    gather_row["device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: gather.gather_rows(table, main_ids, torch.bfloat16))
    gather_row["shapes"] = {"#6 exp_pallas_embed2 N 3,145,728 bf16 -> bf16": row,
                            **gather_extra.pop("shapes")}
    gather_row["host_us"] = gather_extra.pop("host_us")

    # an expert layer's dispatch (#3, backward #2) and combine (#2, backward
    # #3) at train-moonlight-b512's shapes; bounds: the ids, each distinct
    # token row read once, the rows written (a scatter-add writes every
    # token's row); the library calls read f32 where the kernel takes bf16
    scatter_row["moe"], gather_row["moe"] = {}, {}
    for n in MOE_TOKENS:
        ids = moe_token_ids(n, gen)
        a, ids64 = ids.shape[0], ids.long()
        distinct = int(torch.unique(ids).numel())
        x = normal(n, MOE_DIM, torch.bfloat16)
        for case, out_dtype, item in [("dispatch bf16 -> bf16", torch.bfloat16, 2),
                                      ("combine backward bf16 -> f32", torch.float32, 4)]:
            got = gather.gather_rows(x, ids, out_dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, gather.gather_rows_reference(x, ids, out_dtype)):
                raise AssertionError(f"gather moe {case} n {n}: not bit-equal")
            x_lib = x if out_dtype == torch.bfloat16 else x.float()
            row = {"ids": a, "distinct_tokens": distinct,
                   "ms": cuda_ms(lambda: gather.gather_rows(x, ids, out_dtype)),
                   "plain_ms": cuda_ms(lambda: gather.gather_rows_reference(x, ids, out_dtype)),
                   "library_ms": cuda_ms(lambda: F.embedding(ids64, x_lib))}
            row["bound_ms"], row["bound_by"] = bytes_bound(
                a * 4 + distinct * MOE_DIM * 2 + a * MOE_DIM * item)
            gather_row["moe"][f"{case} n {n}"] = row
            emit("kernels", kernel="gather_rows", case=f"moe {case}", n=a, d=MOE_DIM, v=n,
                 bit_equal=True, **row, card=card["nvidia_smi"])
        for case, g_dtype in [("combine f32 -> bf16", torch.float32),
                              ("dispatch backward bf16 -> bf16", torch.bfloat16)]:
            ints = torch.randint(-3, 4, (a, MOE_DIM), device=dev, generator=gen).to(g_dtype)
            scatter_check(f"moe {case} n {n} integer-valued", ints, ids, n, torch.bfloat16,
                          exact=True)
            g = normal(a, MOE_DIM, g_dtype)
            scatter_check(f"moe {case} n {n}", g, ids, n, torch.bfloat16)
            g32 = g.float()
            row = {"ids": a, "distinct_tokens": distinct,
                   "ms": cuda_ms(lambda: scatter_add.scatter_add_rows(g, ids, n, torch.bfloat16)),
                   "plain_ms": cuda_ms(lambda: scatter_add.scatter_add_rows_reference(
                       g, ids, n, torch.bfloat16)),
                   "library_ms": cuda_ms(lambda: torch.zeros(n, MOE_DIM, device=dev)
                                         .index_add_(0, ids64, g32))}
            row["bound_ms"], row["bound_by"] = bytes_bound(
                a * 4 + a * MOE_DIM * g.element_size() + n * MOE_DIM * 2)
            scatter_row["moe"][f"{case} n {n}"] = row
            emit("kernels", kernel="scatter_add_rows", case=f"moe {case} time", n=a, d=MOE_DIM,
                 v=n, **row, card=card["nvidia_smi"])
        del x, ints, g, g32
    return {"scatter_add_rows": {"max_abs_err": errs["scatter_add_rows"], **scatter_row},
            "gather_rows": {"max_abs_err": errs["gather_rows"], **gather_row}}


def gather_edge_cases(card: dict, table, main_ids, rng, gen, sm_count: int) -> dict:
    """Kernel #3 beyond the main shape: the Hub-serve encode (32 texts x 64
    ids) and a model rank's shard of the word step (524,288 ids less the
    shard's offset over its 16,384 rows, most outside it), timed; D = 1 to
    1,024 at N = 1, 31 and 5,003 in the four dtype pairs, a table 4 bytes
    off 16-byte alignment, and an output of more than 2**31 elements; each
    bit-equal to the plain version. Then the plan at the word step's shape
    and at the pretrained phase's (4,096 ids of a D=300 f32 table), the
    blocks an SM of the word step's kernel, and a call's host time at the
    pretrained and Hub-serve shapes beside ``F.embedding``'s and
    ``Embedding.forward``'s under inference mode."""
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import gather
    from twotowers_tpu_torch.kernels.gather_variants import CALLS, per_call_us
    from twotowers_tpu_torch.models.embeddings import Embedding, EmbeddingSpec

    dev = table.device

    def check(case, tab, ids, out_dtype, timed=False):
        before = gather.LAUNCHES
        got = gather.gather_rows(tab, ids, out_dtype)
        torch.cuda.synchronize()
        want = gather.gather_rows_reference(tab, ids, out_dtype)
        if gather.LAUNCHES != before + 1 or not torch.equal(got, want):
            raise AssertionError(f"gather {case}: not bit-equal to the plain version")
        del got, want
        row = {"n": ids.shape[0], "d": tab.shape[1], "table": str(tab.dtype),
               "out": str(out_dtype), "bit_equal": True}
        if timed:
            owned = ids[(ids >= 0) & (ids < tab.shape[0])]
            outside = float(1 - owned.numel() / ids.numel())
            ids64, lib_table = ids.long(), tab.to(out_dtype)
            row.update(
                outside=outside,
                ms=cuda_ms(lambda: gather.gather_rows(tab, ids, out_dtype)),
                device_ms_by_kernel=device_ms_by_kernel(
                    lambda: gather.gather_rows(tab, ids, out_dtype), reps=100),
                plain_ms=cuda_ms(lambda: gather.gather_rows_reference(tab, ids, out_dtype)),
                # F.embedding refuses ids outside the table
                library_ms=None if outside else cuda_ms(lambda: F.embedding(ids64, lib_table)))
            row["bound_ms"], row["bound_by"] = bytes_bound(
                ids.numel() * 4 + int(torch.unique(owned).numel()) * tab.shape[1]
                * tab.element_size() + ids.numel() * tab.shape[1] * out_dtype.itemsize)
        emit("kernels", kernel="gather_rows", case=case, **row, card=card["nvidia_smi"])
        return row

    shapes = {}
    serve_ids = torch.from_numpy(zipf_ids(rng, WORD_VOCAB, 32 * WORD_SEQ)).to(dev)
    shapes["Hub-serve encode 32 x 64 f32 -> bf16"] = check(
        "Hub-serve encode 32 x 64 f32 -> bf16", table, serve_ids, torch.bfloat16, timed=True)
    rows = WORD_VOCAB // 2  # model rank 1 of 2 holds rows 16,384-32,767
    shard_ids = main_ids[: MAIN_ROWS // 2] - rows
    shapes["model rank 1's shard f32 -> bf16"] = check(
        "model rank 1's shard f32 -> bf16", table[rows:], shard_ids, torch.bfloat16, timed=True)
    for dim in (1, 3, 12, 50, 300, 1024):
        tab = torch.randn(700, dim, device=dev, generator=gen)
        for n in (1, 31, 5003):
            ids = torch.randint(-3, 703, (n,), device=dev, generator=gen, dtype=torch.int32)
            for table_dtype in (torch.float32, torch.bfloat16):
                for out_dtype in (torch.float32, torch.bfloat16):
                    check(f"d {dim} n {n} {table_dtype} -> {out_dtype}", tab.to(table_dtype),
                          ids, out_dtype)
    storage = torch.randn(WORD_VOCAB * 300 + 1, device=dev, generator=gen)
    off = storage[1:].view(WORD_VOCAB, 300)  # 4 bytes off 16-byte alignment: one column a lane
    if gather.plan(4096, 300, off.dtype, torch.float32, off.data_ptr(), 0, sm_count).elems != 1:
        raise AssertionError("a table off 16-byte alignment must take one column a lane")
    for out_dtype in (torch.float32, torch.bfloat16):
        check(f"table 4 bytes off alignment -> {out_dtype}", off, main_ids[:5003], out_dtype)
    big = torch.randint(-3, WORD_VOCAB + 3, (2**25 + 7,), device=dev, generator=gen,
                        dtype=torch.int32)
    check("output of 2**31 + 448 elements f32 -> bf16", table, big, torch.bfloat16)
    del big, storage, off

    main = gather.plan(MAIN_ROWS, WORD_EMB, table.dtype, torch.bfloat16, table.data_ptr(), 0,
                       sm_count)
    pre_table = torch.randn(WORD_VOCAB, 300, device=dev, generator=gen)
    pre_ids = torch.from_numpy(zipf_ids(rng, WORD_VOCAB, 128 * 32)).to(dev)
    pre = gather.plan(pre_ids.numel(), 300, pre_table.dtype, torch.float32,
                      pre_table.data_ptr(), 0, sm_count)
    plans = {"word step": {**vars(main), "tile_rows": main.tile_rows},
             "pretrained batch": {**vars(pre), "tile_rows": pre.tile_rows}}
    emit("kernels", kernel="gather_rows", case="plans", plans=plans)
    blocks = gather.occupancy(table.dtype, torch.bfloat16, main)
    if blocks < gather.BLOCKS_PER_SM:
        raise AssertionError(f"the word step's gather holds {blocks} blocks an SM, "
                             f"not the {gather.BLOCKS_PER_SM} its grid counts on")

    # a call's host time: the serving and pretrained lookups spend far more
    # time on the host than on the card; the three calls take turns
    host = {}
    for name, tab, ids, shape, out_dtype, kind, trainable in [
            ("pretrained batch 128 x 32, D=300 f32 -> f32", pre_table, pre_ids, (128, 32),
             torch.float32, "word2vec", False),
            ("Hub-serve encode 32 x 64, D=64 f32 -> bf16", table, serve_ids, (32, 64),
             torch.bfloat16, "lookup", True)]:
        module = Embedding(EmbeddingSpec(kind=kind, vocab_size=tab.shape[0],
                                         embedding_dim=tab.shape[1], trainable=trainable)).to(dev)
        with torch.no_grad():
            module.table.copy_(tab)
        ids2d, ids64, lib_table = ids.reshape(shape), ids.long(), tab.to(out_dtype)
        host[name] = per_call_us({
            "gather_rows": (lambda: gather.gather_rows(tab, ids, out_dtype), False),
            "F.embedding": (lambda: F.embedding(ids64, lib_table), False),
            "Embedding.forward (inference_mode)": (lambda: module(ids2d, out_dtype), True)})
    emit("kernels", kernel="gather_rows", case="host us a call", calls=CALLS, **host,
         card=card["nvidia_smi"])
    return {"shapes": shapes, "plan": plans, "blocks_per_sm": blocks, "host_us": host}


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


def zipf_words() -> tuple:
    """The words ``w<rank>`` (indexed by rank), the ranks 1..32,766 and their
    Zipf(1.07) probabilities."""
    names = np.array([f"w{r}" for r in range(WORD_VOCAB)], dtype=object)
    ranks = np.arange(1, WORD_VOCAB - 1)
    weights = 1.0 / np.power(ranks, 1.07)
    return names, ranks, weights / weights.sum()


def word_triplets_tsv(path: Path, n_rows: int, seed: int) -> list:
    """Write ``n_rows`` triplets of words ``w<rank>``, ranks drawn Zipf(1.07)
    over 1..32,766, 16-64 words a text. The positive is its query with a
    quarter of the words redrawn; the negative is drawn afresh. Returns the
    positives."""
    rng = np.random.default_rng(seed)
    names, ranks, weights = zipf_words()
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


def _device_batch(pipeline, batch_size=WORD_BATCH):
    """The first batch of the pipeline's data on the card, as the step takes
    it (no negatives for a pair loss)."""
    from twotowers_tpu_torch.data import iterate_batches, place_on_device

    batch = place_on_device(next(iterate_batches(pipeline.dataset.arrays(), batch_size)),
                            "cuda")
    negatives = None if pipeline.loss_def.arity == "pair" else batch.negatives
    return batch.queries, batch.positives, negatives, batch.weights


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


def _step_ms(base, loss_def, config, batch, seed, steps=5):
    """Mean ms of one train step on the card (CUDA events), from a copy of
    ``base``, after two warm-up steps."""
    from twotowers_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    opt = build_optimizer(config)
    state = create_train_state(copy.deepcopy(base), opt, seed)
    step = make_train_step(loss_def, opt)
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


def kernels_against_plain_step(base, loss_def, config, batch, seed):
    """One step from the same weights (and the same dropout generator)
    through the lookup kernels and through their plain versions. The
    forward is bit-equal, so the losses agree within 1e-6 relative; the
    table gradient sums f32 in another order (the plain index_add_ by
    atomics), so it agrees within rtol 1e-3 and 1e-4 of its largest
    element. Returns (loss kernels, loss plain, max grad err, max grad)."""
    from twotowers_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    outcome = []
    for plain in (False, True):
        opt = build_optimizer(config)
        ab_state = create_train_state(copy.deepcopy(base), opt, seed)
        step = make_train_step(loss_def, opt)
        if plain:
            with plain_embedding_kernels():
                _, metrics = step(ab_state, *batch)
        else:
            _, metrics = step(ab_state, *batch)
        torch.cuda.synchronize()
        outcome.append((float(metrics["loss"]), ab_state.model.embedding.table.grad.clone()))
    (loss_k, grad_k), (loss_p, grad_p) = outcome
    scale = float(grad_p.abs().max())
    if abs(loss_k - loss_p) > 1e-6 * abs(loss_p):
        raise AssertionError(f"step loss {loss_k} through the kernels, {loss_p} plain")
    torch.testing.assert_close(grad_k, grad_p, rtol=1e-3, atol=1e-4 * scale)
    return loss_k, loss_p, float((grad_k - grad_p).abs().max()), scale


def device_rows(fn, reps: int) -> list:
    """(kernel name, device ms per call, launches per call) of ``fn`` on the
    card (torch.profiler), slowest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
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
            rows.append((event.key, self_us / reps / 1e3, event.count / reps))
    return sorted(rows, key=lambda r: -r[1])


def device_ms_by_kernel(fn, reps: int = 20) -> dict:
    """Device ms per call of ``fn`` by kernel name, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    return {name[:60]: ms for name, ms, _ in device_rows(fn, reps)}


def _profile_step(state, step, batch) -> dict:
    """Device time of 3 train steps by kernel name: the device's busy time
    per step and the lookup kernels' part of it."""
    rows = device_rows(lambda: step(state, *batch), 3)
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
        latest_checkpoint, load_checkpoint, load_trained_model, train_model)

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

    batch = _device_batch(pipeline)
    base = copy.deepcopy(state.model)
    loss_k, loss_p, grad_err, scale = kernels_against_plain_step(
        base, pipeline.loss_def, config, batch, seed)

    # the step's time, kernels and plain versions in turns
    times = {"kernels": [], "plain": []}
    for plain in (False, True, True, False):
        if plain:
            with plain_embedding_kernels():
                ms, _, _ = _step_ms(base, pipeline.loss_def, config, batch, seed)
        else:
            ms, prof_state, prof_step = _step_ms(base, pipeline.loss_def, config, batch, seed)
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


# ---- 7. transformer -------------------------------------------------------------

TRANSFORMER_CONFIG = {  # configs/transformer_tower.yml as load_config resolves it
    "data": "data/processed/classic_triplets.parquet",
    "checkpoint_dir": "checkpoints",
    "log_dir": "logs",
    "precision": "bf16",
    "wandb": {"project": "two-tower-retrieval", "entity": None},
    "huggingface": {"push_to_hub": False, "repo_id": "two-tower-tpu", "private": False},
    "tokeniser": {"type": "bpe", "max_len": 48, "num_merges": 2000},
    "embedding": {"type": "positional", "embedding_dim": 128, "max_len": 48},
    "encoder": {"arch": "transformer", "hidden_dim": 128, "tied_weights": True,
                "num_layers": 2, "num_heads": 4, "max_len": 48, "dropout": 0.1},
    "loss": {"type": "in_batch", "margin": 0.2, "temperature": 0.1},
    "optimizer": {"type": "adamw", "lr": 0.001},
    "batch_size": 256,
    "learning_rate": 0.001,
    "epochs": 3,
    "max_sequence_length": 64,
    "use_wandb": False,
}
TF_ROWS = 16_384 + 100  # synthetic triplets: the last batch of 256 is padded
TF_EVAL_TUPLES, TF_EVAL_DOCS, TF_SERVE_DOCS = 100, 100, 20_000
# bench.py's transformer_tower_train shape (_bench_transformer_tower)
TF_VOCAB, TF_SEQ, TF_BATCH, TF_EMB, TF_HID, TF_LAYERS, TF_HEADS = 8192, 48, 4096, 128, 128, 2, 4


def transformer_config(work: Path) -> dict:
    """The training config of the transformer phase: TRANSFORMER_CONFIG
    with its paths under ``work`` and its depth cut from 3 epochs to 2."""
    return {**TRANSFORMER_CONFIG, "data": str(work / "triplets.tsv"),
            "checkpoint_dir": str(work / "ckpt"), "log_dir": str(work / "logs"), "epochs": 2}


def tf_flops(batch: int, seq: int, emb: int, hid: int, layers: int) -> float:
    """Matmul FLOPs of one transformer-tower train step with the in_batch
    loss (2 texts a pair), a copy of bench.py's _tf_flops: per text forward
    the input projection 2*B*L*D*H, per layer QKV+O 8*B*L*H^2, attention
    4*B*L^2*H and the 4x FFN 16*B*L*H^2; backward ~2x forward; the loss's
    similarity matmul 2*B^2*H forward, 3x with backward. The lookup is a
    gather: no matmul FLOPs."""
    fwd = 2 * batch * seq * emb * hid + layers * (
        24 * batch * seq * hid * hid + 4 * batch * seq * seq * hid)
    return 2 * 3.0 * fwd + 3.0 * 2 * batch * batch * hid


def eval_tuples(queries: list, positives: list, pool: list, rng) -> list:
    """(query, documents, relevance) tuples: each query's positive (its
    text with a quarter of the words redrawn) among TF_EVAL_DOCS - 1 other
    texts of ``pool``, in a random order."""
    tuples = []
    for query, positive in zip(queries, positives):
        docs = [positive] + [pool[i] for i in rng.choice(len(pool), TF_EVAL_DOCS - 1,
                                                         replace=False)]
        order = rng.permutation(len(docs))
        tuples.append((query, [docs[i] for i in order], [int(i == 0) for i in order]))
    return tuples


def full_width_step(card: dict, seed: int) -> dict:
    """bench.py's transformer_tower_train step, timed with CUDA events and
    profiled once."""
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import gather, scatter_add
    from twotowers_tpu_torch.models import EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec
    from twotowers_tpu_torch.models.losses import build_loss

    dev = torch.device("cuda")
    spec = TwoTowerSpec(
        embedding=EmbeddingSpec(kind="lookup", vocab_size=TF_VOCAB, embedding_dim=TF_EMB),
        tower=TowerSpec(arch="transformer", embedding_dim=TF_EMB, hidden_dim=TF_HID,
                        dropout=0.0, num_layers=TF_LAYERS, num_heads=TF_HEADS, max_len=TF_SEQ),
        tied_weights=True, compute_dtype=torch.bfloat16)
    base = TwoTower(spec, torch.Generator().manual_seed(seed)).to(dev)
    rng = np.random.default_rng(seed)
    q, p = (torch.from_numpy(rng.integers(1, TF_VOCAB, size=(TF_BATCH, TF_SEQ))
                             .astype(np.int32)).to(dev) for _ in range(2))
    batch = (q, p, None, torch.ones(TF_BATCH, device=dev))
    config = {"optimizer": {"type": "adamw", "lr": 1e-3}}
    loss_def = build_loss("in_batch", temperature=0.1)

    gather.LAUNCHES = scatter_add.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    runs = [_step_ms(base, loss_def, config, batch, seed, steps=10) for _ in range(2)]
    launches = {"gather_rows": gather.LAUNCHES, "scatter_add_rows": scatter_add.LAUNCHES}
    if not launches["gather_rows"] or not launches["scatter_add_rows"]:
        raise AssertionError(f"the full-width step launched {launches}")
    step_ms = statistics.mean(ms for ms, _, _ in runs)
    _, state, step = runs[-1]
    _, metrics = step(state, *batch)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"full-width step loss {float(metrics['loss'])}")
    rows = device_rows(lambda: step(state, *batch), 3)
    busy_ms = sum(ms for _, ms, _ in rows)
    flops = tf_flops(TF_BATCH, TF_SEQ, TF_EMB, TF_HID, TF_LAYERS)

    # a yardstick the port never calls: one block's attention at this shape
    # (projections included), against scaled_dot_product_attention
    block = state.model.query_tower.layers[0]
    x = torch.randn(TF_BATCH, TF_SEQ, TF_HID, device=dev, dtype=torch.bfloat16)
    no_mask = torch.zeros(TF_BATCH, 1, 1, TF_SEQ, device=dev)

    def dense(t, lin):
        return F.linear(t, lin.weight.bfloat16(), lin.bias.bfloat16())

    def sdpa():
        q, k, v = (dense(x, lin).view(TF_BATCH, TF_SEQ, TF_HEADS, -1).transpose(1, 2)
                   for lin in (block.q, block.k, block.v))
        out = F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
        return dense(out.reshape(TF_BATCH, TF_SEQ, TF_HID), block.o)

    with torch.no_grad():
        attention_ms = cuda_ms(lambda: block.attention(x, no_mask, TF_HEADS))
        sdpa_ms = cuda_ms(sdpa)
    return {
        "shape": {"vocab": TF_VOCAB, "seq": TF_SEQ, "batch": TF_BATCH, "emb": TF_EMB,
                  "hidden": TF_HID, "layers": TF_LAYERS, "heads": TF_HEADS, "tied": True,
                  "dtype": "bfloat16", "loss": "in_batch t=0.1", "optimizer": "adamw 1e-3",
                  "dropout": 0.0},
        "step_ms": step_ms, "step_ms_runs": [ms for ms, _, _ in runs],
        "pairs_per_s": TF_BATCH / step_ms * 1e3,
        "model_flops_per_step": flops,
        "model_flop_share": flops / (step_ms / 1e3) / H100_FLOPS[torch.bfloat16],
        "peak_flops": H100_FLOPS[torch.bfloat16], "peak": "H100 SXM dense bf16 989 TFLOP/s",
        "device_busy_ms_per_step": busy_ms, "busy_share": busy_ms / step_ms,
        "launches_per_step": sum(n for _, _, n in rows),
        "lookup_kernel_launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "attention_ms": attention_ms, "sdpa_ms": sdpa_ms,
        "top": [[name[:70], ms, n] for name, ms, n in rows[:16]],
        "card": card["nvidia_smi"],
    }


def towers_against_cpu(seed: int) -> dict:
    """cnn, rnn and transformer in f32 on the card and on the CPU from the
    same converted weights; rtol 1e-5, atol 1e-5 (the tests' f32 tolerance
    against JAX). TF32 is off (main), so cuDNN and cuBLAS sum in IEEE f32."""
    from twotowers_tpu_torch.convert import params_from_jax, params_to_jax
    from twotowers_tpu_torch.models import EmbeddingSpec, TowerSpec, TwoTower, TwoTowerSpec

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 600, size=(8, TF_SEQ)).astype(np.int32)
    for row, length in enumerate(rng.integers(1, TF_SEQ, size=8)):
        ids[row, length:] = 0
    ids[1] = 0  # a row with no real token
    errs = {}
    for arch in ("cnn", "rnn", "transformer"):
        spec = TwoTowerSpec(
            embedding=EmbeddingSpec(kind="positional", vocab_size=600, embedding_dim=TF_EMB,
                                    max_len=TF_SEQ),
            tower=TowerSpec(arch=arch, embedding_dim=TF_EMB, hidden_dim=TF_HID, kernel_size=4,
                            num_layers=TF_LAYERS, num_heads=TF_HEADS, max_len=TF_SEQ))
        cpu_model = TwoTower(spec, torch.Generator().manual_seed(seed)).eval()
        card_model = params_from_jax(params_to_jax(cpu_model), spec).cuda().eval()
        with torch.no_grad():
            want = cpu_model.encode(torch.from_numpy(ids), "query")
            got = card_model.encode(torch.from_numpy(ids).cuda(), "query").cpu()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        errs[arch] = float((got - want).abs().max())
    return errs


def transformer_phase(card: dict, seed: int) -> dict:
    from twotowers_tpu_torch.evaluation import evaluate_model
    from twotowers_tpu_torch.kernels import gather, scatter_add, topk
    from twotowers_tpu_torch.models import TwoTower
    from twotowers_tpu_torch.serve.app import ModelRuntime
    from twotowers_tpu_torch.serve.service import RetrievalService
    from twotowers_tpu_torch.train import latest_checkpoint, load_trained_model, train_model

    work = ROOT / "build" / "chip_smoke" / "transformer"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    config = transformer_config(work)
    emit("transformer", step="config", source="configs/transformer_tower.yml",
         changed={k: config[k] for k in ("data", "checkpoint_dir", "log_dir", "epochs")},
         tokeniser=config["tokeniser"], embedding=config["embedding"],
         encoder=config["encoder"], loss=config["loss"], precision=config["precision"],
         batch_size=config["batch_size"])

    # 2. train
    start = time.perf_counter()
    positives = word_triplets_tsv(work / "triplets.tsv", TF_ROWS + TF_EVAL_TUPLES, seed)
    with open(work / "triplets.tsv") as f:
        rows = [line.rstrip("\n").split("\t") for line in f][1:]
    held_out = rows[TF_ROWS:]  # the last 100 rows are not trained on
    with open(work / "triplets.tsv", "w") as f:
        f.write("query\tpositive_doc\tnegative_doc\n")
        f.writelines("\t".join(row) + "\n" for row in rows[:TF_ROWS])
    data_s = time.perf_counter() - start
    gather.LAUNCHES = scatter_add.LAUNCHES = 0  # the main path starts here
    start = time.perf_counter()
    state, pipeline = train_model(config, seed=seed)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = {"gather_rows": gather.LAUNCHES, "scatter_add_rows": scatter_add.LAUNCHES}
    vocab, merges = pipeline.dataset.vocab_size, len(pipeline.tokenizer.merges)
    steps = 2 * math.ceil(TF_ROWS / config["batch_size"])
    with open(next((work / "logs").glob("*_metrics.jsonl"))) as f:
        records = [json.loads(line) for line in f]
    epoch_loss = [r["train/epoch_loss"] for r in records if "train/epoch_loss" in r]
    best = work / "ckpt" / "best_model"
    if vocab <= 512 or merges == 0 or state.step != steps:
        raise AssertionError(f"vocab {vocab}, {merges} merges, {state.step} steps")
    if len(epoch_loss) != 2 or not epoch_loss[1] < epoch_loss[0]:
        raise AssertionError(f"epoch losses {epoch_loss}: epoch 2 must be below epoch 1")
    if launches["scatter_add_rows"] != 2 * steps or launches["gather_rows"] < 2 * steps:
        raise AssertionError(f"launches {launches} for {steps} steps")
    if not (best / "params.npz").exists() or not latest_checkpoint(str(work / "ckpt")):
        raise AssertionError("best_model / checkpoint missing")
    emit("transformer", step="train", rows=TF_ROWS, vocab=vocab, merges=merges, steps=steps,
         epoch_loss=epoch_loss, launches=launches, data_s=data_s, train_model_s=train_s)

    # 3. one step through the kernels and through the plain versions
    batch = _device_batch(pipeline, config["batch_size"])
    loss_k, loss_p, grad_err, grad_max = kernels_against_plain_step(
        copy.deepcopy(state.model), pipeline.loss_def, config, batch, seed)
    emit("transformer", step="kernels against plain", ab_loss=[loss_k, loss_p],
         ab_table_grad_max_abs_err=grad_err, ab_table_grad_max=grad_max)

    # 4. evaluate the trained weights and the initial ones on held-out tuples
    rng = np.random.default_rng(seed + 3)
    tuples = eval_tuples([r[0] for r in held_out], [r[1] for r in held_out],
                         [r[2] for r in rows[:TF_ROWS]], rng)
    kw = dict(batch_size=32, max_length=config["tokeniser"]["max_len"])
    trained = evaluate_model(state.model, pipeline.spec, tuples, pipeline.tokenizer, **kw)
    initial = TwoTower(pipeline.spec, torch.Generator().manual_seed(seed)).cuda()
    untrained = evaluate_model(initial, pipeline.spec, tuples, pipeline.tokenizer, **kw)
    if not all(math.isfinite(v) for v in trained.values()) or \
            not trained["mrr"] > untrained["mrr"]:
        raise AssertionError(f"trained MRR {trained['mrr']}, initial {untrained['mrr']}")
    emit("transformer", step="evaluate", tuples=len(tuples), docs_per_tuple=TF_EVAL_DOCS,
         trained=trained, initial=untrained)

    # 5. serve best_model (epoch 2's weights, the trained model's): it
    # reloads to the same encodings, and every indexed text comes back
    # first for itself
    texts = list(dict.fromkeys(positives[:TF_ROWS] + [r[2] for r in rows[:TF_ROWS]]))
    texts = texts[:TF_SERVE_DOCS]
    loaded, spec, tokenizer, _ = load_trained_model(str(best))
    ids = torch.from_numpy(tokenizer(texts[:256], config["tokeniser"]["max_len"])).cuda()
    with torch.no_grad():
        if spec != pipeline.spec or not torch.equal(loaded.encode(ids),
                                                    state.model.eval().encode(ids)):
            raise AssertionError("best_model does not reload to the trained model")
    topk.LAUNCHES = 0  # the serving part of the path starts here
    service = RetrievalService(model=ModelRuntime(str(best)))
    start = time.perf_counter()
    out = service.add(texts, ids=[f"t{i}" for i in range(len(texts))])
    add_s = time.perf_counter() - start
    search_ms = []
    for i in rng.choice(len(texts), size=8, replace=False):
        start = time.perf_counter()
        result = service.search(texts[i], top_k=5)["results"]
        search_ms.append((time.perf_counter() - start) * 1e3)
        dists = [r["distance"] for r in result]
        top = [r["document"] for r in result if r["distance"] <= dists[0] + 1e-6]
        if out["total"] != len(texts) or texts[i] not in top:
            raise AssertionError(f"indexed text {i} not at rank 1: {result[:2]}")
    launches["score_topk"] = topk.LAUNCHES  # the main path ends here
    if launches["score_topk"] < 8:
        raise AssertionError(f"{launches['score_topk']} score_topk launches for 8 searches")
    emit("transformer", step="serve", docs=len(texts), add_docs_per_s=len(texts) / add_s,
         search_ms=search_ms, score_topk_launches=launches["score_topk"])

    # 6. bench.py's full-width step; 7. the towers on the card against the CPU
    full = full_width_step(card, seed)
    emit("transformer", step="full-width step", **full)
    towers = towers_against_cpu(seed)
    emit("transformer", step="towers on the card against the CPU", max_abs_err=towers,
         tolerance="rtol 1e-5, atol 1e-5, f32, TF32 off")
    return {"launches": launches, "step_ms": full["step_ms"], "vocab": vocab}


# ---- 8. pretrained ------------------------------------------------------------

WORD2VEC_CONFIG = {  # configs/word2vec_skipgram.yml as load_config resolves it
    "data": "data/processed/classic_triplets.parquet",
    "checkpoint_dir": "checkpoints",
    "log_dir": "logs",
    "precision": "float32",
    "wandb": {"project": "two-tower-retrieval", "entity": None},
    "huggingface": {"push_to_hub": False, "repo_id": "two-tower-tpu", "private": False},
    "tokeniser": {"type": "word", "max_len": 32, "lowercase": True, "strip_punctuation": True},
    "embedding": {"type": "pretrained", "embedding_dim": 300,
                  "source": "word2vec-google-news-300", "trainable": False},
    "encoder": {"arch": "mean", "hidden_dim": 256, "tied_weights": True, "dropout": 0.1},
    "loss": {"type": "triplet", "margin": 0.3},
    "optimizer": {"type": "adam", "lr": 0.0005},
    "batch_size": 128,
    "learning_rate": 0.001,
    "epochs": 5,
    "max_sequence_length": 64,
    "use_wandb": False,
}
W2V_ROWS = 16_384 + 100  # synthetic triplets: the last batch of 128 is padded
W2V_DOCS, W2V_SEARCHES, W2V_TOP_K = 100_000, 8, 10


def word2vec_config(work: Path) -> dict:
    """The training config of the pretrained phase: WORD2VEC_CONFIG with its
    paths under ``work``, its depth cut from 5 epochs to 2 and the first
    epoch traced into ``work/trace``."""
    return {**WORD2VEC_CONFIG, "data": str(work / "triplets.tsv"),
            "checkpoint_dir": str(work / "ckpt"), "log_dir": str(work / "logs"), "epochs": 2,
            "profile": {"trace_dir": str(work / "trace")}}


def zipf_texts(n: int, seed: int) -> list:
    """``n`` unique texts of 16-64 words ``w<rank>``, ranks drawn Zipf(1.07)
    over 1..32,766 (the words of ``word_triplets_tsv``)."""
    rng = np.random.default_rng(seed)
    names, ranks, weights = zipf_words()
    lengths = rng.integers(16, 65, size=n)
    words = rng.choice(ranks, size=int(lengths.sum()), p=weights)
    texts = [" ".join(names[w]) for w in np.split(words, np.cumsum(lengths)[:-1])]
    if len(set(texts)) != n:
        raise RuntimeError("synthetic texts are not unique")
    return texts


def _found_first(results: list, text: str) -> bool:
    """``text`` is the first result, or ties with it."""
    return results[0][0] == text or any(
        doc == text and score >= results[0][1] - 1e-6 for doc, score in results)


def _against_plain(docs, n_docs, query_vec, results, position) -> tuple:
    """A search's (document, score) results against score_topk_reference
    on the same device matrix: ``agree``'s tolerance."""
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference

    got = (torch.tensor([[s for _, s in results]], device=docs.device),
           torch.tensor([[position[d] for d, _ in results]], dtype=torch.int32,
                        device=docs.device))
    want = score_topk_reference(docs, query_vec, len(results), n_docs)
    return agree(docs, query_vec, got, want, n_docs)


def topk_row(docs, n_docs, query_vec, k) -> dict:
    """Kernel #1 at a phase's shape: its time, the plain version's, the
    library yardstick's and the bound (CUDA events)."""
    from twotowers_tpu_torch.kernels.topk import score_topk_cuda
    from twotowers_tpu_torch.ops.topk_score import score_topk_reference

    real = docs[:n_docs]
    got = score_topk_cuda(docs, query_vec, k, n_docs)
    err, swaps = agree(docs, query_vec, got, score_topk_reference(docs, query_vec, k, n_docs),
                       n_docs)
    bound, bound_by = topk_bound(n_docs, docs.shape[1], query_vec.shape[0], k, docs.dtype)
    return {"shape": {"n": n_docs, "d": docs.shape[1], "q": query_vec.shape[0], "k": k,
                      "dtype": str(docs.dtype)},
            "max_abs_err": err, "near_tie_swaps": swaps,
            "ms": cuda_ms(lambda: score_topk_cuda(docs, query_vec, k, n_docs)),
            "plain_ms": cuda_ms(lambda: score_topk_reference(docs, query_vec, k, n_docs)),
            "library_ms": cuda_ms(lambda: torch.topk(query_vec @ real.T, k)),
            "bound_ms": bound, "bound_by": bound_by,
            "device_ms_by_kernel": device_ms_by_kernel(
                lambda: score_topk_cuda(docs, query_vec, k, n_docs))}


def pretrained_phase(card: dict, seed: int) -> dict:
    import contextlib
    import io
    from unittest import mock

    import torch.nn.functional as F

    from twotowers_tpu_torch.convert import opt_state_to_jax
    from twotowers_tpu_torch.index import GloVeSearch, TwoTowerSearch, cli
    from twotowers_tpu_torch.kernels import gather, scatter_add, topk
    from twotowers_tpu_torch.models.embeddings import pretrained_table
    from twotowers_tpu_torch.train import (
        build_pipeline, latest_checkpoint, load_checkpoint, train_model)

    work = ROOT / "build" / "chip_smoke" / "pretrained"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    config = word2vec_config(work)
    emit("pretrained", step="config", source="configs/word2vec_skipgram.yml",
         changed={k: config[k] for k in ("data", "checkpoint_dir", "log_dir", "epochs",
                                          "profile")},
         tokeniser=config["tokeniser"], embedding=config["embedding"],
         encoder=config["encoder"], loss=config["loss"], optimizer=config["optimizer"],
         precision=config["precision"], batch_size=config["batch_size"])

    # 1. the frozen table before training: the pipeline's, on the card, is
    # the fallback table built on the CPU, bit for bit (no gensim here)
    start = time.perf_counter()
    word_triplets_tsv(work / "triplets.tsv", W2V_ROWS, seed)
    data_s = time.perf_counter() - start
    before = build_pipeline(config, seed=seed)
    cpu_table = torch.from_numpy(pretrained_table(before.spec.embedding))
    if before.model.embedding.table.device.type != "cuda" or \
            not torch.equal(before.model.embedding.table.cpu(), cpu_table):
        raise AssertionError("the table on the card is not the CPU's fallback table")
    del before

    # 2. train: the main path starts here
    gather.LAUNCHES = scatter_add.LAUNCHES = topk.LAUNCHES = 0
    start = time.perf_counter()
    state, pipeline = train_model(config, seed=seed)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    launches = {"gather_rows": gather.LAUNCHES, "scatter_add_rows": scatter_add.LAUNCHES}
    batch_size = config["batch_size"]
    steps = 2 * math.ceil(W2V_ROWS / batch_size)
    emb_spec = pipeline.spec.embedding
    vocab = pipeline.dataset.vocab_size
    if (emb_spec.kind, emb_spec.trainable, emb_spec.embedding_dim) != ("pretrained", False, 300) \
            or vocab <= 512 or state.step != steps:
        raise AssertionError(f"{emb_spec}, vocab {vocab}, {state.step} steps")
    if launches != {"gather_rows": 3 * steps, "scatter_add_rows": 0}:
        raise AssertionError(f"launches {launches}: want 3 lookups x {steps} steps, no scatter")
    if torch.from_numpy(pretrained_table(emb_spec)).ne(cpu_table).any() or \
            not torch.equal(state.model.embedding.table.cpu(), cpu_table):
        raise AssertionError("the frozen table changed in training")
    with open(next((work / "logs").glob("*_metrics.jsonl"))) as f:
        records = [json.loads(line) for line in f]
    epoch_loss = [r["train/epoch_loss"] for r in records if "train/epoch_loss" in r]
    if len(epoch_loss) != 2 or not epoch_loss[1] < epoch_loss[0]:
        raise AssertionError(f"epoch losses {epoch_loss}: epoch 2 must be below epoch 1")
    best = work / "ckpt" / "best_model"
    tree, meta = load_checkpoint(str(best))
    if not np.array_equal(tree["params"]["embedding"]["table"], cpu_table.numpy()) or \
            tree["opt_state"]["mu"]["embedding"]["table"].any():
        raise AssertionError("best_model's table or its zero moments differ")
    traces = list((work / "trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} trace files for one traced epoch")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernel_events = [e for e in events if "gather_rows_kernel" in str(e.get("name", ""))]
    if len(kernel_events) < steps // 2:  # at least one a traced step
        raise AssertionError(f"the trace names gather_rows_kernel {len(kernel_events)} times")
    emit("pretrained", step="train", rows=W2V_ROWS, vocab=vocab, steps=steps,
         epoch_loss=epoch_loss, launches=launches, data_s=data_s, train_model_s=train_s,
         trace={"file": traces[0].name, "mb": traces[0].stat().st_size / 1e6,
                "events": len(events), "gather_rows_kernel_events": len(kernel_events)})

    # 3. a resumed epoch carries its step count and the optimizer state
    resumed, _ = train_model({**config, "epochs": 3, "resume": "latest", "profile": None},
                             seed=seed)
    count = int(opt_state_to_jax(resumed.model, resumed.optimizer)["count"])
    _, latest = load_checkpoint(latest_checkpoint(str(work / "ckpt")))
    if resumed.step != steps + steps // 2 or count != resumed.step or latest["epoch"] != 3 \
            or not torch.equal(resumed.model.embedding.table.cpu(), cpu_table):
        raise AssertionError(f"resume: step {resumed.step}, Adam count {count}, "
                             f"latest epoch {latest['epoch']}")

    # 4. the search CLI over best_model: build-index, then 8 searches, each
    # recorded with its exact results
    texts = zipf_texts(W2V_DOCS, seed + 5)
    position = {t: i for i, t in enumerate(texts)}
    (work / "docs.txt").write_text("\n".join(texts) + "\n")
    index_dir = str(work / "index")
    start = time.perf_counter()
    if cli.main(["build-index", "--checkpoint", str(best), "--documents",
                 str(work / "docs.txt"), "--index", index_dir]) != 0:
        raise AssertionError("build-index failed")
    build_s = time.perf_counter() - start
    picks = np.random.default_rng(seed + 6).choice(W2V_DOCS, size=W2V_SEARCHES, replace=False)
    recorded = []
    search_fn = TwoTowerSearch.search

    def recording(self, query, top_k=5):
        start = time.perf_counter()
        out = search_fn(self, query, top_k)
        recorded.append((self, query, out, (time.perf_counter() - start) * 1e3))
        return out

    with mock.patch.object(TwoTowerSearch, "search", recording):
        for i in picks:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                code = cli.main(["search", "--checkpoint", str(best), "--index", index_dir,
                                 "--query", texts[i], "--top_k", str(W2V_TOP_K)])
            lines = printed.getvalue().splitlines()
            if code != 0 or len(lines) != W2V_TOP_K + 1 or \
                    f"{W2V_DOCS} docs)" not in lines[0]:
                raise AssertionError(f"search printed {lines[:2]}")
    cli_errs, cli_ms = [], []
    for (search, query, results, ms) in recorded:
        if search.device.type != "cuda" or not _found_first(results, query):
            raise AssertionError(f"search CLI: {query[:40]!r} not first: {results[:2]}")
        q_vec = search._encode_texts_device([query], "query")
        cli_errs.append(_against_plain(search._doc_matrix, search.num_documents, q_vec,
                                       results, position))
        cli_ms.append(ms)
    cli_launches = topk.LAUNCHES

    # 5. GloVeSearch offline: 50-wide hashed word vectors, the same texts
    glove = GloVeSearch("glove-twitter-25")
    if glove.dim != 50 or glove.device.type != "cuda":
        raise AssertionError(f"GloVeSearch dim {glove.dim} on {glove.device}")
    start = time.perf_counter()
    glove.index_documents(texts)
    torch.cuda.synchronize()
    glove_index_s = time.perf_counter() - start
    glove_errs, glove_ms = [], []
    for i in picks:
        start = time.perf_counter()
        results = glove.search(texts[i], top_k=W2V_TOP_K)
        glove_ms.append((time.perf_counter() - start) * 1e3)
        if not _found_first(results, texts[i]):
            raise AssertionError(f"GloVe: {texts[i][:40]!r} not first: {results[:2]}")
        q_vec = torch.from_numpy(glove.encode([texts[i]])).cuda()
        glove_errs.append(_against_plain(glove._doc_matrix, glove.num_documents, q_vec,
                                         results, position))
    launches["score_topk"] = topk.LAUNCHES  # the main path ends here
    if cli_launches != W2V_SEARCHES or launches["score_topk"] != 2 * W2V_SEARCHES:
        raise AssertionError(f"score_topk launches: {cli_launches} CLI, "
                             f"{launches['score_topk']} in all, for {W2V_SEARCHES} + "
                             f"{W2V_SEARCHES} searches")
    emit("pretrained", step="search", docs=W2V_DOCS, top_k=W2V_TOP_K,
         build_index_s=build_s, build_index_docs_per_s=W2V_DOCS / build_s,
         cli_search_ms=cli_ms, cli_max_abs_err=max(e for e, _ in cli_errs),
         cli_near_tie_swaps=sum(s for _, s in cli_errs),
         glove_index_s=glove_index_s, glove_index_docs_per_s=W2V_DOCS / glove_index_s,
         glove_search_ms=glove_ms, glove_max_abs_err=max(e for e, _ in glove_errs),
         glove_near_tie_swaps=sum(s for _, s in glove_errs),
         score_topk_launches=launches["score_topk"], card=card["nvidia_smi"])

    # 6. the kernels at this phase's shapes against their plain versions,
    # timed: the gather of one encode (128 x 32 ids) from the frozen table,
    # kernel #1 at D=256 (the CLI's index) and D=50 (GloVe's, scalar loads)
    batch = _device_batch(pipeline, batch_size)
    ids = batch[0].reshape(-1).to(torch.int32)
    table = state.model.embedding.table.detach()
    got = gather.gather_rows(table, ids, torch.float32)
    torch.cuda.synchronize()
    want = gather.gather_rows_reference(table, ids, torch.float32)
    if not torch.equal(got, want):
        raise AssertionError("gather at D=300: not bit-equal to the plain version")
    rows_read = int(torch.unique(ids).numel())  # the table rows this batch needs
    ids64 = ids.long()
    gather_row = {
        "shape": {"n": ids.numel(), "d": 300, "v": vocab, "table": "float32", "out": "float32",
                  "distinct_ids": rows_read},
        "max_abs_err": float((got - want).abs().max()),
        "ms": cuda_ms(lambda: gather.gather_rows(table, ids, torch.float32)),
        "plain_ms": cuda_ms(lambda: gather.gather_rows_reference(table, ids, torch.float32)),
        "library_ms": cuda_ms(lambda: F.embedding(ids64, table)),
    }
    gather_row["bound_ms"], gather_row["bound_by"] = bytes_bound(
        ids.numel() * 4 + rows_read * 300 * 4 + ids.numel() * 300 * 4)
    # at 4,096 rows a call's host time exceeds the kernel's: the device's own
    gather_row["device_ms_by_kernel"] = device_ms_by_kernel(
        lambda: gather.gather_rows(table, ids, torch.float32))
    search = recorded[0][0]
    cli_row = topk_row(search._doc_matrix, search.num_documents,
                       search._encode_texts_device([recorded[0][1]], "query"), W2V_TOP_K)
    glove_row = topk_row(glove._doc_matrix, glove.num_documents,
                         torch.from_numpy(glove.encode([texts[picks[0]]])).cuda(), W2V_TOP_K)
    for case, row in (("gather d300", gather_row), ("score_topk d256 (search CLI)", cli_row),
                      ("score_topk d50 (GloVe)", glove_row)):
        emit("kernels", case=f"pretrained phase: {case}", **row, card=card["nvidia_smi"])

    # 7. the step's time (CUDA events) and the device's busy share of it
    ms, prof_state, prof_step = _step_ms(copy.deepcopy(state.model), pipeline.loss_def, config,
                                         batch, seed, steps=20)
    rows = device_rows(lambda: prof_step(prof_state, *batch), 3)
    busy_ms = sum(r[1] for r in rows)
    step = {"step_ms": ms, "pairs_per_s": batch_size / ms * 1e3,
            "device_busy_ms_per_step": busy_ms, "busy_share": busy_ms / ms,
            "launches_per_step": sum(r[2] for r in rows),
            "top": [[name[:70], t, n] for name, t, n in rows[:10]], "card": card["nvidia_smi"]}
    emit("pretrained", step="step", batch=batch_size, **step)
    return {"launches": launches, "gather": gather_row, "search_cli": cli_row,
            "glove": glove_row}


# ---- 9. parallel ----------------------------------------------------------------

PAR_MESH = {"data": 2, "model": 2}
PAR_WORLD = 4  # ranks on the one card
PAR_VOCAB = 102_400  # tools/bench_sharded_vocab.py:43: 51,200 rows a shard at model=2
PAR_SEARCHES = 8
PAR_INDEX_DOCS = 20_000  # ShardedTwoTowerSearch's round trip
PAR_TIMEOUT_S = 480
PAR_STEP_CONFIG = {  # tools/bench_sharded_vocab.py's step (bench_vocab_scaling.bench_one)
    "embedding": {"type": "lookup", "embedding_dim": WORD_EMB},
    "encoder": {"arch": "mean", "hidden_dim": WORD_HID, "tied_weights": True},
    "precision": "bf16", "optimizer": {"type": "adamw", "lr": 1e-3}}
PAR_LOSSES = {"triplet": {"margin": 0.2}, "in_batch": {"temperature": 0.1}}
# the port's bf16 tolerances (tests/test_torch_train.py): loss within 2e-3,
# grad_norm rtol 2e-2, params within 10 lr with a mean difference below lr / 4
BF16_LOSS_ATOL, BF16_NORM_RTOL, BF16_PARAMS_LR, BF16_PARAMS_MEAN_LR = 2e-3, 2e-2, 10.0, 0.25


def _par_model(seed: int):
    """The weights of the sharded-vocabulary step: the port's draw from ``seed``
    (the same on every rank)."""
    from twotowers_tpu_torch.models import TwoTower, spec_from_config

    spec = spec_from_config(PAR_STEP_CONFIG, PAR_VOCAB)
    return TwoTower(spec, torch.Generator().manual_seed(seed)).cuda()


def _positives(tsv: Path) -> list:
    with open(tsv) as f:
        next(f)
        return [line.rstrip("\n").split("\t")[1] for line in f]


def _run_ranks(target, args_list: list, work: Path, timeout: float) -> None:
    """Start one process per argument tuple and wait for all; the first that
    fails, or the timeout, ends the others and fails the phase."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for args in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    errors = sorted(work.glob("error.*.txt"))
    if errors:
        raise RuntimeError(f"{errors[0].name}:\n{errors[0].read_text()[-4000:]}")
    if [p.exitcode for p in procs] != [0] * len(procs):
        raise RuntimeError(f"ranks ended with exit codes {[p.exitcode for p in procs]} "
                           f"(timeout {timeout} s)")


def _rank_entry(body, name: str, work: Path, *args) -> None:
    """Run ``body`` in a rank; its result goes to ``work/<name>.json``, its
    traceback to ``work/error.<name>.txt``."""
    import traceback

    try:
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions sum in IEEE f32
        torch.backends.cudnn.allow_tf32 = False
        (work / f"{name}.json").write_text(json.dumps(body(work, *args)))
    except BaseException:
        (work / f"error.{name}.txt").write_text(traceback.format_exc())
        raise


def _collective_share(fn) -> dict:
    """One more call of ``fn`` on every rank, with each all_reduce and
    all_gather timed between two synchronizes (so the card's queued work is
    not counted as the collective's): the call's ms, the collectives' ms and
    their count."""
    import torch.distributed as dist

    spent = []

    def timed(collective):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = collective(*args, **kwargs)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - start)
            return out
        return call

    saved = dist.all_reduce, dist.all_gather
    dist.all_reduce, dist.all_gather = map(timed, saved)
    try:
        dist.barrier()
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - start
    finally:
        dist.all_reduce, dist.all_gather = saved
    return {"ms": total * 1e3, "collectives_ms": sum(spent) * 1e3, "collectives": len(spent)}


def _shard_kernel_checks(local_table, ids, offset: int, dtype, seed: int) -> dict:
    """Kernels #3 and #2 against their plain versions on the inputs that
    one shard's lookup gives them: the global ``ids`` less the shard's
    ``offset``, over its local rows, so the ids other shards own lie outside
    ``[0, rows)``. The gather into the compute ``dtype`` must be bit-equal
    (those ids read as zero rows); the scatter-add of a ``dtype`` gradient
    into the table's dtype must be within ``scatter_error``'s tolerance
    (those ids dropped)."""
    from twotowers_tpu_torch.kernels import gather, scatter_add

    rows = local_table.shape[0]
    local = (ids - offset).reshape(-1).to(torch.int32)  # as sharded_embed_ids hands them on
    got = gather.gather_rows(local_table, local, dtype)
    torch.cuda.synchronize()
    want = gather.gather_rows_reference(local_table, local, dtype)
    if not torch.equal(got, want):
        raise AssertionError(f"gather of a shard ({rows} rows, offset {offset}): not "
                             f"bit-equal to the plain version "
                             f"(max err {float((got.float() - want.float()).abs().max())})")
    gen = torch.Generator(device=ids.device).manual_seed(seed)
    g = torch.randn(local.shape[0], local_table.shape[1], generator=gen,
                    device=ids.device).to(dtype)
    got = scatter_add.scatter_add_rows(g, local, rows, local_table.dtype)
    torch.cuda.synchronize()
    want = scatter_add.scatter_add_rows_reference(g, local, rows, local_table.dtype)
    err, within = scatter_error(got, want, g, local, rows, local_table.dtype)
    if not within:
        raise AssertionError(f"scatter-add of a shard ({rows} rows, offset {offset}): max "
                             f"err {err} beyond tolerance")
    return {"ids": local.shape[0], "rows": rows, "offset": offset,
            "outside": float(((local < 0) | (local >= rows)).float().mean()),
            "gather_bit_equal": True, "scatter_max_abs_err": err}


def _parallel_rank(work: Path, rank: int, seed: int, tsv: str) -> dict:
    """One of the 4 ranks (sharing one card over gloo, or a card each over
    NCCL): sharded training through ``train_model``, the
    sharded-vocabulary step and the sharded index."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from twotowers_tpu_torch.index import ShardedDocIndex, ShardedTwoTowerSearch
    from twotowers_tpu_torch.kernels import build, gather, scatter_add, topk
    from twotowers_tpu_torch.models import build_loss
    from twotowers_tpu_torch.ops.topk_score import score_topk, score_topk_reference
    from twotowers_tpu_torch.parallel import (
        create_sharded_train_state, initialize_distributed, make_mesh,
        make_sharded_train_step, shard_batch)
    from twotowers_tpu_torch.data import iterate_batches
    from twotowers_tpu_torch.parallel.mesh import MODEL_AXIS, axis_index
    from twotowers_tpu_torch.parallel.train import sharded_state_to_jax
    from twotowers_tpu_torch.train import build_optimizer, load_trained_model, train_model

    libs = {n: build.library_path(n).stat().st_mtime_ns for n in build.sources()}
    backend = initialize_distributed(f"file://{work}/store", PAR_WORLD, rank, device_type="cuda")
    out = {"rank": rank, "backend": backend, "device": torch.cuda.current_device()}

    def lookup_launches():
        return {"gather_rows": gather.LAUNCHES, "scatter_add_rows": scatter_add.LAUNCHES}

    # 1. train_model under mesh: {data: 2, model: 2}, 1 epoch of phase 6's data
    config = {**WORD_CONFIG, "data": tsv, "epochs": 1, "mesh": PAR_MESH,
              "checkpoint_dir": str(work / "ckpt"), "log_dir": str(work / "logs")}
    dist.barrier()
    gather.LAUNCHES = scatter_add.LAUNCHES = 0  # the main path starts here
    start = time.perf_counter()
    state, pipeline = train_model(config, seed=seed)
    torch.cuda.synchronize()
    out["train"] = {"launches": lookup_launches(), "seconds": time.perf_counter() - start,
                    "steps": state.step, "vocab": pipeline.dataset.vocab_size,
                    "local_table_rows": state.model.embedding.table.shape[0]}
    # the lookup kernels on this shard's inputs of the first batch's queries
    mesh = make_mesh(**PAR_MESH)
    table = state.model.embedding.table.detach()
    first = next(iterate_batches(pipeline.dataset.arrays(), WORD_BATCH))
    (queries,) = shard_batch(mesh, first.queries)
    out["train"]["shard_kernels"] = _shard_kernel_checks(
        table, queries, axis_index(mesh, MODEL_AXIS) * table.shape[0], torch.bfloat16,
        seed + rank)
    del state, pipeline, table, queries

    # 2. one step at the JAX package's sharded-vocabulary shape, per loss;
    # rank 0 keeps what the single-rank step is held against
    with np.load(work / "batch.npz") as data:
        batch = {k: data[k] for k in data.files}
    for loss, kwargs in PAR_LOSSES.items():
        opt = build_optimizer(PAR_STEP_CONFIG)
        state = create_sharded_train_state(_par_model(seed), opt, mesh, seed=seed)
        step = make_sharded_train_step(build_loss(loss, **kwargs), opt, mesh)
        args = shard_batch(mesh, batch["q"], batch["p"],
                           None if loss == "in_batch" else batch["n"], batch["w"])
        gather.LAUNCHES = scatter_add.LAUNCHES = 0
        _, metrics = step(state, *args)
        metrics = {k: float(v) for k, v in metrics.items()}
        row = {"metrics": metrics, "launches": lookup_launches(),
               "local_table_rows": state.model.embedding.table.shape[0]}
        if loss == "triplet":  # the lookup kernels on this shard's inputs of the queries
            table = state.model.embedding.table.detach()
            row["shard_kernels"] = _shard_kernel_checks(
                table, args[0], axis_index(mesh, MODEL_AXIS) * table.shape[0],
                torch.bfloat16, seed + rank)
        params, _ = sharded_state_to_jax(state, mesh, PAR_VOCAB)
        if rank == 0:
            np.savez(work / f"step_{loss}.npz", table=params["embedding"]["table"],
                     **params["query_tower"])
        times = []
        for _ in range(3):  # the step's time: ranks share the card and the host
            dist.barrier()
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(state, *args)
            torch.cuda.synchronize()
            dist.barrier()
            times.append((time.perf_counter() - start) * 1e3)
        row["step_ms"] = times
        row["collectives"] = _collective_share(lambda: step(state, *args))
        out[f"step_{loss}"] = row
        del state, step, args
        torch.cuda.empty_cache()

    # 3. ShardedDocIndex over a (1, 4) mesh: 1M x 128 f32, 8 single searches
    # and one 256-query batch, each against the kernel and the plain version
    # over the whole matrix on this rank
    mesh14 = make_mesh(1, 4)
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    docs = F.normalize(torch.randn(1_000_000, 128, generator=gen, device="cuda"), dim=1)
    fresh = F.normalize(torch.randn(PAR_SEARCHES // 2 + 128, 128, generator=gen,
                                    device="cuda"), dim=1)
    picks = torch.randint(0, docs.shape[0], (PAR_SEARCHES // 2 + 128,), generator=gen,
                          device="cuda")
    singles = torch.cat([docs[picks[:PAR_SEARCHES // 2]], fresh[:PAR_SEARCHES // 2]])
    queries = [singles[i:i + 1] for i in range(PAR_SEARCHES)] + \
        [torch.cat([docs[picks[PAR_SEARCHES // 2:]], fresh[PAR_SEARCHES // 2:]])]
    index = ShardedDocIndex(mesh14)
    index.build(docs.cpu().numpy())
    host_queries = [q.cpu().numpy() for q in queries]
    dist.barrier()
    topk.LAUNCHES = 0  # the main path starts here
    results, search_ms = [], []
    for q in host_queries:
        start = time.perf_counter()
        results.append(index.search_vectors(q, 10))
        search_ms.append((time.perf_counter() - start) * 1e3)
    index_launches = topk.LAUNCHES  # the main path ends here
    batch_collectives = _collective_share(lambda: index.search_vectors(host_queries[-1], 10))
    errs = []
    for q, (scores, idx) in zip(queries, results):
        got = (torch.from_numpy(scores).cuda(), torch.from_numpy(idx).cuda())
        errs.append(agree(docs, q, got, score_topk(docs, q, 10)))
        errs.append(agree(docs, q, got, score_topk_reference(docs, q, 10)))
    found = [int(results[i][1][0, 0]) == int(picks[i]) for i in range(PAR_SEARCHES // 2)]
    out["index"] = {"launches": {"score_topk": index_launches}, "search_ms": search_ms,
                    "batch_collectives": batch_collectives,
                    "max_abs_err": max(e for e, _ in errs),
                    "near_tie_swaps": sum(s for _, s in errs), "found_first": found,
                    "rows_per_shard": index._rows_per_shard}
    del index, docs
    torch.cuda.empty_cache()

    # 4. ShardedTwoTowerSearch: index the trained model's documents, save
    # (rank 0 writes), load on every rank, search again
    model, spec, tokenizer, _ = load_trained_model(str(work / "ckpt" / "best_model"))
    texts = _positives(Path(tsv))[:PAR_INDEX_DOCS]
    search = ShardedTwoTowerSearch(model, spec, tokenizer, mesh14, max_length=WORD_SEQ,
                                   encode_batch_size=4096)
    search.index_documents(texts)
    before = [search.search(texts[i], top_k=5) for i in range(0, PAR_INDEX_DOCS, 2500)]
    search.save_index(str(work / "index"))
    loaded = ShardedTwoTowerSearch(model, spec, tokenizer, mesh14, max_length=WORD_SEQ,
                                   encode_batch_size=4096)
    loaded.load_index(str(work / "index"))
    after = [loaded.search(texts[i], top_k=5) for i in range(0, PAR_INDEX_DOCS, 2500)]
    out["round_trip"] = {"equal": before == after, "docs": loaded.num_documents,
                         "found_first": [_found_first(r, texts[i]) for r, i in
                                         zip(after, range(0, PAR_INDEX_DOCS, 2500))]}
    out["rebuilt"] = build.build() != 0.0 or libs != {
        n: build.library_path(n).stat().st_mtime_ns for n in build.sources()}
    dist.barrier()
    dist.destroy_process_group()
    return out


def _nccl_rank(work: Path, seed: int) -> dict:
    """A 1-rank NCCL group (the backend rule's choice for a rank with a card
    of its own): one sharded step on a (1, 1) mesh against the unsharded
    step, and the collectives of the sharded lookup and of global negatives
    against their single-rank values."""
    import torch.distributed as dist

    from twotowers_tpu_torch.models import build_loss
    from twotowers_tpu_torch.models.embeddings import GatherScatterGrad
    from twotowers_tpu_torch.models.losses import in_batch_sampled_softmax_loss
    from twotowers_tpu_torch.parallel import (
        create_sharded_train_state, global_in_batch_loss, make_mesh,
        make_sharded_train_step, sharded_embed_ids)
    from twotowers_tpu_torch.parallel.mesh import choose_backend
    from twotowers_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    backend = choose_backend("cuda", 1)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{work}/nccl_store", rank=0,
                            world_size=1)
    mesh = make_mesh(1, 1)
    with np.load(work / "batch.npz") as data:
        q, p, n, w = (torch.from_numpy(data[k][:4096]).cuda() for k in ("q", "p", "n", "w"))
    loss_def = build_loss("triplet", margin=0.2)
    metrics = []
    for sharded in (True, False):
        opt = build_optimizer(PAR_STEP_CONFIG)
        if sharded:
            state = create_sharded_train_state(_par_model(seed), opt, mesh, seed=seed)
            step = make_sharded_train_step(loss_def, opt, mesh)
        else:
            state = create_train_state(_par_model(seed), opt, seed)
            step = make_train_step(loss_def, opt)
        _, m = step(state, q, p, n, w)
        metrics.append({k: float(v) for k, v in m.items()})
    table = _par_model(seed).embedding.table.detach()
    lookup = sharded_embed_ids(table, q, mesh, torch.bfloat16)  # NCCL all_reduce
    docs = torch.nn.functional.normalize(lookup.float().mean(1), dim=1)
    global_loss, _ = global_in_batch_loss(docs, docs, w, mesh)  # NCCL all_gather
    local_loss, _ = in_batch_sampled_softmax_loss(docs, docs, w)
    out = {"backend": dist.get_backend(), "metrics_sharded": metrics[0],
           "metrics_unsharded": metrics[1],
           "lookup_equal": torch.equal(lookup, GatherScatterGrad.apply(table, q, torch.bfloat16)),
           "in_batch": [float(global_loss), float(local_loss)]}
    dist.destroy_process_group()
    return out


def parallel_phase(card: dict, seed: int) -> dict:
    """4 ranks as a {data: 2, model: 2} mesh, then a 1-rank NCCL group. By
    the backend rule the 4 ranks share one card over gloo; on a machine
    with 4 cards each takes its own over NCCL."""
    from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
    from twotowers_tpu_torch.models import build_loss
    from twotowers_tpu_torch.parallel.mesh import choose_backend
    from twotowers_tpu_torch.train import (
        build_optimizer, create_train_state, load_checkpoint, load_trained_model,
        make_train_step)
    from twotowers_tpu_torch.convert import params_to_jax

    work = ROOT / "build" / "chip_smoke" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tsv = ROOT / "build" / "chip_smoke" / "train" / "triplets.tsv"  # phase 6's data
    rng = np.random.default_rng(seed + 9)
    ids = zipf_ids(rng, PAR_VOCAB, 3 * WORD_BATCH * WORD_SEQ).reshape(3, WORD_BATCH, WORD_SEQ)
    np.savez(work / "batch.npz", q=ids[0], p=ids[1], n=ids[2],
             w=np.ones(WORD_BATCH, np.float32))

    start = time.perf_counter()
    _run_ranks(_rank_entry, [(_parallel_rank, f"rank{r}", work, r, seed, str(tsv))
                             for r in range(PAR_WORLD)], work, PAR_TIMEOUT_S)
    ranks_s = time.perf_counter() - start
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(PAR_WORLD)]

    backend, cards = choose_backend("cuda", PAR_WORLD), torch.cuda.device_count()
    # 1. the sharded train_model: each rank's lookup kernels ran 3 times a
    # step; rank 0 alone wrote one metrics file and the checkpoints, with
    # the whole, unpadded table; the loss fell
    steps = math.ceil(TRAIN_ROWS / WORD_BATCH)
    for r in ranks:
        t = r["train"]
        if r["backend"] != backend or r["device"] != r["rank"] % cards or \
                t["steps"] != steps or \
                t["launches"] != {"gather_rows": 3 * steps, "scatter_add_rows": 3 * steps} or \
                t["local_table_rows"] != -(-t["vocab"] // PAR_MESH["model"]) or r["rebuilt"]:
            raise AssertionError(f"rank {r['rank']}: {r['backend']} on {r['device']}, {t}, "
                                 f"rebuilt {r['rebuilt']}")
    # kernels #3 and #2 on each shard's inputs: some ids inside the shard
    # and some outside it, on every rank
    shard_checks = {r["rank"]: {"train_model": r["train"]["shard_kernels"],
                                "step": r["step_triplet"]["shard_kernels"]} for r in ranks}
    for rank, checks in shard_checks.items():
        if not all(0.0 < c["outside"] < 1.0 for c in checks.values()):
            raise AssertionError(f"rank {rank}: a shard's ids all inside or all outside "
                                 f"its rows: {checks}")
    metric_files = list((work / "logs").glob("*_metrics.jsonl"))
    ckpts = sorted(p.name for p in (work / "ckpt").iterdir())
    if len(metric_files) != 1 or len(ckpts) != 2 or "best_model" not in ckpts:
        raise AssertionError(f"metrics files {metric_files}, checkpoints {ckpts}")
    records = [json.loads(line) for line in metric_files[0].read_text().splitlines()]
    batch_loss = [r["train/batch_loss"] for r in records if "train/batch_loss" in r]
    # the last batch holds 100 real rows; the last full one is compared
    if len(batch_loss) != steps or not batch_loss[-2] < batch_loss[0] or \
            not all(math.isfinite(v) for v in batch_loss):
        raise AssertionError(f"batch losses {batch_loss}: the last full batch's must be "
                             f"below the first's")
    vocab = ranks[0]["train"]["vocab"]
    tree, _ = load_checkpoint(str(work / "ckpt" / "best_model"))
    if tree["params"]["embedding"]["table"].shape != (vocab, WORD_EMB) or \
            tree["opt_state"]["mu"]["embedding"]["table"].shape != (vocab, WORD_EMB):
        raise AssertionError("the checkpoint's table is not the whole, unpadded one")
    model, spec, tokenizer, _ = load_trained_model(str(work / "ckpt" / "best_model"))
    positives = _positives(tsv)
    search = TwoTowerSearch(model, spec, tokenizer, max_length=WORD_SEQ, encode_batch_size=4096)
    search.index_documents(positives)
    for i in np.random.default_rng(seed).choice(len(positives), size=8, replace=False):
        top = search.search(positives[i], top_k=2)
        if top[0][0] != positives[i] and top[0][1] - top[1][1] > 1e-6:
            raise AssertionError(f"positive {i} not at rank 1: {top[0][1]}")
    del search, model

    # 2. the sharded-vocabulary step against the single-rank step on the card
    # from the same weights on the whole batch, in the port's bf16 tolerances
    with np.load(work / "batch.npz") as data:
        batch = [torch.from_numpy(data[k]).cuda() for k in ("q", "p", "n", "w")]
    steps_out = {}
    lr = PAR_STEP_CONFIG["optimizer"]["lr"]
    for loss, kwargs in PAR_LOSSES.items():
        opt = build_optimizer(PAR_STEP_CONFIG)
        state = create_train_state(_par_model(seed), opt, seed)
        negatives = None if loss == "in_batch" else batch[2]
        _, want = make_train_step(build_loss(loss, **kwargs), opt)(
            state, batch[0], batch[1], negatives, batch[3])
        want = {k: float(v) for k, v in want.items()}
        params = params_to_jax(state.model)
        with np.load(work / f"step_{loss}.npz") as data:
            got_params = {k: data[k] for k in data.files}
        errs = {}
        for key in ("loss", "pos_similarity", "neg_similarity"):
            errs[key] = max(abs(r[f"step_{loss}"]["metrics"][key] - want[key]) for r in ranks)
            if errs[key] > BF16_LOSS_ATOL:
                raise AssertionError(f"{loss} step {key}: {errs[key]} beyond {BF16_LOSS_ATOL}")
        errs["grad_norm_rel"] = max(abs(r[f"step_{loss}"]["metrics"]["grad_norm"] -
                                        want["grad_norm"]) for r in ranks) / want["grad_norm"]
        if errs["grad_norm_rel"] > BF16_NORM_RTOL:
            raise AssertionError(f"{loss} step grad_norm: {errs}")
        for key, want_p in [("table", params["embedding"]["table"]),
                            *params["query_tower"].items()]:
            diff = np.abs(got_params[key] - want_p)
            errs[f"{key}_max"], errs[f"{key}_mean"] = float(diff.max()), float(diff.mean())
            if diff.max() > BF16_PARAMS_LR * lr or diff.mean() > BF16_PARAMS_MEAN_LR * lr:
                raise AssertionError(f"{loss} step {key}: max {diff.max()}, mean {diff.mean()}")
        for r in ranks:
            row = r[f"step_{loss}"]
            if row["launches"] != {"gather_rows": 3 - (loss == "in_batch"),
                                   "scatter_add_rows": 3 - (loss == "in_batch")} or \
                    row["local_table_rows"] != PAR_VOCAB // PAR_MESH["model"]:
                raise AssertionError(f"rank {r['rank']} {loss} step: {row}")
        steps_out[loss] = {"single_rank": want, "ranks": [r[f"step_{loss}"] for r in ranks],
                           "errors": errs}
        del state
        torch.cuda.empty_cache()

    # 3. the sharded index and 4. the round trip
    for r in ranks:
        ix, rt = r["index"], r["round_trip"]
        if ix["launches"] != {"score_topk": PAR_SEARCHES + 1} or not all(ix["found_first"]) \
                or ix["rows_per_shard"] != 250_000 or not rt["equal"] \
                or rt["docs"] != PAR_INDEX_DOCS or not all(rt["found_first"]):
            raise AssertionError(f"rank {r['rank']}: index {ix}, round trip {rt}")

    # 5. a 1-rank NCCL group
    start = time.perf_counter()
    _run_ranks(_rank_entry, [(_nccl_rank, "nccl", work, seed)], work, 180)
    nccl_s = time.perf_counter() - start
    nccl = json.loads((work / "nccl.json").read_text())
    if nccl["backend"] != "nccl" or nccl["metrics_sharded"] != nccl["metrics_unsharded"] or \
            not nccl["lookup_equal"] or abs(nccl["in_batch"][0] - nccl["in_batch"][1]) > 1e-5:
        raise AssertionError(f"1-rank NCCL group: {nccl}")

    launches = {"gather_rows": ranks[0]["train"]["launches"]["gather_rows"],
                "scatter_add_rows": ranks[0]["train"]["launches"]["scatter_add_rows"],
                "score_topk": ranks[0]["index"]["launches"]["score_topk"]}
    parallel = {
        "mesh": PAR_MESH, "ranks": PAR_WORLD, "backend": ranks[0]["backend"],
        "card": card["nvidia_smi"], "ranks_s": ranks_s, "nccl_s": nccl_s,
        "train": {"steps": steps, "vocab": vocab, "batch_loss": batch_loss,
                  "seconds": [r["train"]["seconds"] for r in ranks],
                  "launches_per_rank": [r["train"]["launches"] for r in ranks]},
        "sharded_vocab_step": {"vocab": PAR_VOCAB, "rows_per_shard": PAR_VOCAB // 2,
                               "batch": WORD_BATCH,
                               "tolerance": "loss and similarities within 2e-3, grad_norm "
                                            "rtol 2e-2, params within 10 lr, mean below lr/4",
                               **steps_out},
        "index": {"docs": 1_000_000, "dim": 128, "shards": 4, "k": 10,
                  "search_ms": [r["index"]["search_ms"] for r in ranks],
                  "batch_collectives": [r["index"]["batch_collectives"] for r in ranks],
                  "max_abs_err": max(r["index"]["max_abs_err"] for r in ranks),
                  "near_tie_swaps": sum(r["index"]["near_tie_swaps"] for r in ranks)},
        "shard_kernels": {"checks": shard_checks,
                          "tolerance": "gather bit-equal; scatter-add as the embed phase's"},
        "nccl": nccl, "launches": launches,
    }
    emit("parallel", **parallel)
    return parallel


# ---- 10. hub_serve ------------------------------------------------------------

HUB_SEARCHES, HUB_TOP_K, HUB_ADD_CHUNK = 8, 5, 4096


def _closed_port() -> int:
    """A localhost port nothing listens on: bound, then let go."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _same_results(got: list, want: list, atol: float = 1e-6) -> bool:
    """Two (document, score) lists: scores within ``atol``, and the same
    document at every place whose score ties with no other place's."""
    if len(got) != len(want):
        return False
    scores = [s for _, s in want]
    for (gd, gs), (wd, ws) in zip(got, want):
        tied = sum(abs(ws - s) <= atol for s in scores) > 1
        if abs(gs - ws) > atol or (gd != wd and not tied):
            return False
    return True


def hub_serve_phase(card: dict, seed: int) -> dict:
    """Phase 6's best_model staged by the Hub export, then served as the
    app builds its service: MODEL_CHECKPOINT on the staged copy, and
    CHROMA_HOST on a closed localhost port, so the Chroma backend fails
    (no chromadb, or no server) and the in-process store on the card takes
    over, as in the JAX package."""
    import os

    from twotowers_tpu_torch.hub import save_model_for_hub
    from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
    from twotowers_tpu_torch.kernels import gather, scatter_add, topk
    from twotowers_tpu_torch.serve.app import build_service
    from twotowers_tpu_torch.serve.store import VectorCollection
    from twotowers_tpu_torch.train import load_trained_model

    best = ROOT / "build" / "chip_smoke" / "train" / "ckpt" / "best_model"  # phase 6's
    work = ROOT / "build" / "chip_smoke" / "hub"
    shutil.rmtree(work, ignore_errors=True)
    phase_start = time.perf_counter()

    # 1. stage the model as the Hub upload would carry it
    staged = Path(save_model_for_hub(str(best), str(work), repo_id="chip-smoke/word-vocab"))
    files = {p.relative_to(staged).as_posix() for p in staged.rglob("*") if p.is_file()}
    want_files = {"README.md", "checkpoint/params.npz", "checkpoint/opt_state.npz",
                  "checkpoint/meta.json"}
    card_text = (staged / "README.md").read_text()
    if files != want_files or "library_name: twotowers_tpu_torch" not in card_text:
        raise AssertionError(f"staged layout {sorted(files)}; card {card_text[:200]!r}")

    # 2. the service as the app builds it, on the default device
    texts = list(dict.fromkeys(_positives(ROOT / "build" / "chip_smoke" / "train"
                                          / "triplets.tsv")))
    env = {"MODEL_CHECKPOINT": str(staged / "checkpoint"), "CHROMA_HOST": "127.0.0.1",
           "CHROMA_PORT": str(_closed_port()), "ANONYMIZED_TELEMETRY": "False"}
    saved_env = {key: os.environ.get(key) for key in (*env, "MODEL_REPO_URL")}
    os.environ.update(env)
    os.environ.pop("MODEL_REPO_URL", None)
    try:
        topk.LAUNCHES = 0  # the main path starts here
        gather.LAUNCHES = 0
        scatter_add.LAUNCHES = 0
        start = time.perf_counter()
        service = build_service()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - start
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    store, runtime = service.collection, service.model
    if type(store) is not VectorCollection or runtime is None:
        raise AssertionError(f"no Chroma fallback: collection {type(store)}, model {runtime}")
    on_card = {"runtime": runtime.device.type, "store": store.device.type,
               "model": next(runtime._search.model.parameters()).device.type}

    # 3. serve: add the texts, then 8 searches of texts in the store
    start = time.perf_counter()
    for i in range(0, len(texts), HUB_ADD_CHUNK):
        chunk = texts[i:i + HUB_ADD_CHUNK]
        service.add(chunk, ids=[f"p{j}" for j in range(i, i + len(chunk))])
    torch.cuda.synchronize()
    add_s = time.perf_counter() - start
    rng = np.random.default_rng(seed + 10)
    picks = [int(i) for i in rng.choice(len(texts), size=HUB_SEARCHES, replace=False)]
    before = topk.LAUNCHES
    search_ms, served = [], []
    for i in picks:
        start = time.perf_counter()
        result = service.search(texts[i], top_k=HUB_TOP_K)["results"]
        search_ms.append((time.perf_counter() - start) * 1e3)
        served.append([(r["document"], 1.0 - r["distance"]) for r in result])
    search_launches = topk.LAUNCHES - before
    launches = {"score_topk": topk.LAUNCHES, "gather_rows": gather.LAUNCHES,
                "scatter_add_rows": scatter_add.LAUNCHES}  # the main path ends here
    on_card["matrix"] = store._device_unit.device.type
    if set(on_card.values()) != {"cuda"} or store.count() != len(texts):
        raise AssertionError(f"devices {on_card}, {store.count()} of {len(texts)} texts")
    if search_launches != HUB_SEARCHES or launches["score_topk"] != HUB_SEARCHES \
            or launches["gather_rows"] == 0 or launches["scatter_add_rows"]:
        raise AssertionError(f"launches {launches}, {search_launches} across the searches")

    # each search: first for itself, best_model's own search, the plain version
    model, spec, tokenizer, _ = load_trained_model(str(best))
    direct = TwoTowerSearch(model, spec, tokenizer, max_length=WORD_SEQ, encode_batch_size=4096)
    direct.index_documents(texts)
    position = {text: i for i, text in enumerate(texts)}
    docs, n_docs = store._device_index()
    errs = []
    for i, results in zip(picks, served):
        if not _found_first(results, texts[i]):
            raise AssertionError(f"text {i} not first for itself: {results[:2]}")
        if not _same_results(results, direct.search(texts[i], top_k=HUB_TOP_K)):
            raise AssertionError(f"text {i}: the service and best_model's search differ")
        query = store._unit_queries(runtime.encode_device([texts[i]], "query"))
        errs.append(_against_plain(docs, n_docs, query, results, position)[0])

    hub = {"card": card["nvidia_smi"], "staged": sorted(files), "chroma_fallback": True,
           "devices": on_card, "docs": len(texts), "load_s": load_s,
           "add_docs_per_s": len(texts) / add_s, "search_ms": search_ms,
           "search_p50_ms": statistics.median(search_ms), "search_max_ms": max(search_ms),
           "launches": launches, "search_launches": search_launches,
           "max_abs_err": max(errs), "tolerance": "best_model's search within 1e-6; the "
                                                  "plain version as phase 3's",
           "seconds": time.perf_counter() - phase_start}
    emit("hub_serve", **hub)
    return hub


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-docs", type=int, default=1_000_000)
    args = parser.parse_args()

    seconds = {}

    def timed(name, phase, *phase_args):
        start = time.perf_counter()
        out = phase(*phase_args)
        seconds[name] = time.perf_counter() - start
        return out

    card = timed("device", device_phase)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version sums in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    timed("build", build_phase)
    topk_row = timed("kernels", kernels_phase, card, args.n_docs, args.seed)
    serve = timed("serve", serve_phase, card, args.n_docs, args.seed)
    embed_rows = timed("embed", embed_kernels_phase, card, args.seed)
    train = timed("train", train_phase, card, args.seed, embed_rows)
    transformer = timed("transformer", transformer_phase, card, args.seed)
    pretrained = timed("pretrained", pretrained_phase, card, args.seed)
    parallel = timed("parallel", parallel_phase, card, args.seed)
    hub = timed("hub_serve", hub_serve_phase, card, args.seed)
    emit("seconds", **seconds, total=sum(seconds.values()))
    tf_launches = transformer["launches"]
    w2v_launches = pretrained["launches"]
    embed_shape = {"n": MAIN_ROWS, "d": WORD_EMB, "v": WORD_VOCAB}
    print(json.dumps({"kernels": [{
        "name": "score_topk", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/score_topk.cu",
        "replaces": "twotowers_tpu/kernels/pallas_topk.py:52",
        "launches": serve["score_topk_launches"],
        "launches_transformer": tf_launches["score_topk"],
        "launches_pretrained": w2v_launches["score_topk"],
        "launches_parallel": parallel["launches"]["score_topk"],
        "launches_hub": hub["launches"]["score_topk"],
        "max_abs_err": topk_row["max_abs_err"],
        "tolerance": "scores rtol 1e-5 atol 1e-6; indices equal but for near-ties "
                     "(f64 rescores within 1e-5 relative); integer case bit-equal",
        "ms": topk_row["ms"], "kernel_ms": topk_row["ms"], "plain_ms": topk_row["plain_ms"],
        "bound_ms": topk_row["bound_ms"], "bound_by": topk_row["bound_by"],
        "library_ms": topk_row["library_ms"],
        "shape": {"n": args.n_docs, "d": 128, "q": 256, "k": 10, "dtype": "float32"},
        "single_search": {**{key: topk_row["q1_f32"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": {"n": args.n_docs, "d": 128, "q": 1, "k": 10, "dtype": "float32"}},
        "large_k_search": {**{name: {key: row[key] for key in (
            "ms", "pass2_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for name, row in topk_row["q1_k256"].items()},
            "pass1_blocks": topk_row["stream_blocks"],
            "pass2_blocks": topk_row["merge_blocks"],
            "pass2_check": "merge_topk_cuda bit-equal to merge_topk_reference",
            "shape": {"n": args.n_docs, "d": 128, "q": 1, "k": 256,
                      "q4": {"q": 4, "k": 256}, "k100": {"q": 1, "k": 100}}},
        "large_k_batch": {**{name: {key: row[key] for key in (
            "ms", "pass1_ms", "pass2_ms", "sample_ms", "sample_plan", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
            for name, row in topk_row["batch_large_k"].items()},
            "pass1_blocks": topk_row["tiles_blocks"],
            "pass1_check": "score_topk_candidates bit-equal to candidates_reference at Q=32, "
                           "k=256 (integer-valued, f32 and bf16); barred by a sample run's "
                           "k-th pairs at Q=32 and 257 on integer, tied and signed-zero docs",
            "barred_lists": topk_row["barred_lists"],
            "sample_sums_bit_equal": topk_row["sample_sums"],
            "shape": {"n": args.n_docs, "d": 128}},
        "batch_f32_ring": {**{name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for name, row in topk_row["batch_f32"].items()},
            "engine": "fmaf f32 on a TMA ring refilled by each slot's last reader "
                      "(score_topk_tiles_ring<QW, ND>: ND = 6 docs a lane on long splits)",
            "pass1_blocks": topk_row["ring_blocks"],
            "launches_serve_batches": serve["score_topk_ring_launches"],
            "check": "integer-valued bit-equal at Q=32, 64 and off 16-byte alignment, and at "
                     "Q=256 and 257 on splits of 32,768 docs or more (6 docs a lane); pass 1 "
                     "bit-equal to candidates_reference at Q=32 k=10 and Q=64 k=14; float "
                     "by agree at Q=32, 33, 256, 257, D=100 and Q=256 over the serve index",
            "shape": {"n": args.n_docs, "d": 128, "k": 10, "dtype": "float32"}},
        "batch_bf16_tensor_cores": {**{name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for name, row in topk_row["batch_bf16"].items()},
            "engine": "mma.sync m16n8k16 bf16 -> f32 (score_topk_tiles<__nv_bfloat16, *>)",
            "pass1_blocks": topk_row["tiles_blocks"]["torch.bfloat16"],
            "check": "integer-valued bit-equal at Q=64 k=32 and Q=257 k=256; float at "
                     "Q=257 D=1024 k=10 and 256 within the tolerance above",
            "shape": {"n": args.n_docs, "d": 128, "dtype": "bfloat16"}},
        "stream_bf16_tensor_cores": {**{name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms") + (
            ("pass1_ms", "pass2_ms") if "pass1_ms" in row else ())}
            for name, row in topk_row["stream_bf16"].items()},
            "engine": "mma.sync m16n8k16 bf16 -> f32 (score_topk_stream_mma<NQ>)",
            "pass1_blocks": topk_row["stream_mma_blocks"],
            "launches_bf16_small_batch": topk_row["small_batch_launches"],
            "check": "float docs by agree at Q=2-4, k=10, 100, 256 and ragged N; "
                     "integer-valued bit-equal; two calls the same bits; off 16-byte "
                     "alignment on score_topk_stream",
            "shape": {"n": args.n_docs, "d": 128, "dtype": "bfloat16"}},
        "pretrained_search_cli": pretrained["search_cli"], "pretrained_glove": pretrained["glove"],
        "card": card["nvidia_smi"],
    }, {
        "name": "scatter_add_rows", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/scatter_add_rows.cu",
        "replaces": "twotowers_tpu/kernels/pallas_scatter_add.py:82",
        "launches": train["launches"]["scatter_add_rows"],
        "launches_transformer": tf_launches["scatter_add_rows"],
        "launches_pretrained": w2v_launches["scatter_add_rows"],
        "launches_parallel": parallel["launches"]["scatter_add_rows"],
        "launches_hub": hub["launches"]["scatter_add_rows"],
        "max_abs_err": embed_rows["scatter_add_rows"]["max_abs_err"],
        "tolerance": "|kernel - plain| <= 1e-5 * sum|g| of the row + 1e-6 (f32 sums in "
                     "another order); integer-valued g bit-equal",
        **{k: embed_rows["scatter_add_rows"][k] for k in (
            "ms", "kernel_only_ms", "sort_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "library": "torch.zeros(V, D).index_add_(0, ids.long(), g.float()), g widened beforehand",
        "shape": {**embed_shape, "g": "bfloat16", "ids": "Zipf(1.07)"},
        "moe": embed_rows["scatter_add_rows"]["moe"],
        "card": card["nvidia_smi"],
    }, {
        "name": "gather_rows", "route": "cuda",
        "source": "twotowers_tpu_torch/csrc/gather_rows.cu",
        "replaces": "tools/exp_pallas_embed.py:81",
        "launches": train["launches"]["gather_rows"],
        "launches_transformer": tf_launches["gather_rows"],
        "launches_pretrained": w2v_launches["gather_rows"],
        "launches_parallel": parallel["launches"]["gather_rows"],
        "launches_hub": hub["launches"]["gather_rows"],
        "max_abs_err": embed_rows["gather_rows"]["max_abs_err"],
        "tolerance": "bit-equal",
        **{k: embed_rows["gather_rows"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "F.embedding(ids.long(), table.bfloat16()), the table cast beforehand",
        "shape": {**embed_shape, "table": "float32", "out": "bfloat16"},
        "plan": embed_rows["gather_rows"]["plan"],
        "blocks_per_sm": embed_rows["gather_rows"]["blocks_per_sm"],
        "other_shapes": {name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for name, row in embed_rows["gather_rows"]["shapes"].items()},
        "host_us": embed_rows["gather_rows"]["host_us"],
        "moe": embed_rows["gather_rows"]["moe"],
        "pretrained": pretrained["gather"],
        "card": card["nvidia_smi"],
    }]}), flush=True)
    print(card["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
