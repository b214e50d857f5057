"""Time variants of the score + top-k kernel in turns on one card.

    python -m twotowers_tpu_torch.kernels.topk_variants [--against DIR] [--only NAME ...]
                                                        [--k-sweep] [--wide] [--bar-sweep]
                                                        [--ordered] [--ring] [--serve]

Each variant is ``csrc/score_topk.cu`` with one constant or launch bound
rewritten, compiled by ``nvcc`` (all at once) into ``build/topk_variants/``,
or the shipped kernel under another plan. ``--against DIR`` adds the
``score_topk.cu`` of another checkout of the repo (say, a ``git archive``
of the parent commit) as the variant "against", under this tree's plan; a
source without ``score_topk_stream_occupancy`` gets 8 Q <= 4 blocks an SM,
the count that the plan once fixed, and a source without
``score_topk_merge_launch`` (pass 2 as one block a query, before the merge
tree) is launched without a merge group. ``--only`` keeps the named
variants. Each variant is first held bit-equal to the plain version on
integer-valued inputs (Q=1, 4 and 257 at k=10, Q=1, 4 and 257 at k=256,
Q=1 and 33 at k=100, Q=2 at k=33, Q=3 at k=64, Q=5 at k=33), except the
variants in ``CUT``, which skip a stage and are timed only; then timed
with CUDA events at N=1M, D=128 (``SHAPES``: Q=1 and 4 in f32 and bf16,
Q=1 and 4 at k=256 in f32 and bf16, Q=1 at k=100 in f32, Q=32 in f32 and
bf16, Q=256 in f32 and bf16, Q=32 and 256 at k=256 in f32 and bf16, Q=32
at k=100 in f32; k=10 elsewhere; ``--k-sweep`` takes ``K_SWEEP``
instead: Q=32 and 256 in f32 at k = 10 to 32, where the two selections
of the Q >= 5 pass meet, and Q=1 and 4 in f32 and bf16 at k = 10 to 256,
where those of the Q <= 4 pass meet) in the order A B C ... C B A; a time
is the mean of its two turns. Prints one JSON line per variant, with its
blocks (shared bytes, blocks per SM, registers and local bytes of the
Q <= 4 pass at Q=1 and 4, k=10 and 256, and of the Q >= 5 pass at k=10
and 256; the last two null for a source that does not report them), the
inserts a warp makes a query (variants with a count of them) and the
device ms by kernel (``torch.profiler``: pass 1 and each level of pass 2)
at every shape for the shipped kernel and "against" (before the timing,
a line holds their outputs bit-equal at every shape but bf16 at Q >= 5,
where the tensor cores sum in another order than a parent on the CUDA
cores, and ``topk.agree``'s rule holds them; the run fails where they
are not held; a second line says which kernels compiled to the very
SASS instructions of "against"); then the opcode counts of the shipped
passes 1, f32 and bf16 (``cuobjdump -sass``; the run fails unless the
bf16 Q >= 5 pass holds ``HMMA`` and fewer FFMA than HMMA) and the SM
clock and power that ``nvidia-smi`` samples while the shipped kernel
runs Q=256 f32 and Q=1 f32 for a few seconds each; then
``torch.topk`` of the matmul at every shape ("library_ms"); last the
card's name and power limit. The variant "selection cut" times the Q >= 5 pass's
product alone, bf16 on the tensor cores and f32 on the CUDA cores (f32 at k <=
14 in ``score_topk_tiles_ring``; "selection cut (against)" is made of
``--against``'s source).

f32 docs at Q >= 5 and k <= 14 run ``score_topk_tiles_ring`` (pass1
code ``topk.PASS_TILES_RING``, planned by the block shape its occupancy entry
reports); a source without ``score_topk_tiles_ring_occupancy`` (the parent
under ``--against``) runs them on ``score_topk_tiles`` (``PASS_TILES``).
"ring of 3 / 6 stages" sweep its ring's depth, "ring of 8 / 4 query warps at
every Q" its block's shape (8 x 1 or 4 x 2 warps of queries x docs), "ring of
8 x 4 a lane on long splits" and "ring of 8 x 6 a lane on every split above 32
queries" the docs a lane above 32 queries (``topk.ring_lane_docs``), "ring by
cp.async" its copies (every thread's 16-byte ``cp.async`` and a block barrier
a stage, in place of TMA refilled by each slot's last reader), and "split
count rounded down" its plan; "ring without copies" moves no data after the
first ring of stages, "ring product loop alone" keeps only the product loop
(no copy or wait after the first ring, no selection), "ring product loop
alone, doc reads broadcast" the same with every lane reading lane 0's doc
rows (a unit's shared-memory wavefronts halved, the FMAs as many), and "ring clocked"
counts the SM cycles of its warps by phase (the wait for a stage, the copies'
issue and the count of readers, the product, the selection).

The Q >= 5 wide selection (k > 14) by stage: "wide votes only", "wide
votes and queueing" and "wide votes, queueing and sort" stop it after a
stage (timed only; with ``--against`` each is also made of the other
source, "<name> (against)"), "wide counted" counts its survivors and
merges a query and "wide clocked" splits its SM cycles by stage ("selection
cut (against)" is the parent's product alone). Its merges ("merge every
tile", "merge sites by alone"), its buffer ("tile queue of 16 / 64") and
its bar ("no bar", "bar of 65,536
docs at N over 4", "bar at splits of any length", "bar at N over 4", "bar
of 8,192 / 16,384 / 32,768 docs": ``topk.bar_plan``'s keywords, the
sample runs launched by the wrapper's own ``topk.sample_topk``) are swept
by variants too. ``--wide`` times ``WIDE_SHAPES`` (Q=32 and 256 in f32
and bf16 at k=100 and 256), ``--bar-sweep`` ``BAR_SWEEP`` (the same at N
from 16,384 to 524,288: where the sample run weighs more, or there is
none), ``--ordered`` ``ORDERED`` (k=256, N=1M, on a corpus stored topic
by topic and on one sorted by score: ``make_corpus``); the flags add up,
and ``--ring`` times ``RING_SHAPES`` (f32 at Q=5, 32, 33, 64, 256 and
257, k=10, Q=32 and 256 at k=1 and 14, and Q=32 and 256 at k=10 over N =
250,000 and 65,536: ``score_topk_tiles_ring``'s two block shapes, and its
splits at the parallel phase's shard and shorter); ``--serve`` times
``RING_SERVE_SHAPES`` (f32, k=10, at the serve cell's 8,841,823 docs: Q=64,
128, 192, 256 and 257, and Q=64 over 6,600,000 and Q=128 over 6,631,367
docs, splits of 25,088 to 166,912 docs on both sides of
``topk.RING_LONG_SPLIT``), the corpus made at that N.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from . import build, topk
from ..ops.topk_score import score_topk_reference

OUT_DIR = build.BUILD_DIR.parent / "topk_variants"
K, N, DIM = 10, 1_000_000, 128
SHAPES = [(1, torch.float32, K), (1, torch.bfloat16, K), (4, torch.float32, K),
          (4, torch.bfloat16, K), (2, torch.bfloat16, K), (3, torch.bfloat16, K),
          (2, torch.bfloat16, 256), (3, torch.bfloat16, 256),
          (1, torch.float32, 256), (1, torch.bfloat16, 256),
          (32, torch.float32, K), (32, torch.bfloat16, K), (256, torch.float32, K),
          (256, torch.bfloat16, K), (32, torch.float32, 256), (256, torch.float32, 256),
          (32, torch.bfloat16, 256), (256, torch.bfloat16, 256), (32, torch.float32, 100),
          (4, torch.float32, 256), (4, torch.bfloat16, 256), (1, torch.float32, 100)]
K_SWEEP = [(q, torch.float32, k) for q in (32, 256) for k in (10, 12, 14, 16, 24, 32)]
K_SWEEP += [(q, dtype, k) for q in (1, 4) for dtype in (torch.float32, torch.bfloat16)
            for k in (10, 14, 16, 24, 32, 64, 100, 256)]
K_SWEEP += [(q, torch.bfloat16, k) for q in (2, 3) for k in (10, 14, 16, 24, 32, 64, 100, 256)]
# the Q >= 5 pass's wide selection (--wide); the same at smaller N (--bar-sweep: a
# fourth element is N), where the bar's sample run weighs more or there is none;
# and at k=256 on corpora stored in order (--ordered: a fifth element names it)
WIDE_SHAPES = [(q, dtype, k) for q in (32, 256) for dtype in (torch.float32, torch.bfloat16)
               for k in (100, 256)]
BAR_SWEEP = [(q, dtype, k, n) for q in (32, 256) for dtype in (torch.float32, torch.bfloat16)
             for k in (100, 256) for n in (16_384, 65_536, 131_072, 262_144, 524_288)]
ORDERED = [(q, dtype, 256, N, corpus) for q in (32, 256)
           for dtype in (torch.float32, torch.bfloat16) for corpus in ("topics", "sorted")]
# the f32 Q >= 5 narrow pass (--ring): both block shapes of score_topk_tiles_ring,
# each at a full and a ragged query block, k from 1 to WIDE_K
RING_SHAPES = [(q, torch.float32, k) for q in (32, 256, 33, 257, 5, 64) for k in (10,)]
RING_SHAPES += [(q, torch.float32, k) for q in (32, 256) for k in (1, topk.WIDE_K)]
RING_SHAPES += [(q, torch.float32, 10, n) for q in (32, 256) for n in (250_000, 65_536)]
# ... at the serve cell's N (--serve): the block of the long splits and the
# splits on both sides of topk.RING_LONG_SPLIT (Q=64: 33,536 docs a split,
# over 6,600,000 docs: 25,088; Q=128 over 6,631,367 docs: 50,304, Q=128:
# 67,072, Q=192: 100,480, Q=256: 134,016, Q=257: 166,912)
SERVE_N = 8_841_823
RING_SERVE_SHAPES = [(q, torch.float32, 10, SERVE_N) for q in (64, 128, 192, 256, 257)]
RING_SERVE_SHAPES[1:1] = [(64, torch.float32, 10, 6_600_000), (128, torch.float32, 10, 6_631_367)]
TOPICS = 64  # topics of the "topics" corpus
# the query batches of make_corpus, drawn in this order
QUERY_COUNTS = (1, 4, 32, 256, 2, 3, 33, 257, 5, 64, 128, 192)


def make_corpus(kind: str, gen: torch.Generator, dev: torch.device, n: int = N):
    """n unit docs of DIM and queries {Q: (Q, DIM)} for Q in QUERY_COUNTS.
    "random": i.i.d. directions. "topics": TOPICS topics of n / TOPICS docs
    each, stored topic by topic (a doc its topic's direction plus noise of
    the same norm), each query near a random topic's direction. "sorted":
    random docs stored by their score against one direction, ascending,
    each query near that direction. A sample of the first docs would give
    the last two a weak bar."""
    docs = torch.randn(n, DIM, device=dev, generator=gen)
    queries = {q: torch.randn(q, DIM, device=dev, generator=gen) for q in QUERY_COUNTS}
    if kind == "topics":
        centers = torch.randn(TOPICS, DIM, device=dev, generator=gen)
        centers /= centers.norm(dim=1, keepdim=True)
        docs = centers[torch.arange(n, device=dev) * TOPICS // n] + docs / DIM ** 0.5
        for q, x in queries.items():
            pick = torch.randint(0, TOPICS, (q,), device=dev, generator=gen)
            queries[q] = centers[pick] + x / DIM ** 0.5
    elif kind == "sorted":
        u = torch.randn(DIM, device=dev, generator=gen)
        u /= u.norm()
        docs = docs[torch.argsort(docs @ u / docs.norm(dim=1))]
        queries = {q: u + 0.5 * x / DIM ** 0.5 for q, x in queries.items()}
    docs /= docs.norm(dim=1, keepdim=True)
    return docs, queries


def one_full_wave(q, n, sm, per_sm, block_queries=32, tile_docs=topk.BATCH_TILE_N):
    """The plan with the split count rounded down, so that every block fits
    in one wave (the shipped plan rounds up: a few blocks more)."""
    if q <= 4:
        return topk.plan(q, n, sm, per_sm)
    tiles, q_blocks = -(-n // tile_docs), -(-q // block_queries)
    n_splits = max(1, min(sm * per_sm // q_blocks, tiles, topk.MAX_SPLITS))
    split_len = -(-tiles // n_splits) * tile_docs
    return 8, -(-n // split_len), split_len


def two_waves(q, n, sm, per_sm, *block):
    return topk.plan(q, n, sm, 2 * per_sm, *block)


# the Q <= 4 pass's narrow selection (one insert a survivor) at every k
STREAM_NARROW = (f"constexpr int STREAM_WIDE_K = {topk.STREAM_WIDE_K};",
                 "constexpr int STREAM_WIDE_K = 256;")
SELECTION_CUT = ("unsigned m = __ballot_sync(\n                FULL, live && (",
                 "unsigned m = __ballot_sync(\n                FULL, live && s > 1.0e30f && (")
END_MERGE_CUT = ("    if (warp < NQ) {\n", "    if (warp < 0) {\n")
INSERTS_COUNTED = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n__device__ unsigned long long stream_inserts = 0;\n"),
    ("                m &= m - 1;\n",
     "                if (lane == 0) atomicAdd(&stream_inserts, 1ull);\n                m &= m - 1;\n"),
    ('extern "C" {\n',
     'extern "C" {\n\n// The inserts counted since the last call, and the count set to 0.\n'
     "unsigned long long score_topk_stream_inserts() {\n"
     "    unsigned long long n = 0, zero = 0;\n"
     "    cudaMemcpyFromSymbol(&n, stream_inserts, sizeof(n));\n"
     "    cudaMemcpyToSymbol(stream_inserts, &zero, sizeof(zero));\n"
     "    return n;\n}\n"),
]

# the Q >= 5 wide selection by stage (warp_select; each list of rewrites
# is one alternative: this tree's source, then the source before the bar,
# whose selection merged every tile's survivors at once): its survivors never
# queued (the votes alone), never sorted, or never merged. Each cut is a
# branch on k < 0, never taken but unknown to the compiler, so the code,
# its registers and its blocks an SM stay. Without merges the list keeps
# the pad, so only the bar (where there is one) prunes, and a source
# without one queues every score: there the later cuts bound the stages
# from above, and "wide clocked" splits the real flow
WIDE_SORT_MERGE = ("    if (n <= 32) sort_queue<1>(qv, qx, n, lane, n);\n"
                   "    else if (n <= 64) sort_queue<2>(qv, qx, n, lane, n);\n"
                   "    else if (n <= 128) sort_queue<4>(qv, qx, n, lane, n);\n"
                   "    else sort_queue<8>(qv, qx, n, lane, n);\n"
                   "    warp_merge(lv, lx, k, qv, qx, n, lane);\n}")
PARENT_SORT_MERGE = ("        if (n <= 32) sort_queue<1>(qv, qx, n, lane);\n"
                     "        else if (n <= 64) sort_queue<2>(qv, qx, n, lane);\n"
                     "        else if (n <= 128) sort_queue<4>(qv, qx, n, lane);\n"
                     "        else sort_queue<8>(qv, qx, n, lane);\n"
                     "        warp_merge(lists_v + i * ls, lists_i + i * ls, k, qv, qx, n, lane);\n")
WIDE_MERGE = "    warp_merge(lv, lx, k, qv, qx, n, lane);"
PARENT_MERGE = "        warp_merge(lists_v + i * ls, lists_i + i * ls, k, qv, qx, n, lane);"
END_SORT = ("                sort_queue<(TILE_QUEUE + 31) / 32>(buf_v + ql * bs, buf_i + ql * bs, "
            "held[ql],\n                                                   lane, held[ql]);\n")
END_MERGE = ("                warp_merge(list_v + ql * ls, list_i + ql * ls, k, buf_v + ql * bs,\n"
             "                           buf_i + ql * bs, held[ql], lane);\n")
END_FLUSH = "            if (held[ql] > 0) {\n" + END_SORT + END_MERGE + "            }\n"
VOTES = "    const unsigned below = (1u << lane) - 1;\n    unsigned merging = 0;"
PARENT_VOTES = "    const unsigned below = (1u << lane) - 1;\n    while (pending) {"
NO_PENDING = "    pending &= (unsigned)(k >> 31);\n"
WIDE_VOTES_ONLY = [[(VOTES, VOTES.replace("    unsigned merging", NO_PENDING + "    unsigned merging"))],
                   [(PARENT_VOTES, PARENT_VOTES.replace("    while", NO_PENDING + "    while"))]]
WIDE_SORT_CUT = [[(WIDE_SORT_MERGE, "    if (k < 0) {\n" + WIDE_SORT_MERGE[:-1] + "    }\n}"),
                  (END_FLUSH, END_FLUSH.replace("held[ql] > 0) {", "held[ql] > 0 && k < 0) {"))],
                 [(PARENT_SORT_MERGE, "        if (k < 0) {\n" + PARENT_SORT_MERGE + "        }\n")]]
WIDE_MERGE_CUT = [[(WIDE_SORT_MERGE, WIDE_SORT_MERGE.replace(
                      WIDE_MERGE, "    if (k < 0)\n    " + WIDE_MERGE)),
                   (END_MERGE, "                if (k < 0)\n" + END_MERGE)],
                  [(PARENT_SORT_MERGE, PARENT_SORT_MERGE.replace(
                      PARENT_MERGE, "        if (k < 0)\n    " + PARENT_MERGE))]]
# ... and its time by stage on the SM clock: lane 0 of each warp adds the
# cycles of the votes (0), of the rest of warp_select and of the buffers'
# last merges (1), and within those of the sorts (2) and the merges (3) to
# one of 64 sets of counters, read by score_topk_wide_clocks
CLOCK_DECL = ("constexpr unsigned FULL = 0xffffffffu;\n",
              "constexpr unsigned FULL = 0xffffffffu;\n"
              "__device__ unsigned long long wide_clocks[4 * 64];\n"
              "#define WIDE_CLOCK(s, c) if (lane == 0) atomicAdd(&wide_clocks[4 * ((blockIdx.x "
              "+ 3 * blockIdx.y + (threadIdx.x >> 5)) & 63) + (s)], "
              "(unsigned long long)(unsigned)(clock() - (c)))\n")
CLOCK_READ = ('extern "C" {\n',
              'extern "C" {\n\n// The cycles of each stage counted since the last call, the counts\n'
              "// set to 0.\n"
              "void score_topk_wide_clocks(unsigned long long* out) {\n"
              "    unsigned long long c[4 * 64], zero[4 * 64] = {};\n"
              "    cudaMemcpyFromSymbol(c, wide_clocks, sizeof(c));\n"
              "    cudaMemcpyToSymbol(wide_clocks, zero, sizeof(zero));\n"
              "    for (int s = 0; s < 4; ++s) {\n"
              "        out[s] = 0;\n"
              "        for (int j = 0; j < 64; ++j) out[s] += c[4 * j + s];\n"
              "    }\n}\n")
VOTES_START = ("    unsigned long long pass = 0;  // bit 8 i + jj: this lane's score jj of query i "
               "survives\n")
CLOCK_START = (VOTES_START, VOTES_START + "    unsigned c_ = clock();\n")
CLOCK_VOTES = "    WIDE_CLOCK(0, c_);\n    c_ = clock();\n"
WIDE_CLOCKED = [
    [CLOCK_DECL, CLOCK_READ, CLOCK_START, (VOTES, CLOCK_VOTES + VOTES),
     ("        __syncwarp();\n    }\n}\n\n// score_topk_tiles with bf16",
      "        __syncwarp();\n    }\n    WIDE_CLOCK(1, c_);\n}\n\n// score_topk_tiles with bf16"),
     (WIDE_SORT_MERGE, "    unsigned c_ = clock();\n"
      + WIDE_SORT_MERGE.replace(WIDE_MERGE, "    WIDE_CLOCK(2, c_);\n    c_ = clock();\n"
                                + WIDE_MERGE + "\n    WIDE_CLOCK(3, c_);")),
     (END_FLUSH, "            unsigned c_ = clock(), c2_ = c_;\n" + END_FLUSH.replace(
         END_MERGE, "                WIDE_CLOCK(2, c2_);\n                c2_ = clock();\n"
         + END_MERGE + "                WIDE_CLOCK(3, c2_);\n") + "            WIDE_CLOCK(1, c_);\n")],
    [CLOCK_DECL, CLOCK_READ, CLOCK_START, (PARENT_VOTES, CLOCK_VOTES + PARENT_VOTES),
     (PARENT_SORT_MERGE, "        unsigned c2_ = clock();\n" + PARENT_SORT_MERGE.replace(
         PARENT_MERGE, "        WIDE_CLOCK(2, c2_);\n        c2_ = clock();\n" + PARENT_MERGE
         + "\n        WIDE_CLOCK(3, c2_);")),
     ("        warp_merge(lists_v + i * ls, lists_i + i * ls, k, qv, qx, n, lane);\n"
      "        WIDE_CLOCK(3, c2_);\n    }\n}\n",
      "        warp_merge(lists_v + i * ls, lists_i + i * ls, k, qv, qx, n, lane);\n"
      "        WIDE_CLOCK(3, c2_);\n    }\n    WIDE_CLOCK(1, c_);\n}\n")],
]
# the f32 ring pass by phase on the SM clock (score_topk_wide_clocks' counters):
# a warp's wait for its stage and the barrier (0), its copies' issue (1), its
# product (2) and its selection a tile (3)
RING_WAIT = ("            mbar_wait(full_at + 8 * slot, (got / RING_STAGES) & 1);  // the stage has "
             "landed\n")
RING_PRODUCT = ("            if (nq > 0)\n                ring_product(acc, d_rows + slot * R::STAGE, "
                "q_rows + slot * R::STAGE, d_base);\n")
RING_CLOCKED = [
    CLOCK_DECL, CLOCK_READ,
    (RING_WAIT, "            unsigned c_ = clock();\n" + RING_WAIT
     + "            WIDE_CLOCK(0, c_);\n            c_ = clock();\n"),
    (RING_PRODUCT, RING_PRODUCT + "            WIDE_CLOCK(2, c_);\n            c_ = clock();\n"),
    ("                copy_stage(got + RING_STAGES);\n            }\n            ++got;\n",
     "                copy_stage(got + RING_STAGES);\n            }\n            WIDE_CLOCK(1, c_);\n"
     "            ++got;\n"),
    ("                        first + live_docs, nq, lane);\n",
     "                        first + live_docs, nq, lane);\n        WIDE_CLOCK(3, c3_);\n"),
    ("        if (nq > 0)\n            ring_select(",
     "        unsigned c3_ = clock();\n        if (nq > 0)\n            ring_select("),
]
RING_NO_COPIES = ("        if (vec) {\n            mbar_expect(bar, R::STAGE * 4);",
                  "        if (vec && p >= RING_STAGES) {\n"
                  "            mbar_expect(bar, 0);\n            return;\n        }\n"
                  "        if (vec) {\n            mbar_expect(bar, R::STAGE * 4);")
# the ring copied by every thread with cp.async, 16 bytes a copy where the
# unit and its source are 16-byte aligned (4 where not), a block barrier a
# stage, as where TMA cannot take the rows: no TMA
RING_BY_CP_ASYNC = [
    ("    const int vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0",
     "    const int vec = 0 && dim % 4 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0"),
    ("                                           bool live, int cols) {\n#pragma unroll\n",
     "                                           bool live, int cols) {\n"
     "    const bool on = live && cols > 0;\n"
     "    if ((!on || cols >= 4) && reinterpret_cast<uintptr_t>(on ? src : base) % 16 == 0) {\n"
     "        asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n\"\n"
     "                     :: \"r\"(dst), \"l\"(on ? src : base), \"r\"(on ? 16 : 0) : \"memory\");\n"
     "        return;\n    }\n#pragma unroll\n")]

# ... and the survivors (pairs that pass a vote) and merges of its lists,
# counted by atomics, read by score_topk_wide_counts
WIDE_COUNT_DECL = ("constexpr unsigned FULL = 0xffffffffu;\n",
                   "constexpr unsigned FULL = 0xffffffffu;\n"
                   "__device__ unsigned long long wide_survivors = 0, wide_merges = 0;\n")
WIDE_COUNT_READ = ('extern "C" {\n',
                   'extern "C" {\n\n// The survivors counted since the last call (and in *merges the\n'
                   "// merges), both counts set to 0.\n"
                   "unsigned long long score_topk_wide_counts(unsigned long long* merges) {\n"
                   "    unsigned long long n = 0, zero = 0;\n"
                   "    cudaMemcpyFromSymbol(&n, wide_survivors, sizeof(n));\n"
                   "    cudaMemcpyFromSymbol(merges, wide_merges, sizeof(n));\n"
                   "    cudaMemcpyToSymbol(wide_survivors, &zero, sizeof(zero));\n"
                   "    cudaMemcpyToSymbol(wide_merges, &zero, sizeof(zero));\n"
                   "    return n;\n}\n")
COUNT_N = "        const int n = m[0] + m[1];\n        const int h = held[i];\n"  # once a tile
PARENT_COUNT_N = "\n        const int n = m[0] + m[1];\n"
COUNT_SURVIVORS = "        if (lane == 0) atomicAdd(&wide_survivors, (unsigned long long)n);\n"
WIDE_COUNTED = [
    [WIDE_COUNT_DECL, WIDE_COUNT_READ, (COUNT_N, COUNT_N + COUNT_SURVIVORS),
     ("    warp_merge(lv, lx, k, qv, qx, n, lane);\n}",
      "    if (lane == 0) atomicAdd(&wide_merges, 1ull);\n"
      "    warp_merge(lv, lx, k, qv, qx, n, lane);\n}"),
     (END_MERGE, "                if (lane == 0) atomicAdd(&wide_merges, 1ull);\n" + END_MERGE)],
    [WIDE_COUNT_DECL, WIDE_COUNT_READ,
     (PARENT_COUNT_N, PARENT_COUNT_N + COUNT_SURVIVORS
      + "        if (lane == 0) atomicAdd(&wide_merges, 1ull);\n")],
]

SELECTION_CUT_TILES = [
    ("#pragma unroll\n        for (int h = 0; h < 2; ++h) {",
     "bool cut = false;\n#pragma unroll\n        for (int i = 0; i < 8; ++i)\n"
     "#pragma unroll\n            for (int j = 0; j < 8; ++j) cut |= acc[i][j] > 1.0e30f;\n"
     "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
     "            if (!__syncthreads_or(cut)) break;"),
    ("if (doc < end && ranks_before(s, (int)doc, kth_v, kth_i)) mine |= 1u << jj;",
     "if (s > 1.0e30f && doc < end && ranks_before(s, (int)doc, kth_v, kth_i))\n"
     "                mine |= 1u << jj;"),
]
RING_SELECTION_CUT = (
    "        if (!__any_sync(FULL, top >= kth_v) || i >= nq) continue;",
    "        if (!__any_sync(FULL, top > 1.0e30f && top >= kth_v) || i >= nq) continue;")
RING_SMALL_Q = f"constexpr int RING_SMALL_Q = {topk.RING_SMALL_Q};"
RING_STAGES = f"constexpr int RING_STAGES = {topk.RING_STAGES};"
RING_LONG_DOCS = f"constexpr int RING_LONG_LANE_DOCS = {topk.RING_LONG_LANE_DOCS};"
RING_LONG_SPLIT = f"constexpr int RING_LONG_SPLIT = {topk.RING_LONG_SPLIT};"
# the ring's product loop alone: no wait after the first ring, no count of
# readers (so no copy after it), no score passes 1e30
RING_LOOP_ALONE = [RING_SELECTION_CUT,
                   ("            mbar_wait(full_at + 8 * slot",
                    "            if (got < RING_STAGES) mbar_wait(full_at + 8 * slot"),
                   ("                if (lane == 0) {\n                    __threadfence_block();",
                    "                if (lane == 0 && k < 0) {\n"
                    "                    __threadfence_block();")]
RING_DOC_BASE = "    const int d_base = ring_unit(lane, 0);"

# name -> (rewrites, plan): a list of (old, new), or a list of such lists,
# of which the first that fits the source is taken
VARIANTS = {
    "shipped": ([], topk.plan),
    "split count rounded down": ([], one_full_wave),
    "two waves of splits": ([], two_waves),
    "BK=32": ([("constexpr int BK = 16;", "constexpr int BK = 32;")], topk.plan),
    "BS=BN+8": ([("constexpr int BS = BN + 4;", "constexpr int BS = BN + 8;")], topk.plan),
    "launch bound 4 blocks": ([("__launch_bounds__(THREADS1, tiles_min_blocks<T, WIDE>())\n"
                                "score_topk_tiles(",
                                "__launch_bounds__(THREADS1, 4)\nscore_topk_tiles(")], topk.plan),
    "stream ROWS=4": ([("constexpr int ROWS = 8;", "constexpr int ROWS = 4;")], topk.plan),
    "stream 4 warps": ([("constexpr int STREAM_WARPS = 8;", "constexpr int STREAM_WARPS = 4;")],
                       topk.plan),
    "stream 16 warps": ([("constexpr int STREAM_WARPS = 8;",
                          "constexpr int STREAM_WARPS = 16;")], topk.plan),
    "stream launch bound 3 blocks at every Q": ([("NQ == 1 ? (WIDE ? 2 : 3) : 1)", "3)")],
                                                topk.plan),
    "stream no launch bound": ([("NQ == 1 ? (WIDE ? 2 : 3) : 1)", "1)")], topk.plan),
    "merge 256 threads": ([("constexpr int MERGE_THREADS = 512;",
                            "constexpr int MERGE_THREADS = 256;")], topk.plan),
    "merge 1024 threads": ([("constexpr int MERGE_THREADS = 512;",
                             "constexpr int MERGE_THREADS = 1024;")], topk.plan),
    # the narrow selection's one-thread-a-query insertion (k <= WIDE_K) with
    # its queues and lists one word longer than a power of two, so that the
    # 32 lanes of warp 0 (one query each) fall on other banks
    "selection strides padded": ([
        ("queue_i = reinterpret_cast<int*>(smem + BQ * HALF);",
         "queue_i = reinterpret_cast<int*>(smem + BQ * (HALF + 1));"),
        ("queue_v[ql * HALF + p] = s;", "queue_v[ql * (HALF + 1) + p] = s;"),
        ("queue_i[ql * HALF + p] = (int)doc;", "queue_i[ql * (HALF + 1) + p] = (int)doc;"),
        ("queue_v[tid * HALF + c]", "queue_v[tid * (HALF + 1) + c]"),
        ("queue_i[tid * HALF + c]", "queue_i[tid * (HALF + 1) + c]"),
        ("int* top_i = reinterpret_cast<int*>(top_v + BQ * k);",
         "int* top_i = reinterpret_cast<int*>(top_v + BQ * (k + 1));"),
        ("int* queue_n = top_i + BQ * k;", "int* queue_n = top_i + BQ * (k + 1);"),
        ("top_v[ql * k + k - 1]", "top_v[ql * (k + 1) + k - 1]"),
        ("top_i[ql * k + k - 1]", "top_i[ql * (k + 1) + k - 1]"),
        ("float* tv = top_v + tid * k;", "float* tv = top_v + tid * (k + 1);"),
        ("int* ti = top_i + tid * k;", "int* ti = top_i + tid * (k + 1);"),
        ("real ? top_v[e]", "real ? top_v[ql * (k + 1) + r]"),
        ("real ? top_i[e]", "real ? top_i[ql * (k + 1) + r]"),
        ("(2 * STAGE + BQ * k) + sizeof(int) * (BQ * k + 2 * BQ)",
         "(2 * STAGE + BQ * (k + 1)) + sizeof(int) * (BQ * (k + 1) + 2 * BQ)"),
    ], topk.plan),
    # where the Q >= 5 pass switches from one thread a query to warps
    "wide selection at every k": ([("constexpr int WIDE_K = 14;", "constexpr int WIDE_K = 0;")],
                                  topk.plan),
    "narrow selection at every k": ([("constexpr int WIDE_K = 14;",
                                      "constexpr int WIDE_K = 256;")], topk.plan),
    # where the Q <= 4 pass switches from an insert a survivor to batches
    "stream wide selection at every k": ([(STREAM_NARROW[0], "constexpr int STREAM_WIDE_K = 0;")],
                                         topk.plan),
    "stream narrow selection at every k": ([STREAM_NARROW], topk.plan),
    # the wide Q <= 4 selection's queue, and its blocks an SM at Q=1
    "stream queue of 32": ([("constexpr int STREAM_QUEUE = 64;",
                             "constexpr int STREAM_QUEUE = 32;")], topk.plan),
    "stream queue of 128": ([("constexpr int STREAM_QUEUE = 64;",
                              "constexpr int STREAM_QUEUE = 128;")], topk.plan),
    "stream wide launch bound 3 blocks": ([("NQ == 1 ? (WIDE ? 2 : 3) : 1)",
                                            "NQ == 1 ? 3 : 1)")], topk.plan),
    # the narrow Q <= 4 selection by stage: its prune and inserts never taken
    # (a score above 1e30 never comes), then its k-round end-of-split merge
    # skipped as well; and with a count of its inserts (one a warp_insert)
    "stream narrow selection cut": ([STREAM_NARROW, SELECTION_CUT], topk.plan),
    "stream narrow selection and end merge cut": ([STREAM_NARROW, SELECTION_CUT, END_MERGE_CUT],
                                                  topk.plan),
    "stream narrow inserts counted": ([STREAM_NARROW, *INSERTS_COUNTED], topk.plan),
    # the bf16 Q = 2-4 pass (the tensor cores): its product and rings alone
    # (no score passes 1e30, so the selection keeps its ballots and its end
    # of empty lists, sorted and merged by the tree)
    # ... and its ring of 2 stages (32 KB in flight a block, 2 blocks an SM
    # where shared memory allows)
    "stream mma ring of 2 stages": ([("constexpr int STREAM_MMA_STAGES = 4;",
                                      "constexpr int STREAM_MMA_STAGES = 2;")], topk.plan),
    "stream mma selection cut": ([
        ("const bool pass = live && ranks_before(score, (int)doc, kth_v[qq], kth_i[qq]);",
         "const bool pass = live && score > 1.0e30f\n"
         "                             && ranks_before(score, (int)doc, kth_v[qq], kth_i[qq]);"),
    ], topk.plan),
    # the Q >= 5 pass's product alone, bf16 on the tensor cores and f32 on the
    # CUDA cores: no score passes 1e30, so the narrow selection is one
    # block-wide vote a tile (the ring's a warp's votes) and the wide one
    # keeps only its votes; every sum is still read, so none is left out.
    # The second list of rewrites fits a source before the ring
    "selection cut": ([[*SELECTION_CUT_TILES, RING_SELECTION_CUT], SELECTION_CUT_TILES],
                      topk.plan),
    # the f32 Q >= 5 narrow pass (score_topk_tiles_ring): its ring's depth,
    # its block's shape at every Q, and its copies without TMA
    "ring of 3 stages": ([(RING_STAGES, "constexpr int RING_STAGES = 3;")], topk.plan),
    "ring of 6 stages": ([(RING_STAGES, "constexpr int RING_STAGES = 6;")], topk.plan),
    "ring of 8 query warps at every Q": ([(RING_SMALL_Q, "constexpr int RING_SMALL_Q = 4;")],
                                         topk.plan),
    "ring of 4 query warps at every Q": ([(RING_SMALL_Q, "constexpr int RING_SMALL_Q = 4096;")],
                                         topk.plan),
    # the docs a lane above 32 queries: 4 on long splits too (the block of
    # short splits), or 6 on every split
    "ring of 8 x 4 a lane on long splits": (
        [(RING_LONG_DOCS, "constexpr int RING_LONG_LANE_DOCS = 4;")], topk.plan),
    "ring of 8 x 6 a lane on every split above 32 queries": (
        [(RING_LONG_SPLIT, "constexpr int RING_LONG_SPLIT = 0;")], topk.plan),
    "ring by cp.async": (RING_BY_CP_ASYNC, topk.plan),
    # no data moved after the first ring of stages (later stages complete
    # with 0 bytes over stale tiles): the product, selection and bookkeeping
    # alone, timed only
    "ring without copies": ([RING_NO_COPIES], topk.plan),
    # ... and with no wait after the first ring and no count of readers (so no
    # copy after it): the product loop alone
    "ring product loop alone": (RING_LOOP_ALONE, topk.plan),
    # ... with every lane's doc reads at the rows of lane 0 (one address a
    # warp's read: a broadcast, a unit's wavefronts 24 -> 12), the FMAs as many
    "ring product loop alone, doc reads broadcast": (
        [*RING_LOOP_ALONE, (RING_DOC_BASE, RING_DOC_BASE.replace("(lane, 0)", "(0, 0)"))],
        topk.plan),
    "ring clocked": (RING_CLOCKED, topk.plan),
    "wide votes only": (WIDE_VOTES_ONLY, topk.plan),
    "wide votes and queueing": (WIDE_SORT_CUT, topk.plan),
    "wide votes, queueing and sort": (WIDE_MERGE_CUT, topk.plan),
    "wide counted": (WIDE_COUNTED, topk.plan),
    "wide clocked": (WIDE_CLOCKED, topk.plan),
    # the wide selection's buffer of survivors a query, and its bar
    "tile queue of 16": ([("constexpr int TILE_QUEUE = 32;", "constexpr int TILE_QUEUE = 16;")],
                         topk.plan),
    "tile queue of 64": ([("constexpr int TILE_QUEUE = 32;", "constexpr int TILE_QUEUE = 64;")],
                         topk.plan),
    # every tile's survivors merged at once (the buffer's code left dead), and
    # the one sort-and-merge site split in two by where the pairs wait
    "merge every tile": ([("        if (h + n > TILE_QUEUE) {\n            merging |= 1u << i;",
                           "        if (h + n > 0) {\n            merging |= 1u << i;")],
                         topk.plan),
    "merge sites by alone": ([(
        "        sort_merge(lv, lx, k, alone ? bv : qv, alone ? bx : qx, alone ? h : h + n, lane);",
        "        if (alone) sort_merge(lv, lx, k, bv, bx, h, lane);\n"
        "        else sort_merge(lv, lx, k, qv, qx, h + n, lane);")], topk.plan),
    "no bar": ([], topk.plan),
    "bar of 65,536 docs at N over 4": ([], topk.plan),
    "bar at splits of any length": ([], topk.plan),
    "bar at N over 4": ([], topk.plan),
    "bar of 8,192 docs": ([], topk.plan),
    "bar of 16,384 docs": ([], topk.plan),
    "bar of 32,768 docs": ([], topk.plan),
}
# the bar rule of a variant (topk.bar_plan's keywords; None: no bar), where it
# is not the shipped one; a source without score_topk_bar_launch takes none
BAR_RULES = {"no bar": None,
             "bar of 65,536 docs at N over 4": {"min_docs": 65_536, "min_ratio": 4,
                                                "min_tiles": 1},
             "bar at splits of any length": {"min_tiles": 1}, "bar at N over 4": {"min_ratio": 4},
             "bar of 8,192 docs": {"max_docs": 8_192}, "bar of 16,384 docs": {"max_docs": 16_384},
             "bar of 32,768 docs": {"max_docs": 32_768}}
# variants whose output is not the function's: timed, never checked
CUT = {"stream narrow selection cut", "stream narrow selection and end merge cut",
       "ring without copies", "ring product loop alone",
       "ring product loop alone, doc reads broadcast",
       "stream mma selection cut", "selection cut", "wide votes only", "wide votes and queueing",
       "wide votes, queueing and sort"}
# variants made of "against"'s source too, named "<variant> (against)"
OF_AGAINST = ("wide votes only", "wide votes and queueing", "wide votes, queueing and sort",
              "wide counted", "wide clocked", "selection cut")
AGAINST = "against"


def is_cut(name: str) -> bool:
    return name.removesuffix(f" ({AGAINST})") in CUT


def rewrite(name: str, text: str, rewrites) -> str:
    """``text`` with a variant's rewrites: one list of (old, new), applied
    in order, each old found once, or the first of several such lists that
    fits."""
    options = rewrites if rewrites and isinstance(rewrites[0], list) else [rewrites]
    for option in options:
        out = text
        for old, new in option:
            if out.count(old) != 1:
                break
            out = out.replace(old, new)
        else:
            return out
    raise RuntimeError(f"variant {name!r}: no rewrite fits the source once")


def compile_variants(against=None) -> dict:
    """name -> (loaded library, ptxas lines of passes 1, library path)."""
    source = (build.CSRC_DIR / "score_topk.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    todo = {name: (rewrites, source) for name, (rewrites, _) in VARIANTS.items()}
    if against is not None:
        theirs = (Path(against) / "twotowers_tpu_torch" / "csrc" / "score_topk.cu").read_text()
        todo[AGAINST] = ([], theirs)
        for name in OF_AGAINST:
            if name in VARIANTS:
                todo[f"{name} ({AGAINST})"] = (VARIANTS[name][0], theirs)
    built = {}  # source text -> the variant that builds it: one nvcc a text
    for name, (rewrites, text) in todo.items():
        text = rewrite(name, text, rewrites)
        if text in built:
            procs[name] = procs[built[text]]
            continue
        built[text] = name
        tag = re.sub(r"\W+", "_", name)
        src, lib = OUT_DIR / f"{tag}.cu", OUT_DIR / f"lib{tag}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs, outs = {}, {}
    for name, (lib, proc) in procs.items():
        if proc not in outs:
            outs[proc] = proc.communicate()[0].decode(errors="replace")
        out = outs[proc]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} did not build:\n{out[-2000:]}")
        lines = out.splitlines()
        ptxas = [lines[i + j].strip() for i, line in enumerate(lines)
                 if "Function properties" in line and ("score_topk_tiles" in line
                                                       or "score_topk_stream" in line)
                 for j in (0, 1, 2) if i + j < len(lines)]
        libs[name] = (ctypes.CDLL(str(lib)), ptxas, lib)
    return libs


def sass_kernels(lib: Path) -> dict:
    """Each kernel's SASS instructions in ``lib`` (``cuobjdump -sass``;
    addresses and encodings left out), by its mangled name from
    ``score_topk_`` to its parameter list (the template arguments kept),
    which two builds of the source share even where one kernel takes more
    parameters."""
    nvcc = Path(build.find_nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    kernels, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"score_topk_\w+", line)
            name = m and (m.group(0).split("EEEv")[0] if "EEEv" in m.group(0)
                          else m.group(0).split("E")[0])
            current = kernels.setdefault(name, []) if m else None
        elif current is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                current.append(m.group(1))
    return kernels


def sass_opcodes(kernels: dict, kernel: str) -> dict:
    """Opcode counts (every opcode, most common first) of the kernels of
    ``sass_kernels`` whose name holds ``kernel``."""
    counts = collections.Counter()
    for name, instructions in kernels.items():
        if kernel in name:
            for ins in instructions:
                m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ins)
                if m:
                    counts[m.group(1)] += 1
    return dict(counts.most_common())


def clocks_while(fn, seconds: float = 4.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that nvidia-smi samples
    every 100 ms while ``fn`` runs back to back for about ``seconds``."""
    per_call = event_ms(fn) / 1e3
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(int(seconds / per_call)):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines() if line.strip()]
    busy = rows[len(rows) // 4:]  # skip nvidia-smi's start and the ramp
    return {"samples": len(busy), "sm_mhz": statistics.median(r[0] for r in busy),
            "max_sm_mhz": busy[0][1], "power_w": statistics.median(r[2] for r in busy)}


def launcher(lib: ctypes.CDLL, plan, bar_rule=None):
    """score_topk_cuda's launch through ``lib`` under ``plan``, barred by
    sample runs where ``topk.bar_plan(**bar_rule)`` says so (``bar_rule``
    None, or a source without ``score_topk_bar_launch``: never), through
    the wrapper's own ``topk.sample_topk``."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tree = hasattr(lib, "score_topk_merge_launch")  # else pass 2 takes no group
    barred = hasattr(lib, "score_topk_bar_launch")  # else score_topk_launch, no bar
    if barred:
        lib.score_topk_bar_launch.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64,
                                              i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, i64, i64,
                                              ptr]
    else:
        lib.score_topk_launch.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64,
                                          i32, ptr, ptr, ptr, ptr] + [i32] * tree + [ptr]
    mma_lib = hasattr(lib, "score_topk_stream_mma_occupancy")  # else no bf16 Q = 2-4 pass
    ring_lib = hasattr(lib, "score_topk_tiles_ring_occupancy")  # else f32 narrow Q >= 5 on tiles
    if ring_lib:
        lib.score_topk_tiles_ring_occupancy.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 6
    if hasattr(lib, "score_topk_stream_inserts"):
        lib.score_topk_stream_inserts.restype = ctypes.c_ulonglong
    if hasattr(lib, "score_topk_wide_counts"):
        lib.score_topk_wide_counts.restype = ctypes.c_ulonglong
        lib.score_topk_wide_counts.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    occupancy = {}

    def mma(dtype, q, dim=DIM, ptr=0):
        """Whether the call takes score_topk_stream_mma (topk.stream_mma_takes,
        where the source has it)."""
        return mma_lib and topk.stream_mma_takes(dtype, q, dim, ptr)

    def ring(dtype, q, k):
        """Whether the call takes score_topk_tiles_ring (topk.ring_takes,
        where the source has it)."""
        return ring_lib and topk.ring_takes(dtype, q, k)

    def per_sm(dtype, q, k=K, dim=DIM, ptr=0):
        """(shared-memory bytes, blocks per SM, registers, local bytes) of
        the pass that takes Q=q, then the ring's block queries and tile docs
        where it takes it; registers and local bytes None where the source
        does not report them."""
        if ring(dtype, q, k):
            key = ("ring", q)
            if key not in occupancy:
                out = [ctypes.c_int(-1) for _ in range(6)]
                err = lib.score_topk_tiles_ring_occupancy(q, k, *map(ctypes.byref, out))
                if err != 0:
                    raise RuntimeError(f"ring occupancy query failed: cudaError_t {err}")
                occupancy[key] = tuple(o.value for o in out)
            return occupancy[key]
        key = (dtype, min(q, 5), k, dim, mma(dtype, q, dim, ptr))
        bf16 = int(dtype == torch.bfloat16)
        if key not in occupancy:
            out = [ctypes.c_int(-1) for _ in range(4)]
            if q > 4:  # an older source reads the first two pointers, ignores the rest
                err = lib.score_topk_tiles_occupancy(bf16, k, *map(ctypes.byref, out))
            elif key[-1]:
                err = lib.score_topk_stream_mma_occupancy(q, dim, k, *map(ctypes.byref, out))
            elif hasattr(lib, "score_topk_stream_occupancy"):
                err = lib.score_topk_stream_occupancy(bf16, q, dim, k, *map(ctypes.byref, out))
            else:  # a source whose Q <= 4 plan aimed at a fixed 8 blocks an SM
                err, out[1].value = 0, 8
            if err != 0:
                raise RuntimeError(f"occupancy query failed: cudaError_t {err}")
            occupancy[key] = tuple(o.value if o.value >= 0 else None for o in out)
        return occupancy[key]

    def plan_of(q, dtype, k, n=N, dim=DIM, ptr=0):
        sm = torch.cuda.get_device_properties(0).multi_processor_count
        block = per_sm(dtype, q, k, dim, ptr)
        return plan(q, n, sm, block[1], *block[4:])  # the ring: its block queries, tile docs

    def run(docs, queries, k=K):
        n, dim = docs.shape
        q = queries.shape[0]
        rows, n_splits, split_len = plan_of(q, docs.dtype, k, n, dim, docs.data_ptr())
        if mma(docs.dtype, q, dim, docs.data_ptr()):
            rows = topk.PASS_STREAM_MMA
        elif ring(docs.dtype, q, k):
            rows = topk.PASS_TILES_RING

        def launch(n_splits, split_len, split_docs, bar):
            cand_v = torch.empty((q, n_splits, k), dtype=torch.float32, device=docs.device)
            cand_i = torch.empty((q, n_splits, k), dtype=torch.int32, device=docs.device)
            out_v = torch.empty((q, k), dtype=torch.float32, device=docs.device)
            out_i = torch.empty((q, k), dtype=torch.int32, device=docs.device)
            group = [topk.merge_plan(n_splits, k)[0]] if tree else []
            extra = []
            if barred:
                extra = [None, None, 0, split_docs] if bar is None else [
                    bar[0].data_ptr(), bar[1].data_ptr(), bar[0].stride(0), split_docs]
            err = (lib.score_topk_bar_launch if barred else lib.score_topk_launch)(
                docs.data_ptr(), queries.data_ptr(), int(docs.dtype == torch.bfloat16), n, q,
                dim, k, n, n_splits, split_len, rows, cand_v.data_ptr(), cand_i.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), *group, *extra,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
            return out_v, out_i

        top = None
        if barred and bar_rule is not None:
            top = topk.sample_topk(launch, q, k, n, n_splits, split_len, split_len, **bar_rule)
        return launch(n_splits, split_len, split_len, topk.kth(top, k))

    run.lib, run.plan_of = lib, plan_of
    return run, per_sm


def event_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, reps: int = 10) -> dict:
    """Device ms per call of ``fn`` by kernel name (``torch.profiler``),
    after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for event in prof.key_averages():
        if event.device_type == DeviceType.CPU:
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0.0)
        if us > 0:
            name = re.sub(r"^(void )?\(anonymous namespace\)::", "", event.key)
            out[name.split("(")[0]] = us / reps / 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of another checkout whose kernel to time too")
    parser.add_argument("--only", nargs="*", help="the variants to keep (default: all)")
    parser.add_argument("--k-sweep", action="store_true",
                        help="time K_SWEEP (Q >= 5 at k = 10 to 32) in place of SHAPES")
    parser.add_argument("--wide", action="store_true",
                        help="time WIDE_SHAPES (Q=32 and 256 at k=100 and 256)")
    parser.add_argument("--bar-sweep", action="store_true",
                        help="time BAR_SWEEP (the same at N from 16,384 to 524,288)")
    parser.add_argument("--ordered", action="store_true",
                        help="time ORDERED (Q=32 and 256 at k=256 on corpora stored in order)")
    parser.add_argument("--ring", action="store_true",
                        help="time RING_SHAPES (f32 at Q=5 to 257, k=1 to 14: the ring pass)")
    parser.add_argument("--serve", action="store_true",
                        help="time RING_SERVE_SHAPES (the ring pass at the serve cell's N)")
    args = parser.parse_args()
    shapes = ((K_SWEEP if args.k_sweep else []) + (WIDE_SHAPES if args.wide else [])
              + (BAR_SWEEP if args.bar_sweep else []) + (ORDERED if args.ordered else [])
              + (RING_SHAPES if args.ring else []) + (RING_SERVE_SHAPES if args.serve else []))
    shapes = [(*shape, N, "random")[:5] if len(shape) < 4 else (*shape, "random")[:5]
              for shape in shapes or SHAPES]  # (q, dtype, k, n, corpus)
    if not torch.cuda.is_available():
        raise SystemExit("topk_variants: needs a CUDA card")
    if args.only:
        for name in set(VARIANTS) - set(args.only) - {"shipped"}:
            del VARIANTS[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    runs, libs = {}, compile_variants(args.against)
    for name, (lib, ptxas, _) in libs.items():
        run, per_sm = launcher(lib, VARIANTS[name][1] if name in VARIANTS else topk.plan,
                               BAR_RULES.get(name, {}))
        ints = torch.randint(-2, 3, (100_003, 128), device=dev, generator=gen).float()
        qints = torch.randint(-2, 3, (257, 128), device=dev, generator=gen).float()
        for dtype in (torch.float32, torch.bfloat16):
            for q, k in ((1, K), (4, K), (257, K), (1, 256), (4, 256), (1, 100), (2, 33),
                         (3, 64), (2, K), (3, 256), (257, 256), (33, 100), (5, 33), (32, K),
                         (33, 14), (5, 1)):
                if is_cut(name):
                    break
                got = run(ints.to(dtype), qints[:q].to(dtype), k)
                want = score_topk_reference(ints.to(dtype), qints[:q], k)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"variant {name!r} {dtype} Q={q} k={k}: not the "
                                         "plain version's result")
        runs[name] = (run, {"ptxas": ptxas, "occupancy_f32_bf16": {
            f"q{q} k{k}": [per_sm(torch.float32, q, k), per_sm(torch.bfloat16, q, k)]
            for q, k in ((1, K), (2, K), (3, K), (4, K), (1, 256), (2, 256), (3, 256),
                         (4, 256), (5, K), (5, 256), (32, K), (256, K))}})
    inputs, queries = {}, {}
    for kind in dict.fromkeys(["random"] + [shape[4] for shape in shapes]):
        docs, queries[kind] = make_corpus(kind, gen, dev, max(shape[3] for shape in shapes))
        inputs[kind] = {dtype: docs.to(dtype) for dtype in (torch.float32, torch.bfloat16)}
    del docs

    def label(q, dtype, k, n, corpus="random"):
        return (f"q{q} {dtype} k{k}" + (f" n{n}" if n != N else "")
                + (f" {corpus}" if corpus != "random" else ""))

    def args_of(q, dtype, k, n, corpus="random"):
        return inputs[corpus][dtype][:n], queries[corpus][q].to(dtype), k

    if AGAINST in runs:  # the shipped kernel's output is "against"'s
        same, held = {}, {}
        for shape in shapes:
            d, qs, k = args_of(*shape)
            got, want = runs["shipped"][0](d, qs, k), runs[AGAINST][0](d, qs, k)
            bits = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(got[1], want[1]))
            if d.dtype == torch.bfloat16 and qs.shape[0] > 1:  # a parent may sum on CUDA cores
                err, swaps = topk.agree(d, qs, got, want)
                held[label(*shape)] = {"max_abs_err": err, "near_tie_swaps": swaps,
                                       "bit_equal": bits}
                continue
            same[label(*shape)] = bits
        print(json.dumps({"bit_equal_to_against": same, "agree_with_against": held}),
              flush=True)
        if not all(same.values()):
            raise AssertionError(f"the shipped kernel's output is not {AGAINST!r}'s: {same}")
        # which kernels compiled to the very same instructions
        ours, theirs = sass_kernels(libs["shipped"][2]), sass_kernels(libs[AGAINST][2])
        print(json.dumps({"sass_equal_to_against": {
            name: ours[name] == theirs.get(name) for name in sorted(ours)}}), flush=True)
    order = list(runs) + list(runs)[::-1]
    times = {name: {label(*shape): [] for shape in shapes} for name in runs}
    for name in order:
        for shape in shapes:
            d, qs, k = args_of(*shape)
            times[name][label(*shape)].append(event_ms(lambda: runs[name][0](d, qs, k)))
    for name, (run, info) in runs.items():
        ms = {shape: sum(t) / len(t) for shape, t in times[name].items()}
        if name in ("shipped", AGAINST):  # pass 1 and each level of pass 2 apart
            info["device_ms_by_kernel"] = {
                label(*shape): device_ms_by_kernel(lambda: run(*args_of(*shape)))
                for shape in shapes}
        if hasattr(run.lib, "score_topk_stream_inserts"):  # a warp's inserts a query
            info["inserts_per_warp_and_query"] = {}
            for q, dtype, k, n, corpus in shapes:
                if q > 4:
                    continue
                run.lib.score_topk_stream_inserts()
                run(*args_of(q, dtype, k, n, corpus))
                torch.cuda.synchronize()
                n_splits = run.plan_of(q, dtype, k, n)[1]
                info["inserts_per_warp_and_query"][label(q, dtype, k, n, corpus)] = (
                    run.lib.score_topk_stream_inserts() / (n_splits * 8 * q))
        if hasattr(run.lib, "score_topk_wide_counts"):  # survivors and merges a query
            info["wide_counts_per_query"] = {}
            for q, dtype, k, n, corpus in shapes:
                if q <= 4 or k <= topk.WIDE_K:
                    continue
                merges = ctypes.c_ulonglong()
                run.lib.score_topk_wide_counts(ctypes.byref(merges))
                run(*args_of(q, dtype, k, n, corpus))
                torch.cuda.synchronize()
                survivors = run.lib.score_topk_wide_counts(ctypes.byref(merges))
                n_splits = run.plan_of(q, dtype, k, n)[1]
                info["wide_counts_per_query"][label(q, dtype, k, n, corpus)] = {
                    "survivors": survivors / q, "merges": merges.value / q,
                    "survivors_per_split": survivors / (q * n_splits),
                    "merges_per_split": merges.value / (q * n_splits), "n_splits": n_splits}
        if hasattr(run.lib, "score_topk_wide_clocks") and "ring" in name:  # by phase
            info["ring_clocks"] = {}
            clocks = (ctypes.c_ulonglong * 4)()
            for q, dtype, k, n, corpus in shapes:
                if not topk.ring_takes(dtype, q, k):
                    continue
                run.lib.score_topk_wide_clocks(clocks)
                run(*args_of(q, dtype, k, n, corpus))
                torch.cuda.synchronize()
                run.lib.score_topk_wide_clocks(clocks)
                phases = dict(zip(("wait", "copy", "product", "select"), list(clocks)))
                info["ring_clocks"][label(q, dtype, k, n, corpus)] = {
                    **phases, "share": {key: c / sum(phases.values())
                                        for key, c in phases.items()}}
        elif hasattr(run.lib, "score_topk_wide_clocks"):  # SM cycles by stage
            info["wide_clocks"] = {}
            clocks = (ctypes.c_ulonglong * 4)()
            for q, dtype, k, n, corpus in shapes:
                if q <= 4 or k <= topk.WIDE_K:
                    continue
                run.lib.score_topk_wide_clocks(clocks)
                run(*args_of(q, dtype, k, n, corpus))
                torch.cuda.synchronize()
                run.lib.score_topk_wide_clocks(clocks)
                votes, rest, sort, merge = list(clocks)
                info["wide_clocks"][label(q, dtype, k, n, corpus)] = {
                    "votes": votes, "queueing": rest - sort - merge, "sort": sort,
                    "merge": merge, "share": {
                        "votes": votes / (votes + rest), "queueing": (rest - sort - merge)
                        / (votes + rest), "sort": sort / (votes + rest),
                        "merge": merge / (votes + rest)}}
        print(json.dumps({"variant": name, "ms": ms, "turns": times[name], "cut": is_cut(name),
                          **info}), flush=True)
    shipped_sass = sass_kernels(libs["shipped"][2])
    for kernel in ("score_topk_tilesIfLb0", "score_topk_tilesIfLb1",
                   "score_topk_tilesI13__nv_bfloat16Lb0", "score_topk_tilesI13__nv_bfloat16Lb1",
                   "score_topk_streamIfLi1ELb0", "score_topk_streamIfLi1ELb1",
                   "score_topk_stream_mmaILi4", "score_topk_tiles_ringILi4",
                   "score_topk_tiles_ringILi8"):
        ops = sass_opcodes(shipped_sass, kernel)
        print(json.dumps({f"sass_opcodes shipped {kernel}": ops}), flush=True)
        if "bfloat16" in kernel or "mma" in kernel:  # the tensor cores: HMMA, no f32 FMA loop
            hmma = sum(n for op, n in ops.items() if op.startswith("HMMA"))
            ffma = sum(n for op, n in ops.items() if op.startswith("FFMA"))
            if hmma == 0 or ffma >= hmma:
                raise AssertionError(f"{kernel}: {hmma} HMMA, {ffma} FFMA")
    for q in (256, 1):
        d, qs = inputs["random"][torch.float32], queries["random"][q]
        print(json.dumps({f"clocks shipped q{q} f32":
                          clocks_while(lambda: runs["shipped"][0](d, qs))}), flush=True)
    # the yardstick: one PyTorch call for the same function on the same inputs
    library = {}
    for shape in shapes:
        d, qs, k = args_of(*shape)
        library[label(*shape)] = event_ms(lambda: torch.topk(qs @ d.T, k))
    print(json.dumps({"library_ms": library}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
