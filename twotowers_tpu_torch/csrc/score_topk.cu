// Fused dot-product scoring + top-k for Hopper (sm_90a).
//
// Replaces twotowers_tpu/kernels/pallas_topk.py:_kernel (entry
// score_topk_pallas). For each query it keeps the top-k of q . doc^T
// without writing the (Q, N) score matrix. Rows at or past n_docs score
// -1e30 (score_topk_xla's mask), results come best first, and equal scores
// go to the lower doc index (lax.top_k's order). Products are summed in f32
// (bf16 products are exact: widened on the CUDA cores, or on the tensor
// cores at Q >= 5; f32 never goes through TF32, which would break exact
// indices).
//
// Design: two passes, both launched by score_topk_bar_launch.
//  1. Grid (query block x doc split): each block keeps the top-k of its
//     split and writes it to (Q, n_splits, k) scratch, padded with
//     (-inf, INT_MAX). Q <= 4 takes score_topk_stream (bf16 docs at Q =
//     2-4 score_topk_stream_mma, where aligned), Q >= 5 score_topk_tiles
//     (f32 docs at k <= WIDE_K score_topk_tiles_ring); all are below.
//  2. Pass 2 (launch_merge) merges each query's n_splits sorted lists into
//     its k best by a fixed tree of pairwise merges in shared memory.
//
// Pass 2. What bounds it is latency and barrier depth, not bytes: the
// candidates are S*k*8 bytes, about 1 MB at Q=1, k=256 (S = 391-521 lists),
// read once from L2 (0.3 us at the HBM rate). The pass it replaced ran one
// block a query for k rounds, each a dependent global read of every list
// head, a warp shuffle, two __syncthreads and thread 0 alone picking the
// winner: at Q=1, k=256, 256 serial rounds on one SM while the other 131
// idle, 0.30-0.34 ms.
//  - A block copies its lists into dynamic shared memory (values and
//    indices as two planes, 16-byte loads where the runs allow), then runs
//    ceil(log2(lists)) rounds: lists 2p and 2p+1 merge into list p of the
//    other buffer, keeping the first k; an odd last list passes through.
//    A merge's k outputs are cut into a power of two of stretches, as many
//    as the 512 threads allow; a thread finds where its stretch starts by
//    one binary search along the merge path's diagonal, then merges it in
//    order, reloading both heads at each step (no branch splits the warp).
//    One __syncthreads a round. Comparisons are ranks_before itself (a key
//    built from the float's bits would order -0.0 below +0.0), ties go to
//    the left list, no atomics: the tree is fixed by (S, k), the result
//    the parent's bit for bit.
//  - Stretches start a power of two apart and lists of k = 256 all start
//    on bank 0, so without padding a warp's accesses fall on a few banks.
//    One padding word after every 32 pairs (skew) spreads them.
//  - merge_plan (kernels/topk.py) keeps a block within 110 KB (two an SM):
//    one level, one block a query, where all S lists fit (k=10 at S <=
//    909); else level 1 (score_topk_merge_groups, grid Q x ceil(S / G))
//    merges groups of at most the widest power of two of lists that fits
//    (32 at k=256) and writes each winner over its group's first list,
//    which no other block reads, and the last level
//    (score_topk_merge_final) merges the winners: ceil(log2(S)) rounds in
//    all. At Q=1, k=256, S=521: 17 blocks of 31 lists (5 rounds), then one
//    of 17 (5 rounds).
//  - ptxas: 40 registers, no spills, both kernels. The runtime fits 2
//    level-1 blocks an SM at 99,264 bytes (k=256) and 3 last-level blocks
//    at up to 65,376 (k=10, S=528), on an NVIDIA H100 80GB HBM3. PERF.md
//    section 6 has each level's device ms beside the pass it replaced,
//    timed in one run by kernels/topk_variants.py --against.
//
// score_topk_stream (1 <= Q <= 4, every single search). What bounds it on
// an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores) is bytes:
// at N=1M, D=128 the docs are 512 MB in f32, 0.153 ms, and 256 MB in bf16,
// 0.076 ms, against 2*Q*N*D <= 1.0e9 operations, 0.015 ms. So the pass
// streams each doc row through registers once and keeps the loads in flight.
//  - A team of lanes reads a row, 16 bytes a lane (ld.global.nc.v4 through
//    load_unit; scalar loads fill the same registers where D or the pointer
//    is off 16-byte alignment): 32 lanes for the 512 bytes of an f32 row at
//    D=128, 16 lanes for a bf16 row, so a warp reads two bf16 rows at once.
//    Wider rows take one pass of 128 columns after another. Nothing is
//    staged in shared memory but the block's queries (widened, zero-padded
//    to a multiple of 128 columns), since a dot product needs no transpose.
//  - Each lane issues the loads of ROWS rows (8 x 16 bytes) before it sums
//    any of them: 4 KB in flight a warp, 32 KB a block of 8 warps; the
//    card needs about 2.3 MB in flight (0.7 us x 3.35 TB/s), 18 KB an SM.
//  - A lane holds partial sums of Q queries x ROWS rows. A butterfly that
//    halves the rows at each step (a reduce-scatter: 4, 2, then 1 shuffle
//    a query) leaves each lane one row, then plain xor steps finish it:
//    9 shuffles a query for 8 f32 rows, 8 for 16 bf16 rows. The summation
//    order is fixed by the shapes alone.
//  - Narrow selection (k <= STREAM_WIDE_K, score_topk_stream<T, NQ, false>),
//    the TPU kernel's prune (run_kth). Each warp keeps its own sorted top-k
//    in shared memory, so the pass needs no __syncthreads until the split
//    ends. A warp ballots the rows that beat its k-th best; the whole warp
//    inserts each one (a ballot count finds its place, lanes shift the
//    tail), re-ballots against the new k-th best, and goes on. Rows within
//    a warp come in ascending order, so when every score ties only the
//    warp's first k rows pass. At the end warps 0..Q-1 merge the 8 warp
//    lists of their query into the block's k best (k rounds of an arg-best
//    over 8 heads).
//  - Wide selection (k > STREAM_WIDE_K, score_topk_stream<T, NQ, true>).
//    What bounds it is latency, not bytes: a warp sees split_len / 8 rows
//    (about 237 in f32, 316 in bf16 at Q=1, N=1M under the narrow
//    selection's plan; 473 at 2 blocks an SM), so at k = 256 its list
//    barely fills and nearly every row survives. The narrow selection
//    inserted each survivor by a chain of dependent shared-memory rounds:
//    at Q=1, k=256 the inserts took 0.180 ms (f32) and 0.268 (bf16) of a
//    0.41 ms call and the k-round merge 0.034; at Q=4 the inserts took
//    1.23-1.38 of 1.47-1.55 (kernels/topk_variants.py, variants "stream
//    narrow selection cut" and "... and end merge cut", on an NVIDIA H100
//    80GB HBM3, 700.00 W). Here a warp's survivors fill its list unsorted,
//    in lane order (a ballot and a prefix count), until it holds k; then
//    it is sorted once across the warp (sort_list: bitonic, up to 8 pairs
//    a lane). Later survivors, those that beat the k-th best, go to a
//    queue of STREAM_QUEUE pairs a query; when the next iteration might not
//    fit, the queue is sorted (sort_queue) and merged into the list by
//    merge path (warp_merge), which gives the new k-th best. The sorts and
//    merges run in settle, one query at a time, for the queries that need
//    one. A list that never filled is sorted when the split ends, and a
//    queue left over is merged. Then the block's 8 warp lists of each query
//    merge by a tree (stream_tree: 8 -> 4 -> 2 -> 1 by merge-path merges in
//    place, a thread's stretch held in registers across a __syncthreads;
//    the last round writes to cand_v / cand_i). Lists and queues are
//    skewed (a padding word after every 32 pairs). Pairs are unique, so the
//    lists are the narrow selection's bit for bit. Shared memory is 4 Q
//    dpad + 64 Q (list_stride(k) + list_stride(STREAM_QUEUE)) bytes:
//    21,632 at Q=1, k=256 and 86,528 at Q=4.
//  - STREAM_WIDE_K = 10, from topk_variants.py --k-sweep (variants "stream
//    wide / narrow selection at every k", one run, same card). The wide
//    selection is ahead at every k for Q=1 bf16 (0.1141 against 0.1223 ms
//    at k=10), Q=4 f32 (0.2193 against 0.2569) and Q=4 bf16 (0.1631
//    against 0.2097); at Q=1 f32 it is behind up to k=16 (0.1997 against
//    0.1920 at k=10, 0.1998 against 0.1955 at k=16), level at k=24
//    (0.2029) and ahead from k=32 (0.2046 against 0.2067; 0.2054 against
//    0.2316 at k=64). k=10, the searches' default, stays on the narrow
//    selection, today's code; above it the wide one wins on the sum of
//    the four rows at every k of the sweep.
//  - STREAM_QUEUE = 64: queues of 32 lost at Q=4, k=256 (0.2924 against
//    0.2767 ms f32, 0.2836 against 0.2334 bf16), queues of 128 at Q=1
//    (0.2135 against 0.2107 f32 at k=256, 0.2155 against 0.2067 at
//    k=100); the wide Q=1 block capped at 80 registers (3 blocks an SM)
//    spills 8 bytes (f32) and 120 (bf16) and is no faster (0.2139 and
//    0.1758 at k=256). Same tool, variants "stream queue of 32 / 128" and
//    "stream wide launch bound 3 blocks".
//  - plan() (kernels/topk.py) cuts the docs into about one wave of splits,
//    SMs x the blocks per SM that the CUDA runtime reports for this pass
//    (score_topk_stream_occupancy), so pass 2 merges a few hundred lists.
//  - Times at N=1M, D=128, both passes (kernels/topk_variants.py on an
//    NVIDIA H100 80GB HBM3, 700.00 W): k=10 Q=1 f32 0.191 ms, bf16 0.122
//    (the Q <= 4 pass before this one took 0.527 and 0.520); Q=4 f32 0.256, bf16
//    0.210. k=256, against the narrow selection in one run: Q=1 f32 0.402
//    -> 0.211, bf16 0.416 -> 0.131; Q=4 f32 1.469 -> 0.277, bf16 1.539 ->
//    0.233; k=100 Q=1 f32 0.287 -> 0.207. ptxas, narrow: 64 registers at
//    Q=1 f32 and 80 in bf16 (4 and 3 blocks an SM), 96-128 f32 and
//    157-255 bf16 at Q=2..4; wide: 95 at Q=1 f32 and 125 in bf16 (2
//    blocks an SM), 117-128 f32 and 193-223 bf16 at Q=2..4 (Q=4: 2 blocks
//    f32, 1 bf16); no spills. PERF.md section 6 has the final run beside
//    the bound, the plain version and torch.topk of the matmul.
//
// score_topk_stream_mma (bf16 docs at 2 <= Q <= 4; kernels/topk.py's
// stream_mma_takes routes them here where D is a multiple of 8 and the
// docs 16-byte aligned, every other Q <= 4 call to score_topk_stream). The
// bound is score_topk_stream's: 256 MB of bf16 docs at N=1M, D=128, 0.076
// ms. score_topk_stream at Q=4 reached 36% of it (0.212 ms at k=10): 223-255
// registers a lane (8 rows x 16 bytes in flight, the widened queries, 32
// partial sums), one block an SM, 8 widenings and 32 fmaf a unit and a
// 28-shuffle reduce-scatter a warp iteration, and no load in flight while
// a warp sums or selects.
//  - Bytes in flight without registers: each warp copies its own rows by
//    cp.async.cg into a ring of STREAM_MMA_STAGES stages of 32 docs x
//    STREAM_MMA_DEPTH = 64 columns (4 KB; zeros past the split's end and
//    past D by cp.async's src-size), STAGES - 1 of them ahead of the one it
//    multiplies, with cp.async.wait_group and __syncwarp alone: a warp that
//    sorts or merges keeps its copies in flight and stalls no other. 8
//    warps x 3 x 4 KB = 96 KB in flight an SM, where the card needs about
//    18 KB. Warp w takes docs 32 w .. 32 w + 31 of every 256 of its split.
//  - Sums on the tensor cores: mma.sync.m16n8k16 with the step's 32 docs
//    as two M-tiles and the queries as N (column n holds query n % 4, or n
//    % 2 at Q=2; zeros past Q), B's fragments loaded once a block (16
//    registers for the first 128 columns, from shared memory a chunk at a
//    time beyond them), A's by ldmatrix.x4: a stage's k-steps take 8
//    ldmatrix and 8 mma for 32 docs, no widening, no fmaf, no
//    reduce-scatter. Row r of M-tile m is doc 4 (r % 8) + 2 m + r / 8
//    (step_doc), so lane (g, t) holds docs 4 g + 2 (t / 2) .. + 1 and the
//    queries of its columns; at Q=2 each lane holds both queries and keeps
//    doc 4 g + t, its own lane, by selects; at Q=3 and 4 one exchange with
//    lane ^ 1 (2 shuffles) gives each lane its doc's 4 queries. Units are
//    XOR-swizzled by (doc / 4) % 8 (step_unit): an ldmatrix phase reads 8
//    docs 4 apart, a quarter-warp copies 8 units of one doc, each on all 32
//    banks. Products are exact; only the order of the f32 sums differs
//    from the plain version's (integers sum exactly, bit for bit).
//  - The selection is score_topk_stream's wide one at every k, doc base +
//    lane in lane order: fill, sort_list, queue and settle (a queue merged
//    when a step might not fit it: 32 docs), then stream_tree; the same
//    lists, the same candidates. Its narrow one (an insert a survivor) lost
//    at every k from 10 to 256 at Q=2, 3 and 4 (topk_variants.py --k-sweep,
//    variants "stream mma wide / narrow selection at every k", on an NVIDIA
//    H100 80GB HBM3, 700.00 W: k=10 Q=4 0.1207 against 0.1677 ms, Q=3
//    0.1166 against 0.1423, Q=2 0.1123 against 0.1265), so this kernel has
//    no narrow instantiation. Shared memory: the rings (131,072 bytes), the
//    queries in bf16 (rows of D rounded up to 64, plus 16 elements), then
//    the lists: 216,704 bytes at Q=4, k=256, D=128, one block an SM.
//    ptxas: 118 registers at Q=2, 128 at Q=3 and 4, no spills.
//  - Times at N=1M, D=128, both passes, against score_topk_stream in one
//    run (topk_variants.py --against a git archive of the parent, NVIDIA
//    H100 80GB HBM3, 700.00 W): k=10 Q=2 0.1663 -> 0.1066 ms, Q=3 0.2015
//    -> 0.1106, Q=4 0.2074 -> 0.1150; k=256 Q=2 0.1698 -> 0.1267, Q=3
//    0.2011 -> 0.1556, Q=4 0.2311 -> 0.1732 (torch.topk of the matmul
//    0.173-0.194). The product and rings alone (variant "stream mma
//    selection cut") 0.100-0.112 ms; rings of 2 stages (2 blocks an SM
//    where shared memory allows) no faster at k=10 and 7-8% slower at
//    k=256. PERF.md section 6 has chip_smoke.py's rows beside the bound.
//
// score_topk_tiles (Q >= 5). At Q=256, N=1M, D=128 in f32 it is bound by
// operations: 2*256*1e6*128 = 6.55e10 FLOP / 67 TFLOP/s = 0.98 ms against
// 0.15 ms of doc reads. So the inner loop has to be bound by FFMA issue,
// not by shared memory or by waiting on loads. f32 docs sum f32 FMAs on the
// CUDA cores in a fixed order over D; bf16 docs sum on the tensor cores
// (below).
//  - A block of 128 threads owns 32 queries x BN=256 docs a tile; each
//    thread keeps an 8 x 8 register tile (64 f32 sums): warp w holds
//    queries 8w..8w+7, lane l docs 4l..4l+3 and 128+4l..128+4l+3. Both
//    selections read this layout, whichever engine made the sums.
//  - Shared tiles are k-major, q_s[BK][32] and d_s[BK][BS]. For each depth
//    step a thread reads its 8 queries as two float4 (one address across
//    the warp: a broadcast) and its 8 docs as two float4: 4 vector loads,
//    10 wavefronts, for 64 FMAs (16 clocks of an SM's FFMA issue).
//  - BK=16 keeps the staging registers at 8 x 16 bytes (f32) a thread.
//    BS=260 floats (260 = 4 mod 32 banks, a multiple of 4 for float4
//    reads): a warp's transposing stores cover 16 rows x 2 column groups
//    and fall on 32 banks; query stores put lane l on row l, bank l.
//  - Staging: each doc row's chunk is read with 16-byte loads, 16 rows x
//    32 bytes a warp instruction. Where D or a pointer is not 16-byte
//    aligned the same registers are filled by scalar loads. The next
//    chunk's loads (across tiles too) are issued before this chunk's FMAs
//    and stored to the other of two buffers after them: one __syncthreads
//    a chunk. cp.async and TMA cannot transpose, so they are not used.
//  - bf16 docs (score_topk_tiles<__nv_bfloat16, *>): the same 6.55e10
//    FLOP at the tensor cores' 989 TFLOP/s is 0.066 ms, under the 0.076 ms
//    of doc reads; widened and summed by fmaf it took about 2.3 ms of a
//    2.66 ms call at Q=256, k=10. Here mma.sync.m16n8k16 (bf16 in, f32
//    sums) takes the tile's docs as M (16 M-tiles) and the warp's 8 queries
//    as N: 16 MMAs a k-step of 16, 64 sums a lane as before. Each product
//    is exact, so only the order of the f32 additions differs from the
//    plain version's (integers sum exactly, bit for bit). Chunks of
//    MMA_DEPTH = 32 are copied by cp.async.cg, 16 bytes a copy (its
//    src-size zero-fills rows past end and depth past D; D off a multiple
//    of 8 or a pointer off 16-byte alignment: scalar loads and a 16-byte
//    st.shared fill the same units), into a ring of two stages of 256 doc
//    and 32 query rows of 64 bytes: 36,864 bytes, inside the f32 staging's
//    37,376, so tiles_smem holds for both. After cp.async.wait_group 0 and
//    one __syncthreads a chunk, the next chunk is copied while this one is
//    multiplied. ldmatrix.x4 loads the fragments (A: one an M-tile and
//    k-step; B: one for a chunk's two k-steps). One of its phases reads a
//    16-byte unit of 8 rows, which in rows of 64 bytes lie on 16 banks
//    twice: docs sit in slots with bits 0 and 4 swapped (doc_slot) and
//    units are XOR-swizzled by (slot / 32) % 4 (queries by (row / 2) % 4),
//    so each phase and each quarter-warp's copies meet all 32 banks. Lane
//    (g, t) gets M rows g and g + 8 of queries 2t and 2t + 1;
//    quad_transpose (xor 1, then xor 2: 64 shuffles and 192 selects a
//    lane, no sums) gives it 8 queries x 8 docs, and the row map mma_doc
//    makes those docs 4l .. 4l + 3 and 128 on: the selections below are the
//    f32 path's own code, and their lists do not depend on the order in
//    which lanes offer pairs. The wide warps' queues take the stage of the
//    tile's last chunk while the next tile's first lands in the other; the
//    narrow queues take both stages, so that copy starts after them.
//    Launch bound 3 blocks an SM under the narrow selection (168
//    registers) and 2 under the wide one (247), no spills; the k-steps are
//    a loop, since unrolled ptxas loads all 32 A fragments ahead (250
//    registers, spills at 168). f32 asks no minimum: a bound of 1 moved its
//    code (155 -> 159 and 181 -> 213 registers).
//  - bf16 times at N=1M, D=128, against the fmaf product in one run
//    (topk_variants.py --against, NVIDIA H100 80GB HBM3, 700.00 W): k=10
//    Q=256 2.692 -> 1.279 ms (torch.topk of the matmul 2.249), Q=32 0.485
//    -> 0.310 (0.439); k=256 Q=256 4.651 -> 2.869 (2.267), Q=32 0.801 ->
//    0.659 (0.451). The product alone (variant "selection cut", another
//    run) 0.557 and 0.151 ms at k=10, 1.017 and 0.200 at k=256: the
//    selections now set the pace.
//  - Narrow selection (k <= WIDE_K, score_topk_tiles<T, false>): after a
//    tile's D loop each thread tests its scores against its 8 queries'
//    k-th best and queues those that pass, one half tile (128 docs) at a
//    time, in a queue that reuses the staging buffers, and one thread per
//    query insertion-sorts it into that query's top-k. Shared memory is
//    37,376 + 256 k + 256 bytes: 40,192 at k=10.
//  - Times at N=1M, D=128, k=10 (chip_smoke.py, NVIDIA H100 80GB HBM3,
//    700.00 W, the old pass 1 and this one timed in one run): Q=256 f32
//    5.52 ms with the pass it replaced, 2.57-2.58 ms with this kernel
//    (bound 0.98 ms by operations); Q=256 bf16 6.95 -> 2.67-2.69 (fmaf);
//    Q=32 f32 1.02 -> 0.48. 155 registers (f32), no spills: 3 blocks an
//    SM.
//  - Wide selection (k > WIDE_K, score_topk_tiles<T, true>). What bounds
//    it is latency, not bytes or FLOPs: about 256 k / t of a query's
//    scores in tile t beat its split's k-th best (k ln(tiles) + k in a
//    split), and each must reach its place in a sorted list of k. The
//    narrow selection did that with 32 lanes of warp 0, one a query, while
//    three warps waited at __syncthreads: 28.4 ms at Q=32, 53.5 at Q=256,
//    k=256. Here warp w selects for its own queries 8w..8w+7 with
//    __syncwarp alone (warp_select): a lane votes its 8 scores of each
//    query against the query's bar, so a query with no survivor costs one
//    vote; a query's survivors go in doc order (ballots and prefix counts)
//    to its buffer, and are bitonic-sorted across the warp in registers
//    (sort_queue, up to 8 a lane) and merged into the list by merge path
//    (warp_merge: a ballot finds the first lane whose run changes, each
//    lane one binary search and at most ceil(k/32) outputs held in
//    registers, written back after a __syncwarp). Lists and buffers are
//    skewed (a padding word after every 32 pairs). The next tile's first
//    chunk is stored before the selection (buffer 0 is free then; a
//    flood's queue uses buffer 1). Pairs are unique, so the lists are the
//    narrow selection's bit for bit.
//  - The bar (score_topk_bar_launch; kernels/topk.py:bar_plan). Pruned by
//    its own split's k-th best alone, a short split admitted a fifth of
//    its docs: at Q=32 (261 splits of 15 tiles) 1,086 survivors a query
//    and split at k=256, at Q=256 (33 of 119) 1,623, and 15 and 115 merges
//    (kernels/topk_variants.py, variant "wide counted", NVIDIA H100 80GB
//    HBM3, 700.00 W). So where a call's splits span at least BAR_MIN_TILES
//    = 4 tiles, the wrapper first runs both passes over a sample of about
//    BAR_DOCS = 65,536 docs (halved down to BAR_MIN_DOCS = 8,192 until the
//    docs hold it BAR_MIN_RATIO = 8 times): the first tiles of every split,
//    or the first tile of every few splits, so this kernel's split s reads
//    split_docs docs from s split_len. The sample is spread over the
//    corpus, fair for docs stored in topic or time order too, and its
//    splits are long enough at Q=256 over 1M docs (8 tiles) to be barred
//    in turn by one tile of each. Each query's k-th pair there, (v, x),
//    read in place with stride k, is its bar: k docs rank at or before it,
//    so no doc after it is in the top-k, and a split keeps its top-k among
//    the pairs at or before it (tested as "before (v, x + 1)"). Every top-k
//    member still reaches pass 2, which merges the same answer, provided
//    the sample run sums each (query, doc) pair as the main run does: the
//    same instantiation, tiles at the same 256-row offsets, the same vec
//    path (chip_smoke.py holds the bits). After a merge the bar becomes the
//    list's k-th pair where that ranks before it. Where the docs above the
//    bar crowd into a few splits (a corpus sorted by score), those splits
//    flood as every split did before: that costs time, never the result.
//  - Buffers. A query's survivors wait in a buffer of TILE_QUEUE pairs,
//    written in a loop unrolled over the warp's 8 queries (its scores by
//    compile-time index). Only where a tile's survivors would overflow it
//    does the query go through the one site that sorts and merges: the
//    buffer's pairs and the survivors queued together in a staging
//    buffer (the buffer alone first where both would not fit BN), so a
//    merge, O(k) however few pairs arrive, is paid once a buffer; the
//    buffers left at the split's end are merged then. Shared memory is
//    37,376 + 256 (list_stride(k) + list_stride(TILE_QUEUE)) + 384 bytes:
//    113,792 at k=256, 2 blocks an SM (229,632 of 233,472 bytes); 40 pairs
//    would leave one, and "tile queue of 64" (one block an SM) lost 2-3x
//    at Q=256, k=256. 199 registers (f32), 254 (bf16), no spills.
//  - WIDE_K = 14: between k=14 (Q=256: narrow 2.726 ms, wide 2.815) and
//    k=16 (2.903, 2.846); at Q=32 the wide one is faster at every k (0.477
//    against 0.485 at k=10), but it fits 2 blocks an SM against 3, which
//    costs Q=256 (2.748 against 2.594 at k=10) (topk_variants.py
//    --k-sweep, NVIDIA H100 80GB HBM3, 700.00 W).
//  - Times at N=1M, D=128, both passes, in one run against the selection
//    before the bar (every tile's survivors merged at once; topk_variants.py
//    --wide --ordered --bar-sweep --against, same card): k=256 Q=32 f32
//    0.862 -> 0.613 ms, bf16 0.641 -> 0.344; Q=256 f32 4.471 -> 3.575,
//    bf16 2.849 -> 1.920; k=100 Q=32 f32 0.599 -> 0.504. Survivors a query
//    and split 1,085 -> 271 at Q=32, 1,622 -> 433 at Q=256, merges 15 -> 2
//    and 115 -> 7 (the sample runs' included). Docs stored topic by topic:
//    28-44% faster than before; sorted by score: Q=32 within 2%, Q=256
//    7-11% faster (the docs above the bar crowd into the last splits).
//    Where no bar applies (Q=32 up to 131,072 docs, Q=256 at 16,384) this
//    selection is slower than the one before: f32 16-33%, bf16 up to 10%,
//    with the same merges; "merge every tile" is as slow, so the cost lies
//    in the f32 wide kernel's code (199 registers against 181), not in the
//    buffers. PERF.md section 6 has the numbers beside the bound and
//    torch.topk of the matmul. Tried and left out: buffers without a bar
//    (slower at Q=32: every tile of a short split floods), buffers of 16
//    (2-7% slower) or 64 (one block an SM), samples of 8,192-32,768 at 1M
//    docs, sample runs barred in turn at every split length (Q=32 6-9%
//    slower), a prefix of the docs as the sample (a fair sample only of
//    docs stored in random order), the merges at three inlined sites or at one site
//    with selects (up to 7% slower in bf16, 4% faster in f32 at Q=256), and
//    sorting with pair E lane + t in a lane (244 registers, slower).
//
// score_topk_tiles_ring (f32 docs at Q >= 5 and k <= WIDE_K: every batch
// search; kernels/topk.py's ring_takes routes them all here, aligned or
// not). The bound is score_topk_tiles': 0.98 ms of f32 FMAs at Q=256, N=1M,
// D=128. score_topk_tiles<float, false> took 2.573 ms there, its product
// alone (topk_variants.py, variant "selection cut") 2.062: 155 registers, 3
// blocks (12 warps) an SM, each 16-deep chunk staged through 9 registers a
// thread and stored transposed one float at a time, 13 block barriers a
// tile, and no FMA in the block while one thread a query insertion-sorted.
//  - Doc tiles straight into a ring of RING_STAGES stages of RING_DEPTH =
//    16 columns, doc-major: rows of 64 bytes, units of 16 bytes
//    XOR-swizzled by (row / 2) % 4 (ring_unit: TMA's 64-byte swizzle), the
//    block's query rows after them. Where D % 4 == 0 and the rows are
//    16-byte aligned, one thread copies a stage by TMA (one box of the
//    docs, one of the queries; zeros past N, the queries and D); else
//    every thread copies 4 bytes at a time by cp.async. Each stage has a
//    full mbarrier (the copies landed); the warps count themselves as its
//    readers, and the last refills the slot. There is no block barrier in
//    the loop: a warp that selects falls behind by up to RING_STAGES
//    stages while the others go on (the cp.async fallback keeps one a
//    stage). Copied instead by every thread, 16 bytes a cp.async, with one
//    block barrier a stage (topk_variants.py, variant "ring by cp.async"),
//    the ring is 11-12% slower: Q=256 2.263 ms against 2.023, Q=32 0.395
//    against 0.356, in one call.
//  - 8 warps a block: 8 warps of queries x 1 of docs (64 queries against
//    tiles of 128 docs) above RING_SMALL_Q = 32 queries, else 4 x 2 (32
//    queries, tiles of 256), so that a 32-query call idles no warp (8 x 1
//    at every Q: Q=32 0.407 ms against 0.356; 4 x 2 at every Q: Q=33 0.598
//    against 0.501, Q=257 3.166 against 2.468; variants "ring of 8 / 4
//    query warps at every Q"). Each lane keeps 8 queries x RING_LANE_DOCS
//    = 4 docs (rows lane + 32 jj) in registers: a unit of 4 columns is 8
//    broadcast 16-byte reads of the queries and 4 of the lane's doc rows
//    for 128 FMAs, the next unit's docs read ahead of this unit's FMAs,
//    which go column by column so that consecutive FMAs share a doc value
//    (ptxas reuses its register).
//  - Above 32 queries on splits of RING_LONG_SPLIT = 32,768 docs or more
//    (the serve cell's 8.84M docs at Q=256: 134,016 a split) a lane keeps
//    RING_LONG_LANE_DOCS = 6 docs (tiles of 192, 74,800 bytes): 14 reads of
//    16 bytes a unit for 192 FMAs, 1.17 bytes a lane an FMA against 1.5.
//    Its selection weighs more where a split's first tile (every doc beats
//    the pad) is a larger share: at k=10 the block of 6 lost on splits of
//    15,232 docs (N=1M, Q=256: 2.077 ms against 2.011; 6.7% at k=14) and
//    won from 18,944 on (Q=257: 2.431 against 2.459; at the serve size
//    33,536 docs: 4.123 against 4.233, 50,304: 5.952 against 6.261, 67,072:
//    7.781 against 8.285), so the threshold is the power of two below the
//    shortest split where it won by 2% or more. The plan follows the block
//    of 4, so a long split's last tile of 192 may be ragged (masked at
//    `end`).
//  - What bounds the loop is the bytes a lane reads from shared memory (16
//    (8 + ND) a unit for 32 ND FMAs), not the wavefronts: "ring product
//    loop alone" ran at 59% of the FFMA rate with 12 reads a unit, at 60%
//    with every doc read a broadcast (a unit's wavefronts 24 -> 12), and at
//    67% where the compiler merged the query reads to 6 a unit or with 8
//    docs a lane at 1 block an SM (254 registers).
//  - Tried and kept out: the lanes of a warp as 4 query groups x 8 doc
//    groups (32 queries x 32 docs a warp, query rows interleaved g + 4 i so
//    that each read of a unit is one wavefront, 12 for 128 FMAs), its code
//    not kept: its product loop no faster (1.673 ms against 1.669), and 4
//    doc warps keeping lists for the same 32 queries made the selection 4x
//    (Q=256 2.757 ms, 17.58 at the serve size); stages of 2 chunks of 16
//    columns on long splits (3 in the ring, half the waits, counts and
//    refills a column): 15.60-15.71 ms at the serve size with 4 docs a lane,
//    16.85 with 6, against 15.15 with 6 in stages of one; 8 x 8
//    a lane at 1 block an SM (Q=257 3.69 ms) or by 8-byte reads at 2 (40
//    bytes of spills, 2.70 ms); the count of a slot's readers by one
//    atom.acq_rel in place of the two fences (no change).
//  - The product stays IEEE f32 on the CUDA cores: each (query, doc) sum is
//    one fmaf chain in ascending column from 0.f, as score_topk_tiles sums
//    it, over the same zero columns past D (RING_DEPTH = BK: an fmaf of
//    zeros turns a sum of -0 into +0), so every output is
//    score_topk_tiles' bit for bit.
//  - The selection, per warp with __syncwarp alone: each query's sorted
//    list of k <= RING_LIST pairs, padded with (-inf, NO_INDEX), in the
//    warp's own shared memory; its pair k - 1 is the bar. A query goes on
//    only where some lane's largest score reaches the bar's value; its list
//    is then read into lanes 0 .. k - 1, its lanes vote their scores, and
//    each survivor takes its place by a ballot and one shuffle up
//    (ring_insert), or, above 2k survivors (a split's first tile, where
//    every doc beats the pad), k rounds of the warp's best merge them
//    (ring_rounds). At the split's end the doc warps' lists of a query
//    merge by the same inserts and each list goes to cand_v / cand_i as
//    before: pass 2 is unchanged.
//  - ptxas: 128 registers, no spills, 2 blocks (16 warps) an SM at 58,416
//    (Q > 32) and 82,992 bytes (Q <= 32); SASS: 512 FFMA, one stage's
//    product. Times at N=1M, D=128, k=10, both passes, against the parent
//    in one run (topk_variants.py --ring --against a git archive of the
//    parent, NVIDIA H100 80GB HBM3, 700.00 W): Q=256 2.594 -> 2.023 ms,
//    Q=32 0.487 -> 0.356, Q=257 2.882 -> 2.468, Q=33 0.792 -> 0.501, Q=5
//    0.388 -> 0.236 (torch.topk of the matmul 4.856, 0.800, 5.249, 0.943,
//    0.443); outputs the parent's bit for bit. The product alone
//    ("selection cut") 1.870 ms at Q=256, the product loop alone (no copy
//    after the first ring, no wait, no selection: "ring product loop
//    alone") 1.667: 59% of the FFMA rate. Rounding the split count down
//    (one wave at Q=257: 52 splits, not 53) was 2% slower there.
//  - The long-split block (6 docs a lane): 128 registers, no spills, 2
//    blocks an SM at 74,800 bytes; SASS: 768 FFMA a stage. At the serve
//    cell's N = 8,841,823, D=128, k=10, against the parent in one run
//    (topk_variants.py --ring --serve --against a git archive of the
//    parent, NVIDIA H100 80GB HBM3, 700.00 W): Q=256 16.517 -> 15.102 ms,
//    Q=257 20.475 -> 18.618, Q=192 12.428 -> 11.456, Q=128 8.358 -> 7.805;
//    its product loop alone 13.782 ms at Q=256 (62.8% of the FFMA rate).
//    At N=1M the blocks of 4 docs are within 1% of the parent's (Q=256
//    2.013 against 2.030, Q=32 0.352 against 0.355).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS1 = 128;       // score_topk_tiles: 4 warps
// score_topk_bar_launch's pass1: which kernel runs pass 1 (kernels/topk.py)
constexpr int PASS_STREAM = 1, PASS_STREAM_MMA = 2, PASS_TILES = 8;
constexpr int PASS_TILES_RING = 4;  // score_topk_tiles_ring: f32 docs, Q >= 5, k <= WIDE_K
constexpr int MERGE_THREADS = 512;  // pass 2
constexpr int MAX_SPLITS = 1024;
constexpr float MASKED = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// The result order: score descending, then index ascending.
__device__ __forceinline__ bool ranks_before(float as, int ai, float bs, int bi) {
    return as > bs || (as == bs && ai < bi);
}

constexpr int BQ = 32;                  // score_topk_tiles: queries a block
constexpr int BN = 256;                 // doc rows a tile
constexpr int BK = 16;                  // depth of one staged chunk
constexpr int BS = BN + 4;              // d_s row stride in floats (see the note)
constexpr int HALF = BN / 2;            // docs queued at once
constexpr int STAGE = BK * BQ + BK * BS;  // floats of one staging buffer
static_assert(2 * BQ * HALF <= 2 * STAGE, "the queue must fit in the staging buffers");
static_assert(BS % 4 == 0 && STAGE % 4 == 0, "float4 reads need 16-byte rows");

constexpr int MAX_K = 256;
constexpr int WIDE_K = 14;              // score_topk_tiles: k above this selects by warps
constexpr int TILE_QUEUE = 32;          // survivors a wide warp buffers a query between merges
static_assert(TILE_QUEUE >= 1 && TILE_QUEUE <= BN, "a buffer is sorted as a queue of a tile");
constexpr int MAX_RUN = MAX_K / 32;     // list entries a lane merges at most
constexpr int WARP_SCRATCH = 2 * (BN + BN / 32);  // words of a warp's queue, skewed
static_assert(4 * WARP_SCRATCH <= STAGE, "the warps' queues must fit in one staging buffer");

// The 16 bytes of row `row` from column `col` of a (rows, dim) matrix, as
// raw bits: zeros past `rows` or `dim`. `vec`: D and the pointer allow one
// 16-byte load; else scalar loads fill the same bits.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* __restrict__ src, long long row,
                                           long long rows, int col, int dim, bool vec) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row >= rows || col >= dim) return u;
    if (vec) return __ldg(reinterpret_cast<const uint4*>(src + row * dim + col));
    unsigned w[4];
    if constexpr (sizeof(T) == 4) {
        const unsigned* p = reinterpret_cast<const unsigned*>(src) + row * dim + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = col + j < dim ? __ldg(p + j) : 0u;
    } else {
        const unsigned short* p = reinterpret_cast<const unsigned short*>(src) + row * dim + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const unsigned lo = col + 2 * j < dim ? __ldg(p + 2 * j) : 0u;
            const unsigned hi = col + 2 * j + 1 < dim ? __ldg(p + 2 * j + 1) : 0u;
            w[j] = lo | (hi << 16);
        }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 4 f32 or 8 bf16 values of a unit, widened to f32 (exact).
template <typename T>
__device__ __forceinline__ void widen_unit(uint4 u, float (&x)[16 / sizeof(T)]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(T) == 4) {
            x[j] = __uint_as_float(w[j]);
        } else {
            x[2 * j] = __uint_as_float(w[j] << 16);
            x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
    }
}

constexpr int ROWS = 8;             // score_topk_stream: rows a lane has in flight
constexpr int STREAM_WARPS = 8;     // warps a block
constexpr int STREAM_THREADS = 32 * STREAM_WARPS;
constexpr int STREAM_COLS = 128;    // columns a team reads in one pass over a row
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// Where pair e of a list lies in its shared plane: one word of padding
// after every 32, so that threads whose runs start a power of two apart
// (8 pairs at k = 256; pass 2's lists of k = 256 all start on bank 0) fall
// on other banks.
__device__ __forceinline__ int skew(int e) { return e + (e >> 5); }

// Words between two of score_topk_tiles' skewed lists of k pairs.
__host__ __device__ constexpr int list_stride(int k) { return k + (k + 31) / 32; }

// Sort n <= 32 E pairs best first by ranks_before, pair g = 32 t + lane
// in v[t] / x[t] (pairs from n on hold the pad (-inf, NO_INDEX)): a bitonic
// network over 32 E pairs, or at E = 1 over the first P lanes, P the least
// power of two >= n. Exchanges 32 pairs or more apart stay in a lane's
// registers; the others go through shuffles.
template <int E>
__device__ __forceinline__ void warp_sort(float (&v)[E], int (&x)[E], int n, int lane) {
#pragma unroll
    for (int size = 2; size <= 32 * E; size <<= 1) {
        if (E == 1 && size >= 2 * n) break;
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
            for (int t = 0; t < E; ++t) {
                // each run of `size` pairs sorts best first or, every other
                // one, last; the lower pair of an exchange keeps the better
                // pair in the first kind, the worse in the second
                const bool best_first = ((32 * t + lane) & size) == 0;
                if (stride >= 32) {
                    const int u = t | (stride >> 5);
                    if (u == t) continue;
                    if (ranks_before(v[u], x[u], v[t], x[t]) == best_first) {
                        const float tv = v[t];
                        const int tx = x[t];
                        v[t] = v[u]; x[t] = x[u];
                        v[u] = tv; x[u] = tx;
                    }
                } else {
                    const float ov = __shfl_xor_sync(FULL, v[t], stride);
                    const int ox = __shfl_xor_sync(FULL, x[t], stride);
                    const bool keep_best = ((lane & stride) == 0) == best_first;
                    if (ranks_before(ov, ox, v[t], x[t]) == keep_best) { v[t] = ov; x[t] = ox; }
                }
            }
        }
    }
}

// Merge the n sorted pairs sv/sx (skewed) into the sorted list lv/lx of k
// pairs (skewed), keeping its first k, with the whole warp. The list's
// entries that rank before sv[0] stay where they are: a ballot over every
// lane's last entry finds `base`, a multiple of ceil(k / 32) at or before
// the first one that moves. The k - base outputs from there on are cut
// into 32 runs; a lane finds where its run starts by one binary search
// along the merge path's diagonal, merges it into registers, and writes it
// back after a __syncwarp. Pairs are unique, so no tie rule is needed but
// ranks_before's own.
__device__ __forceinline__ void warp_merge(float* lv, int* lx, int k, const float* sv,
                                           const int* sx, int n, int lane) {
    const int run = (k + 31) >> 5;
    const int last = skew(min(k, (lane + 1) * run) - 1);
    const int base = run * __popc(__ballot_sync(FULL, ranks_before(lv[last], lx[last], sv[0],
                                                                   sx[0])));  // skew(0) = 0
    if (base >= k) return;  // sv[0] does not beat the k-th best: nothing moves
    const int outs = k - base, per = (outs + 31) >> 5;
    const int d0 = min(outs, lane * per), d1 = min(outs, d0 + per);
    // i = how many of the first d0 outputs come from the list: lv[base +
    // mid] is among them unless sv[d0 - 1 - mid] ranks before it
    int lo = max(0, d0 - n), hi = d0;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int ea = skew(base + mid), eb = skew(d0 - 1 - mid);
        if (ranks_before(sv[eb], sx[eb], lv[ea], lx[ea])) hi = mid;
        else lo = mid + 1;
    }
    // i + j = d < outs, so the list's head stays inside it
    int i = lo, j = d0 - lo;
    float ov[MAX_RUN];
    int ox[MAX_RUN];
#pragma unroll
    for (int t = 0; t < MAX_RUN; ++t) {
        if (d0 + t >= d1) break;
        const int ea = skew(base + i), eb = skew(min(j, n - 1));
        const float a = lv[ea], b = sv[eb];
        const int ax = lx[ea], bx = sx[eb];
        const bool take_b = j < n && ranks_before(b, bx, a, ax);
        ov[t] = take_b ? b : a;
        ox[t] = take_b ? bx : ax;
        i += !take_b;
        j += take_b;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < MAX_RUN; ++t) {
        if (d0 + t >= d1) break;
        const int e = skew(base + d0 + t);
        lv[e] = ov[t];
        lx[e] = ox[t];
    }
    __syncwarp();
}

// Sort a warp's queue of n <= 32 E survivors (skewed) in place, through
// registers. Given len (n <= len), only its first len places are written,
// the pad (-inf, NO_INDEX) from n on: a list of len = k sorted in place.
template <int E>
__device__ __forceinline__ void sort_queue(float* qv, int* qx, int n, int lane,
                                           int len = 32 * E) {
    float v[E];
    int x[E];
#pragma unroll
    for (int t = 0; t < E; ++t) {
        const int g = 32 * t + lane;
        v[t] = g < n ? qv[skew(g)] : -INFINITY;
        x[t] = g < n ? qx[skew(g)] : NO_INDEX;
    }
    warp_sort<E>(v, x, n, lane);
    __syncwarp();  // every lane has read the queue before it is overwritten
#pragma unroll
    for (int t = 0; t < E; ++t) {
        const int g = 32 * t + lane;
        if (g < len) { qv[skew(g)] = v[t]; qx[skew(g)] = x[t]; }
    }
    for (int g = 32 * E + lane; g < len; g += 32) { qv[skew(g)] = -INFINITY; qx[skew(g)] = NO_INDEX; }
    __syncwarp();
}

// Insert (s, i) into a warp's sorted list lv/li of f entries (at most k),
// with the whole warp: a ballot count gives its place, then the lanes move
// the entries behind it up one place, 32 at a time from the top. The
// caller has pruned it: when the list is full, it ranks before entry k-1.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int& f, int k, float s,
                                            int i, int lane) {
    int p = 0;
    for (int e0 = 0; e0 < f; e0 += 32) {
        const int e = e0 + lane;
        p += __popc(__ballot_sync(FULL, e < f && ranks_before(lv[e], li[e], s, i)));
    }
    for (int hi = min(f, k - 1); hi > p; hi -= 32) {
        const int e = hi - 1 - lane;
        const bool move = e >= p;
        float v = 0.f;
        int vi = 0;
        if (move) { v = lv[e]; vi = li[e]; }
        __syncwarp();
        if (move) { lv[e + 1] = v; li[e + 1] = vi; }
        __syncwarp();
    }
    if (lane == 0) { lv[p] = s; li[p] = i; }
    __syncwarp();
    f = min(f + 1, k);
}

// One step of the reduce-scatter, then the next: the lanes of a team whose
// bit `off` is set keep the upper half of their rows, the others the lower
// half, and each adds its partner's partial sums of the half it keeps.
template <int TL, int NQ, int J>
__device__ __forceinline__ void halve_rows(float (&acc)[ROWS][NQ], int tl) {
    if constexpr ((ROWS >> J) > 1) {
        constexpr int off = TL >> (J + 1), h = ROWS >> (J + 1);
        const bool upper = tl & off;
#pragma unroll
        for (int r = 0; r < h; ++r)
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
                const float send = upper ? acc[r][qq] : acc[r + h][qq];
                const float keep = upper ? acc[r + h][qq] : acc[r][qq];
                acc[r][qq] = keep + __shfl_xor_sync(FULL, send, off);
            }
        halve_rows<TL, NQ, J + 1>(acc, tl);
    }
}

constexpr int STREAM_WIDE_K = 10;   // score_topk_stream: k above this batches its survivors
constexpr int STREAM_QUEUE = 64;    // survivors a wide warp queues a query before a merge
static_assert(STREAM_QUEUE >= 32 && (STREAM_QUEUE & (STREAM_QUEUE - 1)) == 0,
              "a queue is sorted whole: 32 E pairs");

// The wide selection's skewed lists and queues (wide), or the narrow one's
// lists and fill counts, of a Q <= 4 block of n_queries at this k, in bytes.
size_t stream_lists_smem(int n_queries, int k, bool wide) {
    if (wide)
        return 2 * sizeof(float) * STREAM_WARPS * n_queries
               * (list_stride(k) + list_stride(STREAM_QUEUE));
    return sizeof(float) * STREAM_WARPS * n_queries * k
         + sizeof(int) * (STREAM_WARPS * n_queries * k + STREAM_WARPS * n_queries);
}

// The queries' rows, then the lists of the selection k takes.
size_t stream_smem(int n_queries, int dim, int k) {
    const int dpad = (dim + STREAM_COLS - 1) / STREAM_COLS * STREAM_COLS;
    return sizeof(float) * n_queries * dpad + stream_lists_smem(n_queries, k, k > STREAM_WIDE_K);
}

// Sort the first n pairs of a warp's skewed list of k (n <= k) best first
// in place, through registers (E = 1, 2, 4 or 8 a lane: 32 E >= n); the
// pairs from n on become the pad.
__device__ __forceinline__ void sort_list(float* lv, int* lx, int n, int k, int lane) {
    if (n <= 32) sort_queue<1>(lv, lx, n, lane, k);
    else if (n <= 64) sort_queue<2>(lv, lx, n, lane, k);
    else if (n <= 128) sort_queue<4>(lv, lx, n, lane, k);
    else sort_queue<8>(lv, lx, n, lane, k);
}

// The rare steps of a wide stream warp, one query at a time. A query whose
// bit is in `sorting` has its list's first filled[q] pairs sorted in place
// (the list has just filled, or the split ended first); one in `merging`
// has its queue of queued[q] survivors sorted, merged into the list and
// emptied. Then the query's k-th best is read anew. Its registers are
// picked by selects: q is not known at compile time here.
template <int NQ>
__device__ __forceinline__ void settle(unsigned sorting, unsigned merging, float* lists_v,
                                       int* lists_i, float* queues_v, int* queues_i, int ls,
                                       int k, const int (&filled)[NQ], int (&queued)[NQ],
                                       float (&kth_v)[NQ], int (&kth_i)[NQ], int lane) {
    constexpr int qs = list_stride(STREAM_QUEUE);
    while (sorting | merging) {
        const int q = __ffs(sorting | merging) - 1;
        float* lv = lists_v + q * ls;
        int* lx = lists_i + q * ls;
        int f = filled[0], n = queued[0];
#pragma unroll
        for (int j = 1; j < NQ; ++j) {
            f = q == j ? filled[j] : f;
            n = q == j ? queued[j] : n;
        }
        if ((sorting >> q) & 1u) sort_list(lv, lx, f, k, lane);
        const bool merge = (merging >> q) & 1u;
        if (merge) {
            float* qv = queues_v + q * qs;
            int* qx = queues_i + q * qs;
            if (n <= 32) sort_queue<1>(qv, qx, n, lane);
            else if (STREAM_QUEUE <= 64 || n <= 64) sort_queue<2>(qv, qx, n, lane);
            else if (STREAM_QUEUE <= 128 || n <= 128) sort_queue<4>(qv, qx, n, lane);
            else sort_queue<8>(qv, qx, n, lane);
            warp_merge(lv, lx, k, qv, qx, n, lane);
        }
        const float v = lv[skew(k - 1)];
        const int x = lx[skew(k - 1)];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
            kth_v[j] = q == j ? v : kth_v[j];
            kth_i[j] = q == j ? x : kth_i[j];
            queued[j] = q == j && merge ? 0 : queued[j];
        }
        sorting &= ~(1u << q);
        merging &= ~(1u << q);
    }
}

// Outputs a thread of stream_tree takes at most: a merge's k outputs are
// cut into as many power-of-two stretches as the threads allow (the fewest
// in the first round, of 4 NQ merges), or as k allows (then 2 at most).
__host__ __device__ constexpr int tree_run(int nq) {
    return (MAX_K >> ilog2(STREAM_THREADS / (4 * nq))) > 2
        ? MAX_K >> ilog2(STREAM_THREADS / (4 * nq)) : 2;
}

// A wide stream block's 8 warp lists of each query (skewed, sorted, k
// pairs each; query q of warp w at (w NQ + q) ls) merged into the split's
// k best, which go to out_v / out_i + q * out_stride. Round by round (gap
// 1, 2, 4) the lists of warps w and w + gap merge into list w, keeping the
// first k, as pass 2's merge_lists does: a thread takes one stretch of a
// merge's outputs, finds its start by a binary search along the merge
// path's diagonal and merges it into registers; after a __syncthreads it
// writes them over list w, or, in the last round, to out_v / out_i. Ties
// go to the lower warp (pairs are unique but for the pad).
template <int NQ>
__device__ __forceinline__ void stream_tree(float* lists_v, int* lists_i, int ls, int k,
                                            float* out_v, int* out_i, long long out_stride,
                                            int tid) {
    constexpr int RUN = tree_run(NQ);
    for (int gap = 1; gap < STREAM_WARPS; gap <<= 1) {
        const int merges = NQ * STREAM_WARPS / (2 * gap);
        int shift = 0;
        while ((2 << shift) <= k && (merges << (shift + 1)) <= STREAM_THREADS) ++shift;
        const int chunk = ((k - 1) >> shift) + 1;
        const int p = tid >> shift;  // merge p: query p % NQ, warps w and w + gap
        const int q = p % NQ, w = p / NQ * 2 * gap;
        const int d0 = (tid & ((1 << shift) - 1)) * chunk;
        const int d1 = p < merges ? min(d0 + chunk, k) : d0;
        float* av = lists_v + (w * NQ + q) * ls;
        int* ax = lists_i + (w * NQ + q) * ls;
        const float* bv = av + gap * NQ * ls;
        const int* bx = ax + gap * NQ * ls;
        float ov[RUN];
        int ox[RUN];
        if (d0 < d1) {
            // i = how many of the first d0 outputs come from a: a[mid] is
            // among them unless b[d0 - 1 - mid] ranks strictly before it
            int lo = 0, hi = d0;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                const int ea = skew(mid), eb = skew(d0 - 1 - mid);
                if (ranks_before(bv[eb], bx[eb], av[ea], ax[ea])) hi = mid;
                else lo = mid + 1;
            }
            // i + j = d < k, so both heads stay inside their lists
            int i = lo, j = d0 - lo;
#pragma unroll
            for (int t = 0; t < RUN; ++t) {
                if (d0 + t >= d1) break;
                const float a = av[skew(i)], b = bv[skew(j)];
                const int ai = ax[skew(i)], bi = bx[skew(j)];
                const bool take_b = ranks_before(b, bi, a, ai);
                ov[t] = take_b ? b : a;
                ox[t] = take_b ? bi : ai;
                i += !take_b;
                j += take_b;
            }
        }
        __syncthreads();  // every merge has read its lists
        const bool last = 2 * gap == STREAM_WARPS;
#pragma unroll
        for (int t = 0; t < RUN; ++t) {
            if (d0 + t >= d1) break;
            if (last) {
                out_v[q * out_stride + d0 + t] = ov[t];
                out_i[q * out_stride + d0 + t] = ox[t];
            } else {
                av[skew(d0 + t)] = ov[t];
                ax[skew(d0 + t)] = ox[t];
            }
        }
        if (!last) __syncthreads();
    }
}

// At Q=1 ptxas would take ~116 registers and fit 2 blocks an SM; capped at
// 80 it fits 3-4 with no spills, more loads in flight. At Q >= 2 the same
// cap spills, and so does the wide selection's at Q=1 (its sort of up to
// 8 pairs a lane), which is capped at 128: 2 blocks an SM. WIDE (k >
// STREAM_WIDE_K): each warp queues its survivors and sorts and merges them
// in batches, and the warp lists merge by a tree; else each survivor is
// inserted at once (see the note).
template <typename T, int NQ, bool WIDE>
__global__ void __launch_bounds__(STREAM_THREADS, NQ == 1 ? (WIDE ? 2 : 3) : 1)
score_topk_stream(const T* __restrict__ docs, const T* __restrict__ queries, long long n,
                  int dim, int k, long long n_docs, long long split_len, int vec,
                  float* __restrict__ cand_v, int* __restrict__ cand_i) {
    constexpr int V = 16 / sizeof(T);           // values a 16-byte unit
    constexpr int TL = STREAM_COLS / V;         // lanes a team (one row at a time)
    constexpr int TEAMS = 32 / TL;              // rows a warp reads at once
    constexpr int RPW = ROWS * TEAMS;           // rows a warp iteration
    constexpr int STEPS = ilog2(ROWS);          // reduce-scatter steps
    static_assert(TL >= ROWS && (ROWS & (ROWS - 1)) == 0, "the butterfly halves ROWS per step");

    const int dpad = (dim + STREAM_COLS - 1) / STREAM_COLS * STREAM_COLS;
    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);                   // [NQ][dpad]
    float* list_v = q_s + NQ * dpad;                                // [warps][NQ][k], sorted
    int* list_i = reinterpret_cast<int*>(list_v + STREAM_WARPS * NQ * k);
    int* list_n = list_i + STREAM_WARPS * NQ * k;                   // [warps][NQ]
    // wide selection: lists [warps][NQ][ls] and queues [warps][NQ][qs], skewed
    const int ls = list_stride(k);
    constexpr int qs = list_stride(STREAM_QUEUE);
    float* wide_v = q_s + NQ * dpad;
    int* wide_i = reinterpret_cast<int*>(wide_v + STREAM_WARPS * NQ * ls);
    float* queue_v = reinterpret_cast<float*>(wide_i + STREAM_WARPS * NQ * ls);
    int* queue_i = reinterpret_cast<int*>(queue_v + STREAM_WARPS * NQ * qs);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int tl = lane % TL, team = lane / TL;
    const int split = blockIdx.x;
    const long long begin = (long long)split * split_len;
    const long long end = min(begin + split_len, n);

    for (int e = tid; e < NQ * dpad; e += STREAM_THREADS) {
        const int qq = e / dpad, c = e % dpad;
        q_s[e] = c < dim ? widen(queries[(long long)qq * dim + c]) : 0.f;
    }
    __syncthreads();

    // After the reduce-scatter a lane holds row `held` of its team's ROWS;
    // the lanes of a row agree, and the lowest of them tests it.
    int held = 0;
#pragma unroll
    for (int j = 0; j < STEPS; ++j)
        if (tl & (TL >> (j + 1))) held += ROWS >> (j + 1);
    const bool owner = (tl & (TL / ROWS - 1)) == 0;

    float* my_v = list_v + warp * NQ * k;
    int* my_i = list_i + warp * NQ * k;
    int filled[NQ], queued[NQ];
    float kth_v[NQ];
    int kth_i[NQ];
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
        filled[qq] = 0;
        queued[qq] = 0;
        kth_v[qq] = WIDE ? -INFINITY : 0.f;  // the wide selection's pad
        kth_i[qq] = WIDE ? NO_INDEX : 0;
    }
    float* my_wv = wide_v + warp * NQ * ls;
    int* my_wi = wide_i + warp * NQ * ls;
    float* my_qv = queue_v + warp * NQ * qs;
    int* my_qi = queue_i + warp * NQ * qs;
    const unsigned below = (1u << lane) - 1;

    // warp w reads rows base .. base + RPW - 1, row base + r * TEAMS + team
    // in slot r of its lane's team; the block's warps take turns
    for (long long base = begin + (long long)warp * RPW; base < end;
         base += (long long)STREAM_WARPS * RPW) {
        float acc[ROWS][NQ];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) acc[r][qq] = 0.f;

        for (int col = tl * V; col < dpad; col += STREAM_COLS) {
            uint4 u[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                u[r] = load_unit(docs, base + r * TEAMS + team, end, col, dim, vec);
            float qv[NQ][V];
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
                for (int j = 0; j < V; j += 4) {
                    const float4 a = *reinterpret_cast<const float4*>(q_s + qq * dpad + col + j);
                    qv[qq][j] = a.x; qv[qq][j + 1] = a.y; qv[qq][j + 2] = a.z; qv[qq][j + 3] = a.w;
                }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                float x[V];
                widen_unit<T>(u[r], x);
#pragma unroll
                for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
                    for (int j = 0; j < V; ++j) acc[r][qq] = fmaf(qv[qq][j], x[j], acc[r][qq]);
            }
        }

        // reduce-scatter across the team: each step keeps half the rows
        halve_rows<TL, NQ, 0>(acc, tl);
#pragma unroll
        for (int off = TL / ROWS / 2; off > 0; off >>= 1)
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) acc[0][qq] += __shfl_xor_sync(FULL, acc[0][qq], off);

        // the prune: only rows that beat the warp's k-th best are inserted
        const long long doc = base + held * TEAMS + team;
        const bool live = owner && doc < end;
        if constexpr (WIDE) {
            // a row that beats the k-th best (the pad while the list fills)
            // takes, in lane order, the list's next free place or else the
            // queue's; sorts and merges wait for settle
            unsigned sorting = 0, merging = 0;
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
                const float s = doc < n_docs ? acc[0][qq] : MASKED;
                const bool pass = live && ranks_before(s, (int)doc, kth_v[qq], kth_i[qq]);
                const unsigned m = __ballot_sync(FULL, pass);
                const int at = __popc(m & below), got = __popc(m);
                const int take = min(got, k - filled[qq]);
                if (pass) {
                    const bool fill = at < take;
                    const int e = skew(fill ? filled[qq] + at : queued[qq] + at - take);
                    (fill ? my_wv + qq * ls : my_qv + qq * qs)[e] = s;
                    (fill ? my_wi + qq * ls : my_qi + qq * qs)[e] = (int)doc;
                }
                filled[qq] += take;
                queued[qq] += got - take;
                if (take > 0 && filled[qq] == k) sorting |= 1u << qq;
                if (queued[qq] > STREAM_QUEUE - RPW) merging |= 1u << qq;  // room for one more
            }
            if (sorting | merging) {
                __syncwarp();
                settle<NQ>(sorting, merging, my_wv, my_wi, my_qv, my_qi, ls, k, filled, queued,
                           kth_v, kth_i, lane);
            }
            continue;
        }
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
            const float s = doc < n_docs ? acc[0][qq] : MASKED;
            float* lv = my_v + qq * k;
            int* li = my_i + qq * k;
            unsigned m = __ballot_sync(
                FULL, live && (filled[qq] < k || ranks_before(s, (int)doc, kth_v[qq], kth_i[qq])));
            while (m) {
                const int src = __ffs(m) - 1;
                warp_insert(lv, li, filled[qq], k, __shfl_sync(FULL, s, src),
                            __shfl_sync(FULL, (int)doc, src), lane);
                if (filled[qq] == k) { kth_v[qq] = lv[k - 1]; kth_i[qq] = li[k - 1]; }
                m &= m - 1;
                m &= __ballot_sync(FULL, live && (filled[qq] < k
                                                  || ranks_before(s, (int)doc, kth_v[qq], kth_i[qq])));
            }
        }
    }

    if constexpr (WIDE) {
        // a list that never filled is sorted now, a queue left over merged
        unsigned sorting = 0, merging = 0;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
            if (filled[qq] < k) sorting |= 1u << qq;
            else if (queued[qq] > 0) merging |= 1u << qq;
        }
        __syncwarp();
        settle<NQ>(sorting, merging, my_wv, my_wi, my_qv, my_qi, ls, k, filled, queued, kth_v,
                   kth_i, lane);
        __syncthreads();
        stream_tree<NQ>(wide_v, wide_i, ls, k, cand_v + (long long)split * k,
                        cand_i + (long long)split * k, (long long)gridDim.x * k, tid);
        return;
    }
    if (lane == 0) {
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) list_n[warp * NQ + qq] = filled[qq];
    }
    __syncthreads();

    // warp qq merges the warps' lists of query qq: lane w < STREAM_WARPS
    // holds the head of warp w's list, k rounds of an arg-best
    if (warp < NQ) {
        const int qq = warp;
        const int w = lane < STREAM_WARPS ? lane : 0;
        const int len = lane < STREAM_WARPS ? list_n[w * NQ + qq] : 0;
        const float* wv = list_v + (w * NQ + qq) * k;
        const int* wi = list_i + (w * NQ + qq) * k;
        const long long o = ((long long)qq * gridDim.x + split) * k;
        int h = 0;
        for (int r = 0; r < k; ++r) {
            float bv = h < len ? wv[h] : -INFINITY;
            int bi = h < len ? wi[h] : NO_INDEX;
            int bs = h < len ? lane : -1;
#pragma unroll
            for (int off = 1; off < STREAM_WARPS; off <<= 1) {
                const float ov = __shfl_xor_sync(FULL, bv, off);
                const int oi = __shfl_xor_sync(FULL, bi, off);
                const int os = __shfl_xor_sync(FULL, bs, off);
                if (os >= 0 && (bs < 0 || ranks_before(ov, oi, bv, bi))) { bv = ov; bi = oi; bs = os; }
            }
            if (bs == lane) ++h;
            if (lane == 0) { cand_v[o + r] = bv; cand_i[o + r] = bi; }
        }
    }
}

// One chunk of an f32 tile in flight: its 16-byte units in registers.
template <typename T>
struct Stage {
    static_assert(sizeof(T) == 4, "bf16 docs are staged by stage_chunk");
    static constexpr int V = 16 / sizeof(T);       // values a unit
    static constexpr int G = BK / V;               // units a row of the chunk
    static constexpr int U = BN * G / THREADS1;    // doc units a thread
    static constexpr int QU = (BQ * G + THREADS1 - 1) / THREADS1;  // query units a thread
    uint4 d[U];
    uint4 q[QU];

    // Unit u of a thread: row 16 * (warp + 4 * (u / (G/2))) + lane/2, column
    // group 2 * (u % (G/2)) + lane%2, so a warp reads 16 rows x 32 bytes.
    __device__ __forceinline__ static int row(int u, int warp, int lane) {
        return 16 * (warp + 4 * (u / (G / 2))) + (lane >> 1);
    }
    __device__ __forceinline__ static int group(int u, int lane) {
        return 2 * (u % (G / 2)) + (lane & 1);
    }

    __device__ __forceinline__ void load(const T* docs, const T* queries, long long t0,
                                         long long end, int q0, int n_queries, int d0,
                                         int dim, bool vec, int warp, int lane) {
#pragma unroll
        for (int u = 0; u < U; ++u)
            d[u] = load_unit(docs, t0 + row(u, warp, lane), end, d0 + group(u, lane) * V,
                             dim, vec);
        // query unit i of a thread: row lane, column group warp + 4 i
#pragma unroll
        for (int i = 0; i < QU; ++i)
            if (warp + 4 * i < G)
                q[i] = load_unit(queries, q0 + lane, n_queries, d0 + (warp + 4 * i) * V, dim, vec);
    }

    __device__ __forceinline__ void store(float* buf, int warp, int lane) const {
        float* q_s = buf;
        float* d_s = buf + BK * BQ;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            float x[V];
            widen_unit<T>(d[u], x);
            const int r = row(u, warp, lane), g = group(u, lane);
#pragma unroll
            for (int j = 0; j < V; ++j) d_s[(g * V + j) * BS + r] = x[j];
        }
#pragma unroll
        for (int i = 0; i < QU; ++i) {
            const int g = warp + 4 * i;
            if (g >= G) continue;
            float x[V];
            widen_unit<T>(q[i], x);
#pragma unroll
            for (int j = 0; j < V; ++j) q_s[(g * V + j) * BQ + lane] = x[j];
        }
    }
};

// Sort a warp's queue of n >= 1 survivors (skewed; E = 1, 2, 4 or 8 a
// lane: 32 E >= n) in its first n places and merge it into the sorted
// list lv / lx of k.
__device__ __forceinline__ void sort_merge(float* lv, int* lx, int k, float* qv, int* qx, int n,
                                           int lane) {
    if (n <= 32) sort_queue<1>(qv, qx, n, lane, n);
    else if (n <= 64) sort_queue<2>(qv, qx, n, lane, n);
    else if (n <= 128) sort_queue<4>(qv, qx, n, lane, n);
    else sort_queue<8>(qv, qx, n, lane, n);
    warp_merge(lv, lx, k, qv, qx, n, lane);
}

// One tile's wide selection for a warp's nq queries (8 at most; query i's
// list at lists_v / lists_i + i * ls, its buffer at bufs_v / bufs_i + i *
// list_stride(TILE_QUEUE) holding held[i] survivors, its bar at bar_v[i] /
// bar_i[i]). acc[i][jj] is query i's score of doc t0 + HALF * (jj / 4) +
// 4 * lane + jj % 4. Each lane tests its 8 scores of each query against
// the query's bar (a pair must rank before it), so a query with no
// survivor costs a vote. A query's survivors go in doc order (ballots and
// prefix counts, no atomics) to its buffer, in a loop unrolled over the 8
// queries. Where they would overflow it, the query waits for the second
// loop: the buffer's pairs and the survivors are queued in `scratch`,
// sorted across the warp and merged into the list at once (the buffer
// alone first where both would not fit a queue of BN). One site sorts and
// merges, so the code stays small. After a merge the bar becomes the
// list's k-th pair if that ranks before it.
__device__ __forceinline__ void warp_select(const float (&acc)[8][8], float* lists_v,
                                            int* lists_i, int ls, int k, float* scratch,
                                            float* bufs_v, int* bufs_i, int* held, float* bar_v,
                                            int* bar_i, long long t0, long long end,
                                            long long n_docs, int nq, int lane) {
    constexpr int bs = list_stride(TILE_QUEUE);
    float* qv = scratch;  // [BN] the queue, skewed, then its survivors sorted
    int* qx = reinterpret_cast<int*>(qv + WARP_SCRATCH / 2);
    unsigned pending = 0;         // bit i: query i has survivors, the same in every lane
    unsigned long long pass = 0;  // bit 8 i + jj: this lane's score jj of query i survives
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float kth_v = bar_v[i];
        const int kth_i = bar_i[i];
        unsigned mine = 0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const long long doc = t0 + HALF * (jj >> 2) + 4 * lane + (jj & 3);
            const float s = doc < n_docs ? acc[i][jj] : MASKED;
            if (doc < end && ranks_before(s, (int)doc, kth_v, kth_i)) mine |= 1u << jj;
        }
        pass |= (unsigned long long)mine << (8 * i);
        if (__any_sync(FULL, mine != 0) && i < nq) pending |= 1u << i;
    }
    const unsigned below = (1u << lane) - 1;
    unsigned merging = 0;  // bit i: query i's survivors would overflow its buffer
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (((pending >> i) & 1u) == 0) continue;
        const unsigned mine = (unsigned)(pass >> (8 * i)) & 0xffu;
        // each survivor's place: half 0's docs in order, then half 1's
        int at[2] = {0, 0}, m[2] = {0, 0};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const unsigned b = __ballot_sync(FULL, (mine >> jj) & 1u);
            at[jj >> 2] += __popc(b & below);
            m[jj >> 2] += __popc(b);
        }
        at[1] += m[0];
        const int n = m[0] + m[1];
        const int h = held[i];
        if (h + n > TILE_QUEUE) {
            merging |= 1u << i;
            continue;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            if ((mine >> jj) & 1u) {
                const long long doc = t0 + HALF * (jj >> 2) + 4 * lane + (jj & 3);
                const int p = i * bs + skew(h + at[jj >> 2]++);
                bufs_v[p] = doc < n_docs ? acc[i][jj] : MASKED;
                bufs_i[p] = (int)doc;
            }
        }
        if (lane == 0) held[i] = h + n;
    }
    __syncwarp();
    while (merging) {
        const int i = __ffs(merging) - 1;
        const unsigned mine = (unsigned)(pass >> (8 * i)) & 0xffu;
        int at[2] = {0, 0}, m[2] = {0, 0};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
            const unsigned b = __ballot_sync(FULL, (mine >> jj) & 1u);
            at[jj >> 2] += __popc(b & below);
            m[jj >> 2] += __popc(b);
        }
        at[1] += m[0];
        const int n = m[0] + m[1];
        float* lv = lists_v + i * ls;
        int* lx = lists_i + i * ls;
        float* bv = bufs_v + i * bs;
        int* bx = bufs_i + i * bs;
        const int h = held[i];
        const bool alone = h + n > BN;  // the buffer first, then query i again
        if (!alone) {
            merging &= merging - 1;
            if (lane < h) {  // the buffer's pairs head the queue
                qv[skew(lane)] = bv[skew(lane)];
                qx[skew(lane)] = bx[skew(lane)];
            }
            float s[8];  // acc[i], by selects: i is not known at compile time here
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                float x = acc[0][jj];
#pragma unroll
                for (int ii = 1; ii < 8; ++ii) x = i == ii ? acc[ii][jj] : x;
                s[jj] = x;
            }
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                if ((mine >> jj) & 1u) {
                    const long long doc = t0 + HALF * (jj >> 2) + 4 * lane + (jj & 3);
                    const int p = skew(h + at[jj >> 2]++);
                    qv[p] = doc < n_docs ? s[jj] : MASKED;
                    qx[p] = (int)doc;
                }
            }
        }
        __syncwarp();
        sort_merge(lv, lx, k, alone ? bv : qv, alone ? bx : qx, alone ? h : h + n, lane);
        if (lane == 0) {
            held[i] = 0;
            const float v = lv[skew(k - 1)];
            const int x = lx[skew(k - 1)];
            if (ranks_before(v, x, bar_v[i], bar_i[i])) {  // a new k-th
                bar_v[i] = v;
                bar_i[i] = x;
            }
        }
        __syncwarp();
    }
}

// score_topk_tiles with bf16 docs runs its product on the tensor cores
// (see the note): chunks of MMA_DEPTH staged by cp.async in a ring of two,
// mma.sync m16n8k16 with the tile's 256 docs as M and a warp's 8 queries as
// N, then quad_transpose hands the sums to the selections in the CUDA-core
// layout (docs 4 lane .. 4 lane + 3 and 128 on, 8 queries a lane).
constexpr int MMA_DEPTH = 32;                        // depth of one staged chunk
constexpr int MMA_ROW = MMA_DEPTH * 2;               // bytes a staged row: 4 units of 16
constexpr int MMA_DOCS = BN * MMA_ROW;               // bytes of a stage's doc rows
constexpr int MMA_STAGE = MMA_DOCS + BQ * MMA_ROW;   // bytes of a stage, its 32 query rows last
static_assert(2 * MMA_STAGE <= 2 * STAGE * (int)sizeof(float),
              "both stages fit the staging bytes that tiles_smem counts");
static_assert(4 * WARP_SCRATCH * (int)sizeof(float) <= MMA_STAGE,
              "the wide warps' queues fit in one stage");

// The doc (from the tile's first) that row r of M-tile m multiplies. Lane
// (g, t) = (lane / 4, lane % 4) gets the sums of rows g and g + 8 of every
// M-tile, and quad_transpose leaves it rows g + 8 (t % 2) of M-tiles 2 jj +
// t / 2: this map makes those docs 4 lane + jj % 4 + 128 (jj / 4), the
// CUDA cores' layout.
__host__ __device__ constexpr int mma_doc(int m, int r) {
    return 128 * (m >> 3) + 16 * (r & 7) + 8 * (m & 1) + 4 * (r >> 3) + ((m >> 1) & 3);
}

// The stage slot of a doc: bits 0 and 4 swapped (its own inverse). One
// ldmatrix phase reads 8 docs 16 apart, which in slots of their own number
// would all be even or all odd; 64-byte slots of one parity take half the
// banks.
__host__ __device__ constexpr int doc_slot(int d) {
    return (d & ~0x11) | ((d >> 4) & 1) | ((d & 1) << 4);
}

// Byte offsets in a stage of 16-byte unit u (depth 8u .. 8u + 7) of doc
// slot s, XOR-swizzled by (s / 32) % 4, and of query row r, by (r / 2) % 4:
// the 8 rows of each ldmatrix phase and the 8 units of each quarter-warp's
// copy fall on all 32 banks.
__host__ __device__ constexpr int staged_doc(int s, int u) {
    return s * MMA_ROW + ((u ^ ((s >> 5) & 3)) << 4);
}
__host__ __device__ constexpr int staged_query(int r, int u) {
    return MMA_DOCS + r * MMA_ROW + ((u ^ ((r >> 1) & 3)) << 4);
}

// A lane's A-fragment address is the one of M-tile 0 plus a constant a
// tile: the slot bits of m and of r are apart, and the swizzle reads r's.
constexpr bool mma_rows_apart() {
    for (int m = 0; m < 16; ++m)
        for (int r = 0; r < 16; ++r)
            if (doc_slot(mma_doc(m, r)) != (doc_slot(mma_doc(m, 0)) | doc_slot(mma_doc(0, r)))
                || (doc_slot(mma_doc(m, 0)) & doc_slot(mma_doc(0, r))) != 0
                || (doc_slot(mma_doc(m, 0)) & 0x60) != 0)
                return false;
    return true;
}
static_assert(mma_rows_apart(), "an A-fragment address is a lane's base plus a tile's offset");

__device__ __forceinline__ unsigned shared_address(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage depth d0 .. d0 + MMA_DEPTH - 1 of docs t0 .. t0 + BN - 1 and of
// queries q0 .. q0 + BQ - 1 at shared address `stage`: cp.async.cg, 16
// bytes a copy, zeros past `end`, n_queries or dim (its src-size operand).
// Where D or a pointer is off 16-byte alignment (!vec), load_unit's scalar
// loads and a 16-byte shared store fill the same units. A thread's copy i
// is unit e % 4 of slot e / 4, e = tid + 128 i; the last is a query unit.
__device__ __forceinline__ void stage_chunk(unsigned stage, const __nv_bfloat16* docs,
                                            const __nv_bfloat16* queries, long long t0,
                                            long long end, int q0, int n_queries, int d0,
                                            int dim, bool vec, int tid) {
    constexpr int UNITS = MMA_ROW / 16;
    constexpr int DOC_COPIES = BN * UNITS / THREADS1;
    static_assert(BQ * UNITS == THREADS1, "one query unit a thread");
#pragma unroll
    for (int i = 0; i <= DOC_COPIES; ++i) {
        const bool doc = i < DOC_COPIES;
        const int e = doc ? tid + THREADS1 * i : tid;
        const int s = e / UNITS, u = e % UNITS;
        const __nv_bfloat16* src = doc ? docs : queries;
        const long long row = doc ? t0 + doc_slot(s) : (long long)q0 + s;
        const long long rows = doc ? end : (long long)n_queries;
        const int col = d0 + 8 * u;
        const unsigned dst = stage + (doc ? staged_doc(s, u) : staged_query(s, u));
        if (vec) {
            const bool live = row < rows && col < dim;
            const __nv_bfloat16* from = live ? src + row * dim + col : src;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(dst), "l"(from), "r"(live ? 16 : 0) : "memory");
        } else {
            const uint4 x = load_unit(src, row, rows, col, dim, false);
            asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                         :: "r"(dst), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w) : "memory");
        }
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned address) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(address) : "memory");
}

// c += a b: a 16 x 16 bf16 (rows: docs), b 16 x 8 bf16 (columns: queries),
// c 16 x 8 f32; each product is exact and summed in f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged chunk's product for warp w: its 8 queries (B, N = 8: query
// rows 8w .. 8w + 7, one ldmatrix.x4 for both k-steps) against the tile's
// docs (A, 16 M-tiles, one ldmatrix.x4 each a k-step; lanes 0-15 give the
// addresses of rows 0-15 at depth 16 ks, lanes 16-31 at 16 ks + 8). c[m]
// is M-tile m's C fragment: lane (g, t) holds rows g (c0, c1) and g + 8
// (c2, c3) of queries 2t and 2t + 1.
__device__ __forceinline__ void mma_chunk(float (&c)[16][4], unsigned stage, int warp,
                                          int lane) {
    unsigned b[4];
    ldmatrix_x4(b, stage + staged_query(8 * warp + (lane & 7), lane >> 3));
    // k-steps in a loop: unrolled, ptxas loads all 32 A fragments ahead
    // (128 registers beside the 64 sums) and spills
#pragma unroll 1
    for (int ks = 0; ks < 2; ++ks) {
        const unsigned b0 = ks ? b[2] : b[0], b1 = ks ? b[3] : b[1];
        const unsigned at = stage + staged_doc(doc_slot(mma_doc(0, lane & 15)),
                                               2 * ks + (lane >> 4));
#pragma unroll
        for (int m = 0; m < 16; ++m) {
            unsigned a[4];
            ldmatrix_x4(a, at + doc_slot(mma_doc(m, 0)) * MMA_ROW);
            mma_bf16(c[m], a, b0, b1);
        }
    }
}

// The C fragments to the selections' layout: acc[i][jj] = query 8 warp +
// i, doc 4 lane + jj % 4 + 128 (jj / 4). A quad holds the same 32 docs,
// each lane 2 of its 8 queries. Two exchanges, with lane ^ 1 and then
// lane ^ 2: a lane keeps the rows g + 8 (t % 2), then the M-tiles of parity
// t / 2, sends its partner the others and takes the partner's queries of
// what it keeps. 64 shuffles and 192 selects a lane; nothing is summed.
__device__ __forceinline__ void quad_transpose(const float (&c)[16][4], float (&acc)[8][8],
                                               int lane) {
    const bool odd = lane & 1, high = lane & 2;
    float w[4][16];  // queries 4 (t / 2) + q of rows g + 8 (t % 2), by M-tile
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int m = 0; m < 16; ++m) {
            const float got = __shfl_xor_sync(FULL, odd ? c[m][p] : c[m][2 + p], 1);
            w[p][m] = odd ? got : c[m][p];
            w[2 + p][m] = odd ? c[m][2 + p] : got;
        }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float got = __shfl_xor_sync(FULL, high ? w[q][2 * j] : w[q][2 * j + 1], 2);
            acc[q][j] = high ? got : w[q][2 * j];
            acc[4 + q][j] = high ? w[q][2 * j + 1] : got;
        }
}

// The Q >= 5 kernel's least blocks an SM: bf16 docs 3 under the narrow
// selection (168 registers) and 2 under the wide one. f32 docs ask for
// none (0): a bound of 1 block, though it caps nothing, moves ptxas's
// registers and schedule (155 -> 159 and 181 -> 213 registers).
template <typename T, bool WIDE>
constexpr int tiles_min_blocks() {
    return sizeof(T) == 2 ? (WIDE ? 2 : 3) : 0;
}

// WIDE (k > WIDE_K): each warp selects for its own 8 queries with
// __syncwarp alone (warp_select), pruned by a bar where bar_v is given
// (query q's pair at bar_v / bar_i + q * bar_stride: only pairs that rank
// at or before it are kept), split s reading docs [s split_len, s
// split_len + split_docs); else one thread a query insertion-sorts a
// queue of each half tile (see the note), split s reading split_len docs. f32 docs are summed on the CUDA
// cores (Stage, fmaf), bf16 docs on the tensor cores (MMA: stage_chunk,
// mma_chunk, quad_transpose); the selections read both alike.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS1, tiles_min_blocks<T, WIDE>())
score_topk_tiles(const T* __restrict__ docs, const T* __restrict__ queries, long long n,
                 int n_queries, int dim, int k, long long n_docs, long long split_len,
                 int vec, float* __restrict__ cand_v, int* __restrict__ cand_i,
                 const float* __restrict__ bar_v, const int* __restrict__ bar_i,
                 long long bar_stride, long long split_docs) {
    constexpr bool MMA = sizeof(T) == 2;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);      // [2][STAGE] staging
    // narrow selection
    float* queue_v = smem;                               // [BQ][HALF], over the staging
    int* queue_i = reinterpret_cast<int*>(smem + BQ * HALF);  // [BQ][HALF]
    float* top_v = smem + 2 * STAGE;                     // [BQ][k], sorted
    int* top_i = reinterpret_cast<int*>(top_v + BQ * k); // [BQ][k]
    int* queue_n = top_i + BQ * k;                       // [BQ]
    int* filled = queue_n + BQ;                          // [BQ]
    // wide selection: lists [BQ][list_stride(k)], skewed, sorted, padded
    // with (-inf, NO_INDEX); buffers [BQ][list_stride(TILE_QUEUE)],
    // skewed; each query's bar (value, index) and buffer count; a warp's
    // queue over staging buffer 1, which no warp reads or writes from a
    // tile's last __syncthreads to the next one
    const int ls = list_stride(k);
    constexpr int bs = list_stride(TILE_QUEUE);
    float* list_v = smem + 2 * STAGE;
    int* list_i = reinterpret_cast<int*>(list_v + BQ * ls);
    float* buf_v = reinterpret_cast<float*>(list_i + BQ * ls);
    int* buf_i = reinterpret_cast<int*>(buf_v + BQ * bs);
    float* thr_v = reinterpret_cast<float*>(buf_i + BQ * bs);
    int* thr_i = reinterpret_cast<int*>(thr_v + BQ);
    int* held = thr_i + BQ;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int q0 = blockIdx.x * BQ;
    const int split = blockIdx.y;
    const long long begin = (long long)split * split_len;
    const long long end = min(begin + (WIDE ? split_docs : split_len), n);
    const int n_chunks = MMA ? (dim + MMA_DEPTH - 1) / MMA_DEPTH : (dim + BK - 1) / BK;

    if constexpr (WIDE) {
        for (int e = lane; e < 8 * ls; e += 32) {
            list_v[8 * warp * ls + e] = -INFINITY;
            list_i[8 * warp * ls + e] = NO_INDEX;
        }
        if (lane < 8) {
            // at or before (v, x) is before (v, x + 1); no bar: the pad
            const int ql = 8 * warp + lane;
            float v = -INFINITY;
            int x = NO_INDEX;
            if (bar_v != nullptr && q0 + ql < n_queries) {
                v = bar_v[(long long)(q0 + ql) * bar_stride];
                x = bar_i[(long long)(q0 + ql) * bar_stride];
                x = x < NO_INDEX ? x + 1 : NO_INDEX;
            }
            thr_v[ql] = v;
            thr_i[ql] = x;
            held[ql] = 0;
        }
    } else if (tid < BQ) {
        queue_n[tid] = 0;
        filled[tid] = 0;
    }
    std::conditional_t<MMA, char, Stage<T>> st;
    const unsigned stages = shared_address(smem);  // MMA: two stages of MMA_STAGE bytes
    int mma_buf = 0;                               // MMA: the stage of the chunk in flight
    if constexpr (MMA) {
        stage_chunk(stages, docs, queries, begin, end, q0, n_queries, 0, dim, vec, tid);
        cp_async_commit();
    } else {
        st.load(docs, queries, begin, end, q0, n_queries, 0, dim, vec, warp, lane);
        st.store(smem, warp, lane);
        __syncthreads();
    }

    for (long long t0 = begin; t0 < end; t0 += BN) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

        if constexpr (MMA) {
            float c[16][4] = {};
            for (int ch = 0; ch < n_chunks; ++ch) {
                cp_async_wait_all();
                __syncthreads();  // chunk ch is in stage mma_buf; no warp reads the other
                const unsigned other = stages + (mma_buf ^ 1) * MMA_STAGE;
                if (ch + 1 < n_chunks)
                    stage_chunk(other, docs, queries, t0, end, q0, n_queries,
                                (ch + 1) * MMA_DEPTH, dim, vec, tid);
                else if (WIDE && t0 + BN < end)  // the next tile's first chunk
                    stage_chunk(other, docs, queries, t0 + BN, end, q0, n_queries, 0, dim,
                                vec, tid);
                cp_async_commit();
                mma_chunk(c, stages + mma_buf * MMA_STAGE, warp, lane);
                mma_buf ^= 1;
            }
            quad_transpose(c, acc, lane);
            __syncthreads();  // every warp has read the last chunk's stage, mma_buf ^ 1
        } else {
            int buf = 0;
            for (int c = 0; c < n_chunks; ++c) {
                // the next chunk, of this tile or the next one, into registers
                const bool more = c + 1 < n_chunks;
                if (more)
                    st.load(docs, queries, t0, end, q0, n_queries, (c + 1) * BK, dim, vec, warp,
                            lane);
                else if (t0 + BN < end)
                    st.load(docs, queries, t0 + BN, end, q0, n_queries, 0, dim, vec, warp, lane);

                const float* q_s = smem + buf * STAGE;
                const float* d_s = q_s + BK * BQ;
#pragma unroll
                for (int kk = 0; kk < BK; ++kk) {
                    const float4 a0 = *reinterpret_cast<const float4*>(q_s + kk * BQ + 8 * warp);
                    const float4 a1 =
                        *reinterpret_cast<const float4*>(q_s + kk * BQ + 8 * warp + 4);
                    const float4 b0 = *reinterpret_cast<const float4*>(d_s + kk * BS + 4 * lane);
                    const float4 b1 =
                        *reinterpret_cast<const float4*>(d_s + kk * BS + HALF + 4 * lane);
                    const float qv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                    const float dv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], dv[j], acc[i][j]);
                }
                if (more) st.store(smem + (buf ^ 1) * STAGE, warp, lane);
                __syncthreads();
                buf ^= 1;
            }
        }

        if constexpr (WIDE) {
            // buffer 0 is free now and the selection uses buffer 1 alone, so
            // the next tile's first chunk goes there first: its registers are
            // free during the selection. MMA: the queues take the last
            // chunk's stage while the next tile's first lands in the other
            if constexpr (!MMA)
                if (t0 + BN < end) st.store(smem, warp, lane);
            warp_select(acc, list_v + 8 * warp * ls, list_i + 8 * warp * ls, ls, k,
                        MMA ? smem + (mma_buf ^ 1) * (MMA_STAGE / 4) + warp * WARP_SCRATCH
                            : smem + STAGE + warp * WARP_SCRATCH,
                        buf_v + 8 * warp * bs, buf_i + 8 * warp * bs, held + 8 * warp,
                        thr_v + 8 * warp, thr_i + 8 * warp, t0, end, n_docs,
                        min(8, n_queries - q0 - 8 * warp), lane);
            if (t0 + BN < end) __syncthreads();
            continue;
        }

        // queue every score that beats its query's current k-th best, one
        // half tile at a time, then one thread per query inserts its queue
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int ql = 8 * warp + i;
                if (q0 + ql >= n_queries) continue;
                const bool full = filled[ql] == k;
                const float kth_v = full ? top_v[ql * k + k - 1] : 0.f;
                const int kth_i = full ? top_i[ql * k + k - 1] : 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const long long doc = t0 + HALF * h + 4 * lane + j;
                    if (doc >= end) continue;
                    const float s = doc < n_docs ? acc[i][4 * h + j] : MASKED;
                    if (!full || ranks_before(s, (int)doc, kth_v, kth_i)) {
                        const int p = atomicAdd(&queue_n[ql], 1);
                        queue_v[ql * HALF + p] = s;
                        queue_i[ql * HALF + p] = (int)doc;
                    }
                }
            }
            __syncthreads();
            if (tid < BQ) {
                float* tv = top_v + tid * k;
                int* ti = top_i + tid * k;
                int f = filled[tid];
                const int m = queue_n[tid];
                for (int c = 0; c < m; ++c) {
                    const float s = queue_v[tid * HALF + c];
                    const int idx = queue_i[tid * HALF + c];
                    if (f == k && !ranks_before(s, idx, tv[k - 1], ti[k - 1])) continue;
                    int p = f < k ? f : k - 1;
                    while (p > 0 && ranks_before(s, idx, tv[p - 1], ti[p - 1])) {
                        tv[p] = tv[p - 1];
                        ti[p] = ti[p - 1];
                        --p;
                    }
                    tv[p] = s;
                    ti[p] = idx;
                    if (f < k) ++f;
                }
                filled[tid] = f;
                queue_n[tid] = 0;
            }
            __syncthreads();
        }

        // the next tile's first chunk, loaded before the selection (MMA:
        // copied now, since the queues took both stages)
        if (t0 + BN < end) {
            if constexpr (MMA) {
                stage_chunk(stages + mma_buf * MMA_STAGE, docs, queries, t0 + BN, end, q0,
                            n_queries, 0, dim, vec, tid);
                cp_async_commit();
            } else {
                st.store(smem, warp, lane);
                __syncthreads();
            }
        }
    }

    if constexpr (WIDE) {  // each warp its own queries' lists, their buffers merged first
        for (int i = 0; i < 8 && q0 + 8 * warp + i < n_queries; ++i) {
            const int ql = 8 * warp + i;
            if (held[ql] > 0) {
                sort_queue<(TILE_QUEUE + 31) / 32>(buf_v + ql * bs, buf_i + ql * bs, held[ql],
                                                   lane, held[ql]);
                warp_merge(list_v + ql * ls, list_i + ql * ls, k, buf_v + ql * bs,
                           buf_i + ql * bs, held[ql], lane);
            }
            const long long o = ((long long)(q0 + ql) * gridDim.y + split) * k;
            for (int r = lane; r < k; r += 32) {
                cand_v[o + r] = list_v[ql * ls + skew(r)];
                cand_i[o + r] = list_i[ql * ls + skew(r)];
            }
        }
        return;
    }
    for (int e = tid; e < BQ * k; e += THREADS1) {
        const int ql = e / k, r = e % k;
        if (q0 + ql >= n_queries) continue;
        const long long o = ((long long)(q0 + ql) * gridDim.y + split) * k + r;
        const bool real = r < filled[ql];
        cand_v[o] = real ? top_v[e] : -INFINITY;
        cand_i[o] = real ? top_i[e] : NO_INDEX;
    }
}

// score_topk_stream_mma (bf16 docs, 2 <= Q <= 4; see the note): a warp
// steps over 32 docs at a time, each staged by its own cp.async ring.
constexpr int STREAM_MMA_STAGES = 4;    // stages of a warp's ring
constexpr int STREAM_MMA_DEPTH = 64;    // columns of a stage
constexpr int MMA_STEP = 32;            // docs a warp step: two M-tiles
constexpr int MMA_STEP_ROW = 2 * STREAM_MMA_DEPTH;  // bytes of a staged doc: 8 units
constexpr int MMA_SLOT = MMA_STEP * MMA_STEP_ROW;   // bytes of a stage
static_assert(STREAM_MMA_STAGES >= 2 && (STREAM_MMA_STAGES & (STREAM_MMA_STAGES - 1)) == 0,
              "a ring of a power of two of stages");
static_assert(MMA_STEP_ROW == 128, "a staged doc's 8 units sweep the 32 banks once");

// The doc of a step (0..31) that row r of M-tile m (0 or 1) multiplies.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of both tiles
// and keeps row g + 8 (t % 2) of tile t / 2: doc 4 g + t, its own lane.
__host__ __device__ constexpr int step_doc(int m, int r) {
    return 4 * (r & 7) + 2 * m + (r >> 3);
}

// Byte offset in a stage of 16-byte unit u (columns 8u .. 8u + 7 of the
// stage's 64) of step doc d: rows of 128 bytes, units XOR-swizzled by
// (d / 4) % 8, so that the 8 rows of an ldmatrix phase (docs 4 apart) and
// the 8 units of a quarter-warp's copy fall on all 32 banks.
__host__ __device__ constexpr int step_unit(int d, int u) {
    return d * MMA_STEP_ROW + ((u ^ ((d >> 2) & 7)) << 4);
}

// A lane's A-fragment address is the one of tile 0 plus 2 rows (256 bytes)
// for tile 1: the swizzle of its row is the same in both tiles.
constexpr bool step_tiles_apart() {
    for (int r = 0; r < 16; ++r)
        for (int u = 0; u < 8; ++u)
            if (step_unit(step_doc(1, r), u) != step_unit(step_doc(0, r), u) + 2 * MMA_STEP_ROW)
                return false;
    return true;
}
static_assert(step_tiles_apart(), "tile 1's A-fragment address is tile 0's plus 256 bytes");

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy columns col0 .. col0 + 63 of docs row0 .. row0 + 31 into the stage
// at shared address `slot`, with one warp: copy i of a lane is unit lane %
// 8 of doc lane / 8 + 4 i (swizzled by i), zeros past `end` or `dim`.
__device__ __forceinline__ void stage_step(unsigned slot, const __nv_bfloat16* docs,
                                           long long row0, long long end, int col0, int dim,
                                           int lane) {
    const int u = lane & 7, col = col0 + 8 * u;
#pragma unroll
    for (int i = 0; i < MMA_STEP / 4; ++i) {
        const int d = (lane >> 3) + 4 * i;
        const long long row = row0 + d;
        const bool live = row < end && col < dim;
        const __nv_bfloat16* from = live ? docs + row * dim + col : docs;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(slot + step_unit(d, u)), "l"(from), "r"(live ? 16 : 0) : "memory");
    }
}

// The queries' bf16 rows in shared memory: D rounded up to whole stages,
// plus 16 elements, so that rows lie 8 words apart on the banks.
__host__ __device__ constexpr int mma_query_stride(int dpad) { return dpad + 16; }

// The rings, the queries' rows, then the wide selection's lists and queues.
size_t stream_mma_smem(int n_queries, int dim, int k) {
    const int dpad = (dim + STREAM_MMA_DEPTH - 1) / STREAM_MMA_DEPTH * STREAM_MMA_DEPTH;
    return (size_t)STREAM_WARPS * STREAM_MMA_STAGES * MMA_SLOT
         + 2 * (size_t)n_queries * mma_query_stride(dpad) + stream_lists_smem(n_queries, k, true);
}

// score_topk_stream's wide selection at every k; the docs' rows, pointer
// and D are 16-byte aligned (the wrapper's route). One block an SM: its
// rings fill most of the SM's shared memory.
template <int NQ>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
score_topk_stream_mma(const __nv_bfloat16* __restrict__ docs,
                      const __nv_bfloat16* __restrict__ queries, long long n, int dim, int k,
                      long long n_docs, long long split_len, float* __restrict__ cand_v,
                      int* __restrict__ cand_i) {
    static_assert(NQ >= 2 && NQ <= 4, "Q = 1 stays on score_topk_stream");
    constexpr int QC = NQ == 2 ? 2 : 4;   // B's column n holds query n % QC (zeros past NQ)
    constexpr int STRIDE = STREAM_WARPS * MMA_STEP;  // docs a block step
    const int dpad = (dim + STREAM_MMA_DEPTH - 1) / STREAM_MMA_DEPTH * STREAM_MMA_DEPTH;
    const int chunks = dpad / STREAM_MMA_DEPTH;
    const int qstride = mma_query_stride(dpad);
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    // [warps][STAGES] stages, then the queries' rows [NQ][qstride] (bf16
    // bits), then lists [warps][NQ][ls] and queues [warps][NQ][qs], skewed
    unsigned short* q_s =
        reinterpret_cast<unsigned short*>(smem + STREAM_WARPS * STREAM_MMA_STAGES * MMA_SLOT);
    const int ls = list_stride(k);
    constexpr int qs = list_stride(STREAM_QUEUE);
    float* wide_v = reinterpret_cast<float*>(q_s + NQ * qstride);
    int* wide_i = reinterpret_cast<int*>(wide_v + STREAM_WARPS * NQ * ls);
    float* queue_v = reinterpret_cast<float*>(wide_i + STREAM_WARPS * NQ * ls);
    int* queue_i = reinterpret_cast<int*>(queue_v + STREAM_WARPS * NQ * qs);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x;
    const long long begin = (long long)split * split_len;
    const long long end = min(begin + split_len, n);

    const unsigned short* q_bits = reinterpret_cast<const unsigned short*>(queries);
    for (int e = tid; e < NQ * dpad; e += STREAM_THREADS) {
        const int qq = e / dpad, c = e - qq * dpad;
        q_s[qq * qstride + c] = c < dim ? q_bits[(long long)qq * dim + c] : 0;
    }
    __syncthreads();

    // B fragments: lane (g, t) holds query g % QC at depths 16 ks + 2t, + 1
    // (b0) and 16 ks + 8 + 2t, + 1 (b1): words 8 ks + t and 8 ks + 4 + t of
    // its row; those of the first two stages (128 columns) in registers
    const int qn = (lane >> 2) & (QC - 1);
    const bool q_live = qn < NQ;
    const unsigned* q_row = reinterpret_cast<const unsigned*>(q_s + (q_live ? qn : 0) * qstride)
                            + (lane & 3);
    unsigned b_reg[2][4][2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                b_reg[c][ks][h] = q_live && c < chunks ? q_row[32 * c + 8 * ks + 4 * h] : 0u;

    // A fragments: lanes 0-15 give rows 0-15 at depth 16 ks, lanes 16-31 at
    // 16 ks + 8 (ldmatrix.x4: rows g, g + 8 by depth 2t and 2t + 8)
    unsigned a_at[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
        a_at[ks] = step_unit(step_doc(0, lane & 15), 2 * ks + (lane >> 4));

    // warp w's steps: docs first + s STRIDE .. + 31
    const long long first = begin + (long long)warp * MMA_STEP;
    const int steps = first < end ? (int)((end - first + STRIDE - 1) / STRIDE) : 0;
    const unsigned ring = shared_address(smem) + warp * STREAM_MMA_STAGES * MMA_SLOT;
    int put_step = 0, put_chunk = 0, put = 0;  // the next stage to copy, and its ring place
    auto copy_next = [&]() {
        if (put_step < steps) {
            stage_step(ring + (put & (STREAM_MMA_STAGES - 1)) * MMA_SLOT, docs,
                       first + (long long)put_step * STRIDE, end, put_chunk * STREAM_MMA_DEPTH,
                       dim, lane);
            if (++put_chunk == chunks) {
                put_chunk = 0;
                ++put_step;
            }
        }
        ++put;
        cp_async_commit();  // one group a stage, empty past the last
    };
#pragma unroll
    for (int i = 0; i + 1 < STREAM_MMA_STAGES; ++i) copy_next();

    int filled[NQ], queued[NQ];
    float kth_v[NQ];
    int kth_i[NQ];
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
        filled[qq] = 0;
        queued[qq] = 0;
        kth_v[qq] = -INFINITY;  // the pad, while the list fills
        kth_i[qq] = NO_INDEX;
    }
    float* my_wv = wide_v + warp * NQ * ls;
    int* my_wi = wide_i + warp * NQ * ls;
    float* my_qv = queue_v + warp * NQ * qs;
    int* my_qi = queue_i + warp * NQ * qs;
    const unsigned below = (1u << lane) - 1;
    const bool odd = lane & 1, high = lane & 2;

    int got = 0;  // stages multiplied
    for (int s = 0; s < steps; ++s) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ch = 0; ch < chunks; ++ch) {
            cp_async_wait<STREAM_MMA_STAGES - 2>();  // this stage has landed
            __syncwarp();                            // ... for every lane; the last is read
            copy_next();                             // into the stage read last
            const unsigned slot = ring + (got & (STREAM_MMA_STAGES - 1)) * MMA_SLOT;
            ++got;
            unsigned b[4][2];
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    b[ks][h] = ch >= 2 ? (q_live ? q_row[32 * ch + 8 * ks + 4 * h] : 0u)
                                       : ch ? b_reg[1][ks][h] : b_reg[0][ks][h];
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
                unsigned a[4];
                ldmatrix_x4(a, slot + a_at[ks]);
                mma_bf16(c0, a, b[ks][0], b[ks][1]);
                ldmatrix_x4(a, slot + a_at[ks] + 2 * MMA_STEP_ROW);
                mma_bf16(c1, a, b[ks][0], b[ks][1]);
            }
        }

        // the lane's doc, 4 g + t: row g + 8 (t % 2) of tile t / 2
        float own[4], v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) own[j] = high ? c1[j] : c0[j];
        if constexpr (QC == 2) {  // every lane holds queries 0 and 1
            v[0] = odd ? own[2] : own[0];
            v[1] = odd ? own[3] : own[1];
        } else {  // even lanes hold queries 0, 1 and odd lanes 2, 3: swap halves
            const float r0 = __shfl_xor_sync(FULL, odd ? own[0] : own[2], 1);
            const float r1 = __shfl_xor_sync(FULL, odd ? own[1] : own[3], 1);
            const float k0 = odd ? own[2] : own[0], k1 = odd ? own[3] : own[1];
            v[0] = odd ? r0 : k0;
            v[1] = odd ? r1 : k1;
            v[2] = odd ? k0 : r0;
            v[3] = odd ? k1 : r1;
        }

        // the prune: a doc that beats the warp's k-th best (the pad while the
        // list fills) takes, in lane order, the list's next free place or
        // else the queue's; sorts and merges wait for settle
        const long long doc = first + (long long)s * STRIDE + lane;
        const bool live = doc < end;
        unsigned sorting = 0, merging = 0;
#pragma unroll
        for (int qq = 0; qq < NQ; ++qq) {
            const float score = doc < n_docs ? v[qq] : MASKED;
            const bool pass = live && ranks_before(score, (int)doc, kth_v[qq], kth_i[qq]);
            const unsigned m = __ballot_sync(FULL, pass);
            const int at = __popc(m & below), all = __popc(m);
            const int take = min(all, k - filled[qq]);
            if (pass) {
                const bool fill = at < take;
                const int e = skew(fill ? filled[qq] + at : queued[qq] + at - take);
                (fill ? my_wv + qq * ls : my_qv + qq * qs)[e] = score;
                (fill ? my_wi + qq * ls : my_qi + qq * qs)[e] = (int)doc;
            }
            filled[qq] += take;
            queued[qq] += all - take;
            if (take > 0 && filled[qq] == k) sorting |= 1u << qq;
            if (queued[qq] > STREAM_QUEUE - MMA_STEP) merging |= 1u << qq;  // room for a step
        }
        if (sorting | merging) {
            __syncwarp();
            settle<NQ>(sorting, merging, my_wv, my_wi, my_qv, my_qi, ls, k, filled, queued, kth_v,
                       kth_i, lane);
        }
    }
    cp_async_wait<0>();  // no copy outlives the block (the groups past the last are empty)

    // a list that never filled is sorted now, a queue left over merged
    unsigned sorting = 0, merging = 0;
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
        if (filled[qq] < k) sorting |= 1u << qq;
        else if (queued[qq] > 0) merging |= 1u << qq;
    }
    __syncwarp();
    settle<NQ>(sorting, merging, my_wv, my_wi, my_qv, my_qi, ls, k, filled, queued, kth_v, kth_i,
               lane);
    __syncthreads();
    stream_tree<NQ>(wide_v, wide_i, ls, k, cand_v + (long long)split * k,
                    cand_i + (long long)split * k, (long long)gridDim.x * k, tid);
}

// score_topk_tiles_ring (f32 docs, Q >= 5, k <= WIDE_K; see the note): the
// block's warps multiply the stages of one ring (TMA copies, or cp.async
// where TMA cannot take the rows) and each selects for its own queries.
constexpr int RING_WARPS = 8;          // warps a block
constexpr int RING_THREADS = 32 * RING_WARPS;
constexpr int RING_STAGES = 4;         // stages of the block's ring
constexpr int RING_DEPTH = 16;         // columns of a stage: 4 units of 16 bytes a row
constexpr int RING_LANE_DOCS = 4;      // docs a lane multiplies (x 8 queries) ...
constexpr int RING_LONG_SPLIT = 32768; // ... above RING_SMALL_Q on splits of this many docs or
constexpr int RING_LONG_LANE_DOCS = 6; // more: this many
constexpr int RING_SMALL_Q = 32;       // Q up to this: 4 warps of queries x 2 of docs, else 8 x 1
constexpr int RING_LIST = 16;          // places of a query's list in a warp (k <= WIDE_K)
constexpr int RING_MIN_BLOCKS = 2;     // the launch bound's blocks an SM: 128 registers a thread
static_assert(RING_STAGES >= 2, "a stage is copied while another is multiplied");
static_assert(RING_DEPTH == BK, "D is padded to score_topk_tiles' chunks: the same fmaf chains");
static_assert(RING_LIST > WIDE_K && RING_LIST <= 32, "a list lies across a warp's lanes");

// The block of QW warps of queries (8 queries each) x DW warps of docs (32
// ND docs each: ND a lane): BQ queries against tiles of BN docs, STAGE
// floats a stage (the tile's doc rows, then the block's query rows,
// RING_DEPTH each).
template <int QW, int ND>
struct Ring {
    static constexpr int DW = RING_WARPS / QW;
    static constexpr int WARP_DOCS = 32 * ND;
    static constexpr int BQ = 8 * QW;
    static constexpr int BN = WARP_DOCS * DW;
    static constexpr int STAGE = (BN + BQ) * RING_DEPTH;
    static_assert(QW * DW == RING_WARPS, "the warps tile the block");
    static_assert(ND >= 1 && ND <= 8, "a lane's docs are rows lane + 32 jj, bits of a byte");
};

// Float offset in a stage of unit u (columns 4u .. 4u + 3) of doc row r:
// rows of 64 bytes, units XOR-swizzled by (r / 2) % 4 (TMA's 64-byte
// swizzle on a 1,024-byte aligned ring). A lane reads rows lane + 32 jj, so
// the 8 rows of a quarter-warp's 16-byte reads, and the 2 rows x 4 units of
// 8 threads' copies, fall on all 32 banks.
__host__ __device__ constexpr int ring_unit(int r, int u) {
    return r * RING_DEPTH + 4 * (u ^ ((r >> 1) & 3));
}

constexpr bool ring_rows_apart() {
    for (int u = 0; u < RING_DEPTH / 4; ++u)
        for (int l0 = 0; l0 < 32; l0 += 8) {
            unsigned groups = 0;
            for (int l = l0; l < l0 + 8; ++l) {
                groups |= 1u << (ring_unit(l, u) / 4 % 8);
                if (ring_unit(l, u) != (ring_unit(l, 0) ^ 4 * u)) return false;
            }
            if (groups != 0xffu) return false;
            for (int jj = 0; jj < 8; ++jj)
                if (ring_unit(l0 + 32 * jj, u) != ring_unit(l0, u) + 32 * jj * RING_DEPTH)
                    return false;
        }
    return true;
}
static_assert(ring_rows_apart(), "a quarter-warp's reads meet all 32 banks; unit u of a row is its "
              "unit 0 XOR 4u; doc jj is 32 jj rows on");

// The ring's mbarriers (shared addresses) and its TMA copies. A wait spins
// on try_wait until the barrier's phase of that parity has completed.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    asm volatile("{\n.reg .pred done;\nRING_WAIT:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "@!done bra RING_WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One arrival that also expects `bytes` of TMA copies to land.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// An arrival when this thread's cp.async copies so far have landed (counted
// in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// The box of `map` at column x, row y into shared address dst (TMA), its
// bytes counted on barrier bar; zeros where the box leaves the matrix.
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map, int x, int y,
                                        unsigned bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(dst), "l"(map), "r"(x), "r"(y), "r"(bar) : "memory");
}

// Copy 16 bytes from `src` to shared address dst by cp.async as four 4-byte
// copies, element j where `live` and j < cols, else zeros (src-size 0 reads
// nothing; `base` stands in): the ring's copies where TMA cannot take the
// matrix (D % 4 != 0, or a pointer off 16-byte alignment).
__device__ __forceinline__ void ring_copy4(unsigned dst, const float* src, const float* base,
                                           bool live, int cols) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const bool on = live && j < cols;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst + 4 * j), "l"(on ? src + j : base), "r"(on ? 4 : 0) : "memory");
    }
}

// One stage's product for a warp: acc[i][jj] (query i, doc jj = row lane +
// 32 jj of d_rows) gains the stage's RING_DEPTH columns, one fmaf a column
// in ascending order; d_base is ring_unit(lane, 0). For each unit of 4
// columns a lane reads its 8 queries' 16 bytes (one address across the
// warp: broadcasts) and its docs' 16 bytes, the next unit's docs ahead of
// this unit's FMAs; then column by column, doc by doc, the 8 queries:
// consecutive FMAs share the doc's value (ptxas reuses its register) and a
// sum's next FMA comes 8 ND on.
template <int ND>
__device__ __forceinline__ void ring_product(float (&acc)[8][ND], const float* d_rows,
                                             const float* q_rows, int d_base) {
    constexpr int UNITS = RING_DEPTH / 4;
    auto doc = [&](int u, int jj) {
        return *reinterpret_cast<const float4*>(d_rows + (d_base ^ 4 * u) + 32 * jj * RING_DEPTH);
    };  // query rows are swizzled as doc rows: the warp's first is a multiple of 8
    float4 d[ND];
#pragma unroll
    for (int jj = 0; jj < ND; ++jj) d[jj] = doc(0, jj);
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
        float4 q[8], next[ND];
#pragma unroll
        for (int i = 0; i < 8; ++i)
            q[i] = *reinterpret_cast<const float4*>(q_rows + ring_unit(i, u));
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
            if (u + 1 < UNITS) next[jj] = doc(u + 1, jj);
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][jj] = fmaf(q[i].x, d[jj].x, acc[i][jj]);
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][jj] = fmaf(q[i].y, d[jj].y, acc[i][jj]);
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][jj] = fmaf(q[i].z, d[jj].z, acc[i][jj]);
#pragma unroll
        for (int jj = 0; jj < ND; ++jj)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][jj] = fmaf(q[i].w, d[jj].w, acc[i][jj]);
        if (u + 1 < UNITS)
#pragma unroll
            for (int jj = 0; jj < ND; ++jj) d[jj] = next[jj];
    }
}

// Insert (sv, sx) into a list held across a warp's lanes (lane e < k holds
// pair e, best first): a ballot counts the pairs that rank before it, and
// the lanes from there on take their lower neighbour's pair. A pair that
// ranks after pair k - 1 changes no lane below k.
__device__ __forceinline__ void ring_insert(float& v, int& x, float sv, int sx, int k, int lane) {
    const int p = __popc(__ballot_sync(FULL, lane < k && ranks_before(v, x, sv, sx)));
    const float up_v = __shfl_up_sync(FULL, v, 1);
    const int up_x = __shfl_up_sync(FULL, x, 1);
    if (lane == p) {
        v = sv;
        x = sx;
    } else if (lane > p) {
        v = up_v;
        x = up_x;
    }
}

// The k best of a list held across a warp's lanes (lane e < k: pair e) and
// the survivors (bit jj of `mine`: score s[jj] of doc doc0 + 32 jj, the
// lane's own), into the same lanes: k rounds, each a lane's best candidate
// left, the warp's best of those (the largest score by a butterfly of
// fmaxf; among the lanes that hold it, the lowest index, by a second
// butterfly only where several do: -0 ties with +0 as in ranks_before),
// kept by lane r with the bits of the lane that held it, and dropped there.
// Pads (-inf, NO_INDEX) fill a round with no candidate left.
template <int ND>
__device__ __forceinline__ void ring_rounds(float& v, int& x, const float (&s)[ND],
                                            unsigned mine, int doc0, int k, int lane) {
    bool own = lane < k;  // the lane's list pair is still a candidate
    float out_v = -INFINITY;
    int out_x = NO_INDEX;
    for (int r = 0; r < k; ++r) {
        float bv = own ? v : -INFINITY;
        int bx = own ? x : NO_INDEX, bj = -1;
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) {
            if (((mine >> jj) & 1u) && ranks_before(s[jj], doc0 + 32 * jj, bv, bx)) {
                bv = s[jj];
                bx = doc0 + 32 * jj;
                bj = jj;
            }
        }
        float top = bv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) top = fmaxf(top, __shfl_xor_sync(FULL, top, off));
        const bool at_top = bv == top;
        const unsigned tops = __ballot_sync(FULL, at_top);
        int wx = at_top ? bx : NO_INDEX;
        if (tops & (tops - 1)) {  // several lanes hold the largest score: the lowest index
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) wx = min(wx, __shfl_xor_sync(FULL, wx, off));
        } else {
            wx = __shfl_sync(FULL, wx, __ffs(tops) - 1);
        }
        const bool won = at_top && bx == wx;  // this lane's candidate
        const float wv = __shfl_sync(FULL, bv, __ffs(__ballot_sync(FULL, won)) - 1);
        if (lane == r) {
            out_v = wv;
            out_x = wx;
        }
        if (won) {
            if (bj < 0) own = false;
            else mine &= ~(1u << bj);
        }
    }
    v = out_v;
    x = out_x;
}

// One tile's selection for a warp's nq live queries (8 at most): query i's
// list of k pairs at lv / lx + RING_LIST i, best first and padded with
// (-inf, NO_INDEX), so that its pair k - 1 is the bar a score must beat
// (every score beats the pad). acc[i][jj] is query i's score of doc t0 + 32
// jj + lane. A query goes on only where some lane's largest score (or
// MASKED) reaches the bar's value: no other score can beat it. Then each
// lane votes its scores (rows past n_docs at MASKED, docs past `end` never).
// Up to 2k survivors are inserted in doc order into the list, read into
// lanes 0 .. k - 1 (ring_insert); more (a split's first tile, where every
// doc beats the pad) are merged after the other queries by k rounds of the
// warp's best among the list's pairs and the survivors (ring_rounds), where
// the inserts would take one dependent round each. __syncwarp alone: no
// other warp reads these lists before the split ends. Doc indices are ints:
// N < 2^31.
template <int ND>
__device__ __forceinline__ void ring_select(const float (&acc)[8][ND], float* lv, int* lx, int k,
                                            int t0, int end, int n_docs, int nq, int lane) {
    unsigned flood = 0;  // bit i: query i has more than 2k survivors, the same in every lane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float top = MASKED;
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) top = fmaxf(top, acc[i][jj]);
        const float kth_v = lv[i * RING_LIST + k - 1];
        if (!__any_sync(FULL, top >= kth_v) || i >= nq) continue;
        const int kth_i = lx[i * RING_LIST + k - 1];
        unsigned mine = 0;  // bit jj: the lane's doc jj survives
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) {
            const int doc = t0 + 32 * jj + lane;
            const float s = doc < n_docs ? acc[i][jj] : MASKED;
            mine |= (unsigned)(doc < end && ranks_before(s, doc, kth_v, kth_i)) << jj;
        }
        if (__reduce_add_sync(FULL, __popc(mine)) > 2u * k) {
            flood |= 1u << i;
            continue;
        }
        float v = lv[i * RING_LIST + lane % RING_LIST];  // lanes from k on: never read
        int x = lx[i * RING_LIST + lane % RING_LIST];
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) {
            const float s = t0 + 32 * jj + lane < n_docs ? acc[i][jj] : MASKED;
            unsigned b = __ballot_sync(FULL, (mine >> jj) & 1u);
            while (b) {
                const int src = __ffs(b) - 1;
                b &= b - 1;
                ring_insert(v, x, __shfl_sync(FULL, s, src), t0 + 32 * jj + src, k, lane);
            }
        }
        if (lane < k) {
            lv[i * RING_LIST + lane] = v;
            lx[i * RING_LIST + lane] = x;
        }
        __syncwarp();
    }
    while (flood) {
        const int i = __ffs(flood) - 1;
        flood &= flood - 1;
        const float kth_v = lv[i * RING_LIST + k - 1];
        const int kth_i = lx[i * RING_LIST + k - 1];
        float v = lv[i * RING_LIST + lane % RING_LIST];
        int x = lx[i * RING_LIST + lane % RING_LIST];
        float s[ND];  // acc[i], by selects: i is not known at compile time here
        unsigned mine = 0;
#pragma unroll
        for (int jj = 0; jj < ND; ++jj) {
            s[jj] = acc[0][jj];
#pragma unroll
            for (int ii = 1; ii < 8; ++ii) s[jj] = i == ii ? acc[ii][jj] : s[jj];
            const int doc = t0 + 32 * jj + lane;
            if (doc >= n_docs) s[jj] = MASKED;
            mine |= (unsigned)(doc < end && ranks_before(s[jj], doc, kth_v, kth_i)) << jj;
        }
        ring_rounds(v, x, s, mine, t0 + lane, k, lane);
        if (lane < k) {
            lv[i * RING_LIST + lane] = v;
            lx[i * RING_LIST + lane] = x;
        }
        __syncwarp();
    }
}

// The bytes of a score_topk_tiles_ring block: room to align the ring to
// RING_ALIGN (the 64-byte swizzle repeats every 512 bytes and is read off
// the address), the ring, every warp's 8 lists of values and indices, then
// a full mbarrier (8 bytes) and a count of readers (4) a stage.
constexpr int RING_ALIGN = 1024;
template <int QW, int ND>
constexpr size_t ring_smem_q() {
    return RING_ALIGN + sizeof(float) * ((size_t)RING_STAGES * Ring<QW, ND>::STAGE
                                         + 2 * RING_WARPS * 8 * RING_LIST)
         + 12 * RING_STAGES;
}

// Split s reads docs [s split_len, (s + 1) split_len) cut at n; the block
// takes queries BQ blockIdx.x on. Warp (qw, dw) = (warp % QW, warp / QW)
// multiplies queries 8 qw .. 8 qw + 7 against docs WARP_DOCS dw on of each
// tile and keeps its own lists of them; at the split's end warp (qw, 0)
// inserts the other doc warps' pairs into its lists and writes them to
// cand_v / cand_i. Stage g lands in slot g % RING_STAGES and completes the
// slot's full barrier; a warp waits for that, multiplies, and counts itself
// among the slot's readers. Where `vec` the warp that reads it last copies
// stage g + RING_STAGES into it by TMA (doc_map, query_map: boxes of
// RING_DEPTH columns, 64-byte swizzle), so no warp waits for another but
// when it runs RING_STAGES stages ahead of the slowest (a single thread
// that copies for all, waiting for each slot to empty, was slower: 2.53 ms
// against 2.18 at Q=256). Else (4-byte cp.async copies) every thread copies
// after a block barrier. The plan cuts splits into tiles of the block of
// RING_LANE_DOCS docs a lane, so a split's last tile of a wider block may be
// ragged: its docs past `len` are never voted.
template <int QW, int ND>
__global__ void __launch_bounds__(RING_THREADS, RING_MIN_BLOCKS)
score_topk_tiles_ring(const float* __restrict__ docs, const float* __restrict__ queries,
                      long long n, int n_queries, int dim, int k, long long n_docs,
                      long long split_len, int vec, float* __restrict__ cand_v,
                      int* __restrict__ cand_i, const __grid_constant__ CUtensorMap doc_map,
                      const __grid_constant__ CUtensorMap query_map) {
    using R = Ring<QW, ND>;
    constexpr int TMA_ROWS = R::BN < 256 ? R::BN : 256;  // a TMA box's rows: 256 at most
    static_assert(R::BN % TMA_ROWS == 0 && R::BQ <= 256, "whole boxes a stage");
    extern __shared__ float4 smem4[];
    const unsigned raw = shared_address(smem4);
    float* ring = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4)
                                           + ((RING_ALIGN - raw % RING_ALIGN) % RING_ALIGN));
    float* list_v = ring + RING_STAGES * R::STAGE;  // [RING_WARPS][8][RING_LIST]
    int* list_i = reinterpret_cast<int*>(list_v + RING_WARPS * 8 * RING_LIST);
    unsigned long long* full = reinterpret_cast<unsigned long long*>(
        list_i + RING_WARPS * 8 * RING_LIST);                   // [RING_STAGES] mbarriers
    unsigned* readers = reinterpret_cast<unsigned*>(full + RING_STAGES);  // [RING_STAGES]
    const unsigned ring_at = shared_address(ring), full_at = shared_address(full);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int qw = warp % QW, dw = warp / QW;
    const int q0 = blockIdx.x * R::BQ;
    const int split = blockIdx.y;
    const long long begin = (long long)split * split_len;
    const int len = (int)(min(begin + split_len, n) - begin);  // the split's docs; N < 2^31
    const int first = (int)begin;                                // the split's first doc
    const int chunks = (dim + RING_DEPTH - 1) / RING_DEPTH;
    const int stages = (len + R::BN - 1) / R::BN * chunks;
    const int nq = min(8, n_queries - q0 - 8 * qw);  // the warp's live queries; none at <= 0

    float* my_v = list_v + warp * 8 * RING_LIST;
    int* my_i = list_i + warp * 8 * RING_LIST;
    for (int e = lane; e < 8 * RING_LIST; e += 32) {
        my_v[e] = -INFINITY;
        my_i[e] = NO_INDEX;
    }
    if (tid == 0) {
        for (int s = 0; s < RING_STAGES; ++s) {
            mbar_init(full_at + 8 * s, vec ? 1 : RING_THREADS);
            readers[s] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Without TMA a thread copies unit tid % UNITS of doc rows tid / UNITS +
    // APART i of every stage, and of query row tid / UNITS where the block
    // has one, 4 bytes at a time (its places and sources worked out at each
    // copy: the TMA path keeps no registers for them).
    constexpr int UNITS = RING_DEPTH / 4, APART = RING_THREADS / UNITS;
    static_assert(R::BN % APART == 0 && APART % 8 == 0,
                  "whole doc copies a thread, APART rows apart in the swizzle's period");
    // stage p: columns RING_DEPTH (p % chunks) on of the tile at row BN (p /
    // chunks), into slot p % RING_STAGES: by TMA from one thread, or by
    // cp.async from every thread
    auto copy_stage = [&](int p) {
        const int slot = p % RING_STAGES, tile_row = p / chunks * R::BN;
        const int d0 = (p - tile_row / R::BN * chunks) * RING_DEPTH;
        const unsigned at = ring_at + slot * R::STAGE * 4, bar = full_at + 8 * slot;
        if (vec) {
            mbar_expect(bar, R::STAGE * 4);
#pragma unroll
            for (int b = 0; b < R::BN / TMA_ROWS; ++b)
                tma_box(at + b * TMA_ROWS * RING_DEPTH * 4, &doc_map, d0,
                        first + tile_row + b * TMA_ROWS, bar);
            tma_box(at + R::BN * RING_DEPTH * 4, &query_map, d0, q0, bar);
            return;
        }
        const int my_row = tid / UNITS, my_unit = tid % UNITS;
        const int col = d0 + 4 * my_unit, cols = dim - col;
        const int rows = len - tile_row - my_row;  // rows this thread's copies may read
        const float* src = docs + (begin + tile_row + my_row) * dim + col;
        const unsigned doc_at = at + 4 * ring_unit(my_row, my_unit);
#pragma unroll
        for (int i = 0; i < R::BN / APART; ++i)  // copy i: APART i rows on
            ring_copy4(doc_at + i * APART * RING_DEPTH * 4, src + (long long)i * APART * dim, docs,
                       APART * i < rows, cols);
        if (my_row < R::BQ)
            ring_copy4(at + 4 * ring_unit(R::BN + my_row, my_unit),
                       queries + ((long long)q0 + my_row) * dim + col, queries,
                       q0 + my_row < n_queries, cols);
        cp_async_arrive(bar);
    };
    if (!vec || tid == 0)
        for (int p = 0; p < min(stages, RING_STAGES); ++p) copy_stage(p);

    const float* d_rows = ring + R::WARP_DOCS * dw * RING_DEPTH;
    const float* q_rows = ring + (R::BN + 8 * qw) * RING_DEPTH;
    const int d_base = ring_unit(lane, 0);  // the lane's first doc row
    const int live_docs = (int)max(0LL, min(n_docs - begin, (long long)len));  // unmasked
    int got = 0;  // stages multiplied
    for (int t = 0; t < len; t += R::BN) {
        float acc[8][ND];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
        for (int ch = 0; ch < chunks; ++ch) {
            const int slot = got % RING_STAGES;
            mbar_wait(full_at + 8 * slot, (got / RING_STAGES) & 1);  // the stage has landed
            if (nq > 0)
                ring_product(acc, d_rows + slot * R::STAGE, q_rows + slot * R::STAGE, d_base);
            // the slot's last reader copies stage got + RING_STAGES into it
            if (vec) {
                __syncwarp();
                if (lane == 0) {
                    __threadfence_block();
                    if (atomicAdd(&readers[slot], 1u) % RING_WARPS == RING_WARPS - 1
                        && got + RING_STAGES < stages) {
                        __threadfence_block();
                        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                        copy_stage(got + RING_STAGES);
                    }
                }
                __syncwarp();
            } else if (got + RING_STAGES < stages) {
                __syncthreads();  // every warp has read the slot
                copy_stage(got + RING_STAGES);
            }
            ++got;
        }
        if (nq > 0)
            ring_select(acc, my_v, my_i, k, first + t + R::WARP_DOCS * dw, first + len,
                        first + live_docs, nq, lane);
    }
    cp_async_wait<0>();  // no copy outlives the block

    if constexpr (R::DW > 1) {
        __syncthreads();  // the doc warps' lists are final
        if (dw > 0) return;
    }
    for (int i = 0; i < nq; ++i) {
        float v = my_v[i * RING_LIST + lane % RING_LIST];
        int x = my_i[i * RING_LIST + lane % RING_LIST];
#pragma unroll
        for (int w = 1; w < R::DW; ++w) {  // the same queries' pairs from the other doc warps
            const int other = ((qw + QW * w) * 8 + i) * RING_LIST;
            for (int e = 0; e < k; ++e) ring_insert(v, x, list_v[other + e], list_i[other + e], k,
                                                    lane);
        }
        if (lane < k) {
            const long long o = ((long long)(q0 + 8 * qw + i) * gridDim.y + split) * k + lane;
            cand_v[o] = v;
            cand_i[o] = x;
        }
    }
}

// Words of a shared plane of n pairs' values or indices, padding included,
// rounded up to whole 16-byte units.
__host__ __device__ constexpr int plane(int n) { return (n + (n + 31) / 32 + 3) / 4 * 4; }

// Dynamic shared memory of a merge block over `lists` lists of k pairs: the
// lists, then room for the ceil(lists / 2) lists of the first round.
size_t merge_smem(int lists, int k) {
    return 2 * sizeof(float) * (size_t)(plane(lists * k) + plane((lists + 1) / 2 * k));
}

// One block merges `lists` lists of k (value, index) pairs, each sorted by
// ranks_before, into their k best in that order. List j is at
// src_v / src_i + j * stride * k; the result goes to dst_v / dst_i, which
// may be list 0 itself (every global read ends before the first write).
// Pairs are unique but for the padding (-inf, NO_INDEX), so the k best are
// one answer, whatever the tree's shape.
__device__ __forceinline__ void merge_lists(const float* src_v, const int* src_i, int lists,
                                            int stride, int k, float* dst_v, int* dst_i) {
    extern __shared__ float4 smem4[];
    const int cap_x = plane(lists * k), cap_y = plane((lists + 1) / 2 * k);
    float* sv = reinterpret_cast<float*>(smem4);   // [lists][k] values
    int* si = reinterpret_cast<int*>(sv + cap_x);  // [lists][k] indices
    float* dv = reinterpret_cast<float*>(si + cap_x);  // [ceil(lists / 2)][k]
    int* di = reinterpret_cast<int*>(dv + cap_y);
    const int tid = threadIdx.x;

    // The lists are runs of contiguous pairs: one run of lists * k at
    // stride 1, else one run a list. 16-byte loads where every run starts
    // 16-byte aligned and holds whole units, else one pair a load.
    const int run = stride == 1 ? lists * k : k, runs = stride == 1 ? 1 : lists;
    const bool vec = run % 4 == 0 && (runs == 1 || (stride * k) % 4 == 0)
                     && reinterpret_cast<uintptr_t>(src_v) % 16 == 0
                     && reinterpret_cast<uintptr_t>(src_i) % 16 == 0;
    const int width = vec ? 4 : 1, per_run = run / width;
    for (int u = tid; u < runs * per_run; u += MERGE_THREADS) {
        const int r = u / per_run;
        const long long g = (long long)r * stride * k + (long long)(u - r * per_run) * width;
        const int e = skew(u * width);  // a unit never crosses a padding word
        if (vec) {
            const float4 v = *reinterpret_cast<const float4*>(src_v + g);
            const int4 x = *reinterpret_cast<const int4*>(src_i + g);
            sv[e] = v.x; sv[e + 1] = v.y; sv[e + 2] = v.z; sv[e + 3] = v.w;
            si[e] = x.x; si[e + 1] = x.y; si[e + 2] = x.z; si[e + 3] = x.w;
        } else {
            sv[e] = src_v[g];
            si[e] = src_i[g];
        }
    }
    __syncthreads();

    // log2(lists) rounds: round by round, lists 2p and 2p+1 merge into
    // list p of the other buffer, keeping the first k; an odd last list
    // passes through. A merge's k outputs are cut into 2^shift stretches,
    // as many as the threads allow (at most k); a thread takes one, finds
    // where it starts on the merge path by a binary search along the
    // diagonal, then merges it in order; ties go to the left list.
    for (int n = lists; n > 1; n = (n + 1) / 2) {
        const int outs = (n + 1) / 2;
        int shift = 0;
        while ((2 << shift) <= k && (outs << (shift + 1)) <= MERGE_THREADS) ++shift;
        const int chunk = ((k - 1) >> shift) + 1;
        for (int item = tid; item < (outs << shift); item += MERGE_THREADS) {
            const int p = item >> shift;
            const int d0 = (item & ((1 << shift) - 1)) * chunk;
            if (d0 >= k) continue;
            const int d1 = min(d0 + chunk, k);
            const int a0 = 2 * p * k, b0 = a0 + k, o0 = p * k;  // pair indices, unskewed
            if (2 * p + 1 == n) {
                for (int d = d0; d < d1; ++d) {
                    dv[skew(o0 + d)] = sv[skew(a0 + d)];
                    di[skew(o0 + d)] = si[skew(a0 + d)];
                }
                continue;
            }
            // i = how many of the first d0 outputs come from a: a[mid] is
            // among them unless b[d0 - 1 - mid] ranks strictly before it
            int lo = 0, hi = d0;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                const int ea = skew(a0 + mid), eb = skew(b0 + d0 - 1 - mid);
                if (ranks_before(sv[eb], si[eb], sv[ea], si[ea])) hi = mid;
                else lo = mid + 1;
            }
            // i + j = d < k, so both heads stay inside their lists
            int i = lo, j = d0 - lo;
            float a = sv[skew(a0 + i)], b = sv[skew(b0 + j)];
            int ax = si[skew(a0 + i)], bx = si[skew(b0 + j)];
            for (int d = d0; d < d1; ++d) {
                const bool take_b = ranks_before(b, bx, a, ax);
                dv[skew(o0 + d)] = take_b ? b : a;
                di[skew(o0 + d)] = take_b ? bx : ax;
                if (d + 1 == d1) break;
                // both heads reloaded: no branch that splits the warp
                i += !take_b;
                j += take_b;
                a = sv[skew(a0 + i)]; ax = si[skew(a0 + i)];
                b = sv[skew(b0 + j)]; bx = si[skew(b0 + j)];
            }
        }
        __syncthreads();
        float* tv = sv; sv = dv; dv = tv;
        int* ti = si; si = di; di = ti;
    }
    for (int r = tid; r < k; r += MERGE_THREADS) {
        dst_v[r] = sv[skew(r)];
        dst_i[r] = si[skew(r)];
    }
}

// Level 1 of a two-level pass 2: block (q, g) merges lists g*group ..
// g*group + group - 1 of query q and writes their k best over list g*group,
// which no other block reads.
__global__ void __launch_bounds__(MERGE_THREADS)
score_topk_merge_groups(float* cand_v, int* cand_i, int n_splits, int k, int group) {
    const int first = blockIdx.y * group;
    const long long o = ((long long)blockIdx.x * n_splits + first) * k;
    merge_lists(cand_v + o, cand_i + o, min(group, n_splits - first), 1, k, cand_v + o,
                cand_i + o);
}

// The last level: block q merges `lists` lists of query q, list j at list
// j * stride (all the splits at stride 1, or level 1's winners at stride
// group), into out (Q, k).
__global__ void __launch_bounds__(MERGE_THREADS)
score_topk_merge_final(const float* cand_v, const int* cand_i, int n_splits, int k, int lists,
                       int stride, float* __restrict__ out_v, int* __restrict__ out_i) {
    const long long q = blockIdx.x;
    merge_lists(cand_v + q * n_splits * k, cand_i + q * n_splits * k, lists, stride, k,
                out_v + q * k, out_i + q * k);
}

// Pass 2 over (n_queries, n_splits, k) candidates: one level when `group`
// >= n_splits, else level 1 over groups of `group` lists (in place), then
// the last level over their winners. merge_plan (kernels/topk.py) picks
// group so that each level's shared memory fits its budget.
cudaError_t launch_merge(float* cand_v, int* cand_i, int n_queries, int n_splits, int k,
                         int group, float* out_v, int* out_i, cudaStream_t stream) {
    if (n_queries < 1 || n_splits < 1 || n_splits > MAX_SPLITS || k < 1 || group < 1)
        return cudaErrorInvalidValue;
    const int n_groups = (n_splits + group - 1) / group;
    cudaError_t err;
    if (n_groups > 1) {
        const size_t smem = merge_smem(group, k);
        err = cudaFuncSetAttribute(score_topk_merge_groups,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        score_topk_merge_groups<<<dim3(n_queries, n_groups), MERGE_THREADS, smem, stream>>>(
            cand_v, cand_i, n_splits, k, group);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    const int lists = n_groups > 1 ? n_groups : n_splits;
    const size_t smem = merge_smem(lists, k);
    err = cudaFuncSetAttribute(score_topk_merge_final,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    score_topk_merge_final<<<n_queries, MERGE_THREADS, smem, stream>>>(
        cand_v, cand_i, n_splits, k, lists, n_groups > 1 ? group : 1, out_v, out_i);
    return cudaGetLastError();
}

template <typename T>
using StreamKernel = void (*)(const T*, const T*, long long, int, int, long long, long long, int,
                              float*, int*);

// The instantiation of score_topk_stream that k takes, its shared memory set.
template <typename T, int NQ>
cudaError_t stream_kernel(int dim, int k, StreamKernel<T>* kernel) {
    *kernel = k > STREAM_WIDE_K ? score_topk_stream<T, NQ, true> : score_topk_stream<T, NQ, false>;
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)stream_smem(NQ, dim, k));
}

template <typename T, int NQ>
cudaError_t launch_stream_q(const void* docs, const void* queries, long long n, int dim, int k,
                            long long n_docs, int n_splits, long long split_len,
                            float* cand_v, int* cand_i, cudaStream_t stream) {
    if (k < 1 || k > MAX_K) return cudaErrorInvalidValue;
    StreamKernel<T> kernel;
    cudaError_t err = stream_kernel<T, NQ>(dim, k, &kernel);
    if (err != cudaSuccess) return err;
    const int vec = dim % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
    kernel<<<n_splits, STREAM_THREADS, stream_smem(NQ, dim, k), stream>>>(
        static_cast<const T*>(docs), static_cast<const T*>(queries), n, dim, k, n_docs,
        split_len, vec, cand_v, cand_i);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const void* docs, const void* queries, long long n, int n_queries,
                          int dim, int k, long long n_docs, int n_splits, long long split_len,
                          float* cand_v, int* cand_i, cudaStream_t stream) {
    switch (n_queries) {
        case 1: return launch_stream_q<T, 1>(docs, queries, n, dim, k, n_docs, n_splits,
                                               split_len, cand_v, cand_i, stream);
        case 2: return launch_stream_q<T, 2>(docs, queries, n, dim, k, n_docs, n_splits,
                                               split_len, cand_v, cand_i, stream);
        case 3: return launch_stream_q<T, 3>(docs, queries, n, dim, k, n_docs, n_splits,
                                               split_len, cand_v, cand_i, stream);
        case 4: return launch_stream_q<T, 4>(docs, queries, n, dim, k, n_docs, n_splits,
                                               split_len, cand_v, cand_i, stream);
        default: break;
    }
    return cudaErrorInvalidValue;
}

template <typename T, int NQ>
cudaError_t stream_occupancy_q(int dim, int k, int* blocks_per_sm, int* registers,
                               int* local_bytes) {
    if (k < 1 || k > MAX_K) return cudaErrorInvalidValue;
    StreamKernel<T> kernel;
    cudaError_t err = stream_kernel<T, NQ>(dim, k, &kernel);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, STREAM_THREADS,
                                                         stream_smem(NQ, dim, k));
}

template <typename T>
cudaError_t stream_occupancy(int n_queries, int dim, int k, int* blocks_per_sm, int* registers,
                             int* local_bytes) {
    switch (n_queries) {
        case 1: return stream_occupancy_q<T, 1>(dim, k, blocks_per_sm, registers, local_bytes);
        case 2: return stream_occupancy_q<T, 2>(dim, k, blocks_per_sm, registers, local_bytes);
        case 3: return stream_occupancy_q<T, 3>(dim, k, blocks_per_sm, registers, local_bytes);
        case 4: return stream_occupancy_q<T, 4>(dim, k, blocks_per_sm, registers, local_bytes);
        default: return cudaErrorInvalidValue;
    }
}

using StreamMmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, long long, int, int,
                                 long long, long long, float*, int*);

// score_topk_stream_mma for NQ queries, its shared memory set for this k.
template <int NQ>
cudaError_t stream_mma_kernel(int dim, int k, StreamMmaKernel* kernel) {
    *kernel = score_topk_stream_mma<NQ>;
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)stream_mma_smem(NQ, dim, k));
}

template <int NQ>
cudaError_t launch_stream_mma_q(const void* docs, const void* queries, long long n, int dim,
                                int k, long long n_docs, int n_splits, long long split_len,
                                float* cand_v, int* cand_i, cudaStream_t stream) {
    StreamMmaKernel kernel;
    cudaError_t err = stream_mma_kernel<NQ>(dim, k, &kernel);
    if (err != cudaSuccess) return err;
    kernel<<<n_splits, STREAM_THREADS, stream_mma_smem(NQ, dim, k), stream>>>(
        static_cast<const __nv_bfloat16*>(docs), static_cast<const __nv_bfloat16*>(queries), n,
        dim, k, n_docs, split_len, cand_v, cand_i);
    return cudaGetLastError();
}

// The Q <= 4 pass on the tensor cores: bf16 docs at 2 <= n_queries <= 4,
// D a multiple of 8 and the docs 16-byte aligned, else cudaErrorInvalidValue
// (the wrapper routes every other call to score_topk_stream).
cudaError_t launch_stream_mma(const void* docs, const void* queries, long long n, int n_queries,
                              int dim, int k, long long n_docs, int n_splits,
                              long long split_len, float* cand_v, int* cand_i,
                              cudaStream_t stream) {
    if (k < 1 || k > MAX_K || dim % 8 != 0 || reinterpret_cast<uintptr_t>(docs) % 16 != 0)
        return cudaErrorInvalidValue;
    switch (n_queries) {
        case 2: return launch_stream_mma_q<2>(docs, queries, n, dim, k, n_docs, n_splits,
                                                split_len, cand_v, cand_i, stream);
        case 3: return launch_stream_mma_q<3>(docs, queries, n, dim, k, n_docs, n_splits,
                                                split_len, cand_v, cand_i, stream);
        case 4: return launch_stream_mma_q<4>(docs, queries, n, dim, k, n_docs, n_splits,
                                                split_len, cand_v, cand_i, stream);
        default: return cudaErrorInvalidValue;
    }
}

template <int NQ>
cudaError_t stream_mma_occupancy_q(int dim, int k, int* blocks_per_sm, int* registers,
                                   int* local_bytes) {
    StreamMmaKernel kernel;
    cudaError_t err = stream_mma_kernel<NQ>(dim, k, &kernel);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, STREAM_THREADS,
                                                         stream_mma_smem(NQ, dim, k));
}

// The wide selection's lists, buffers, bars and buffer counts, or the
// narrow one's lists, queue counts and fill counts, after the two staging
// buffers.
size_t tiles_smem(int k) {
    if (k > WIDE_K)
        return sizeof(float) * (2 * STAGE + 2 * BQ * (list_stride(k) + list_stride(TILE_QUEUE))
                                + 3 * BQ);
    return sizeof(float) * (2 * STAGE + BQ * k) + sizeof(int) * (BQ * k + 2 * BQ);
}

template <typename T>
using TilesKernel = void (*)(const T*, const T*, long long, int, int, int, long long, long long,
                             int, float*, int*, const float*, const int*, long long, long long);

// The instantiation of score_topk_tiles that takes k, its shared memory set.
template <typename T>
cudaError_t tiles_kernel(int k, TilesKernel<T>* kernel) {
    *kernel = k > WIDE_K ? score_topk_tiles<T, true> : score_topk_tiles<T, false>;
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)tiles_smem(k));
}

template <typename T>
cudaError_t launch_tiles(const void* docs, const void* queries, long long n, int n_queries,
                         int dim, int k, long long n_docs, int n_splits, long long split_len,
                         float* cand_v, int* cand_i, const float* bar_v, const int* bar_i,
                         long long bar_stride, long long split_docs, cudaStream_t stream) {
    if (k < 1 || k > MAX_K) return cudaErrorInvalidValue;
    TilesKernel<T> kernel;
    cudaError_t err = tiles_kernel<T>(k, &kernel);
    if (err != cudaSuccess) return err;
    const int vec = dim % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0
                    && reinterpret_cast<uintptr_t>(queries) % 16 == 0;
    const dim3 grid((n_queries + BQ - 1) / BQ, n_splits);
    kernel<<<grid, THREADS1, tiles_smem(k), stream>>>(
        static_cast<const T*>(docs), static_cast<const T*>(queries), n, n_queries, dim, k,
        n_docs, split_len, vec, cand_v, cand_i, bar_v, bar_i, bar_stride, split_docs);
    return cudaGetLastError();
}

template <typename T>
cudaError_t tiles_occupancy(int k, int* blocks_per_sm, int* registers, int* local_bytes) {
    if (k < 1 || k > MAX_K) return cudaErrorInvalidValue;
    TilesKernel<T> kernel;
    cudaError_t err = tiles_kernel<T>(k, &kernel);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS1,
                                                         tiles_smem(k));
}

// The instantiation of score_topk_tiles_ring that a call of n_queries over
// splits of split_len docs takes (up to RING_SMALL_Q 4 warps of queries x
// 2 of docs: 32 queries x 256 docs; else 8 x 1, 64 queries x 128 docs, or
// x 192 with RING_LONG_LANE_DOCS a lane on splits of RING_LONG_SPLIT docs
// or more), its shared memory set, its block's queries and tile's docs. The
// plan follows the block of split_len 0.
using RingKernel = void (*)(const float*, const float*, long long, int, int, int, long long,
                            long long, int, float*, int*, const CUtensorMap, const CUtensorMap);

template <int QW, int ND>
cudaError_t ring_kernel_q(RingKernel* kernel, size_t* smem, int* block_queries, int* tile_docs) {
    *kernel = score_topk_tiles_ring<QW, ND>;
    *smem = ring_smem_q<QW, ND>();
    *block_queries = Ring<QW, ND>::BQ;
    *tile_docs = Ring<QW, ND>::BN;
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

cudaError_t ring_kernel(int n_queries, long long split_len, RingKernel* kernel, size_t* smem,
                        int* block_queries, int* tile_docs) {
    if (n_queries <= RING_SMALL_Q)
        return ring_kernel_q<4, RING_LANE_DOCS>(kernel, smem, block_queries, tile_docs);
    return split_len < RING_LONG_SPLIT
               ? ring_kernel_q<8, RING_LANE_DOCS>(kernel, smem, block_queries, tile_docs)
               : ring_kernel_q<8, RING_LONG_LANE_DOCS>(kernel, smem, block_queries, tile_docs);
}

// The TMA map of a (rows, dim) f32 matrix for the ring: boxes of RING_DEPTH
// columns x box_rows rows, 64-byte swizzle (ring_unit's), zeros outside the
// matrix. cuTensorMapEncodeTiled comes from the driver through the runtime,
// so the library links nothing more.
cudaError_t ring_map(CUtensorMap* map, const float* base, long long rows, int dim, int box_rows) {
    static PFN_cuTensorMapEncodeTiled encode = nullptr;
    if (encode == nullptr) {
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
            encode = nullptr;
            return err != cudaSuccess ? err : cudaErrorNotSupported;
        }
    }
    const cuuint64_t size[2] = {(cuuint64_t)dim, (cuuint64_t)rows};
    const cuuint64_t stride[1] = {(cuuint64_t)dim * sizeof(float)};
    const cuuint32_t box[2] = {RING_DEPTH, (cuuint32_t)box_rows};
    const cuuint32_t step[2] = {1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                                size, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_ring(const void* docs, const void* queries, long long n, int n_queries, int dim,
                        int k, long long n_docs, int n_splits, long long split_len, float* cand_v,
                        int* cand_i, cudaStream_t stream) {
    if (k < 1 || k > WIDE_K || n_queries < 1) return cudaErrorInvalidValue;
    RingKernel kernel;
    size_t smem;
    int block_queries, tile_docs;
    cudaError_t err = ring_kernel(n_queries, split_len, &kernel, &smem, &block_queries, &tile_docs);
    if (err != cudaSuccess) return err;
    // TMA takes rows that start 16-byte aligned; else every thread copies 4 bytes at a time
    const int vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(docs) % 16 == 0
                    && reinterpret_cast<uintptr_t>(queries) % 16 == 0;
    CUtensorMap doc_map = {}, query_map = {};
    if (vec) {
        err = ring_map(&doc_map, static_cast<const float*>(docs), n, dim,
                       tile_docs < 256 ? tile_docs : 256);
        if (err == cudaSuccess)
            err = ring_map(&query_map, static_cast<const float*>(queries), n_queries, dim,
                           block_queries);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((n_queries + block_queries - 1) / block_queries, n_splits);
    kernel<<<grid, RING_THREADS, smem, stream>>>(
        static_cast<const float*>(docs), static_cast<const float*>(queries), n, n_queries, dim, k,
        n_docs, split_len, vec, cand_v, cand_i, doc_map, query_map);
    return cudaGetLastError();
}

template <typename K>
cudaError_t merge_occupancy(K kernel, int lists, int k, int* smem_bytes, int* blocks_per_sm,
                            int* registers, int* local_bytes) {
    *smem_bytes = (int)merge_smem(lists, k);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           *smem_bytes);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, MERGE_THREADS,
                                                         *smem_bytes);
}

}  // namespace

extern "C" {

// docs (n, dim) and queries (n_queries, dim), both row-major and of one type
// (float32, or bfloat16 when docs_bf16 != 0); cand_v/cand_i are
// (n_queries, n_splits, k) scratch; out_v/out_i are (n_queries, k).
// pass1 picks pass 1: PASS_STREAM (score_topk_stream, 1 <= n_queries <= 4,
// one block a split), PASS_STREAM_MMA (score_topk_stream_mma: bf16 docs,
// 2 <= n_queries <= 4, D a multiple of 8, docs 16-byte aligned; one block a
// split) or PASS_TILES (score_topk_tiles, 32 queries a block; bf16 docs on
// the tensor cores; f32 docs only at k > WIDE_K) or PASS_TILES_RING
// (score_topk_tiles_ring: f32 docs, k <= WIDE_K, 32 or 64 queries a block).
// merge_group is pass 2's group of lists (merge_plan); 0 runs pass 1 alone
// and leaves its lists in cand_v/cand_i, out_v/out_i untouched.
// The wide selection alone (score_topk_tiles: pass1 PASS_TILES, k >
// WIDE_K) takes a bar and a sample: bar_v/bar_i (nullptr for none) give
// query q's bar at q * bar_stride, and each split then keeps its top-k
// among the pairs that rank at or before it; split s reads the docs
// [s split_len, s split_len + split_docs), cut at n (elsewhere split_docs
// is split_len).
// Returns the cudaError_t of the launches (0 on success).
int score_topk_bar_launch(const void* docs, const void* queries, int docs_bf16,
                          long long n, int n_queries, int dim, int k, long long n_docs,
                          int n_splits, long long split_len, int pass1,
                          float* cand_v, int* cand_i, float* out_v, int* out_i,
                          int merge_group, const float* bar_v, const int* bar_i,
                          long long bar_stride, long long split_docs, void* stream) {
    const bool wide = pass1 == PASS_TILES && k > WIDE_K;
    if (n_splits < 1 || n_splits > MAX_SPLITS || merge_group < 0
        || (pass1 != PASS_STREAM && pass1 != PASS_STREAM_MMA && pass1 != PASS_TILES
            && pass1 != PASS_TILES_RING)
        || (pass1 == PASS_STREAM_MMA && !docs_bf16) || (pass1 == PASS_TILES_RING && docs_bf16)
        || (pass1 == PASS_TILES && !docs_bf16 && k <= WIDE_K)
        || (bar_v != nullptr && (bar_i == nullptr || !wide)) || split_docs < 1
        || split_docs > split_len || (split_docs != split_len && !wide))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (pass1 == PASS_STREAM_MMA)
        err = launch_stream_mma(docs, queries, n, n_queries, dim, k, n_docs, n_splits,
                                split_len, cand_v, cand_i, s);
    else if (pass1 == PASS_TILES_RING)
        err = launch_ring(docs, queries, n, n_queries, dim, k, n_docs, n_splits, split_len, cand_v,
                          cand_i, s);
    else if (docs_bf16)
        err = pass1 == PASS_STREAM
            ? launch_stream<__nv_bfloat16>(docs, queries, n, n_queries, dim, k, n_docs,
                                           n_splits, split_len, cand_v, cand_i, s)
            : launch_tiles<__nv_bfloat16>(docs, queries, n, n_queries, dim, k, n_docs,
                                          n_splits, split_len, cand_v, cand_i, bar_v, bar_i,
                                          bar_stride, split_docs, s);
    else
        err = pass1 == PASS_STREAM
            ? launch_stream<float>(docs, queries, n, n_queries, dim, k, n_docs, n_splits,
                                   split_len, cand_v, cand_i, s)
            : launch_tiles<float>(docs, queries, n, n_queries, dim, k, n_docs, n_splits,
                                  split_len, cand_v, cand_i, bar_v, bar_i, bar_stride,
                                  split_docs, s);
    if (err != cudaSuccess || merge_group == 0) return (int)err;
    return (int)launch_merge(cand_v, cand_i, n_queries, n_splits, k, merge_group, out_v, out_i,
                             s);
}

// Pass 2 alone over (n_queries, n_splits, k) lists, each sorted best first
// and padded with (-inf, INT_MAX), into out_v/out_i (n_queries, k). With
// more than one group (group < n_splits) level 1 overwrites the lists.
int score_topk_merge_launch(float* cand_v, int* cand_i, int n_queries, int n_splits, int k,
                            int group, float* out_v, int* out_i, void* stream) {
    return (int)launch_merge(cand_v, cand_i, n_queries, n_splits, k, group, out_v, out_i,
                             static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a score_topk_tiles block at this k (of the
// instantiation that k takes: k > WIDE_K the wide selection), the blocks of
// it that fit on one SM of the current device, and the registers a thread
// and the local memory a thread (spills) that the compiler gave it.
// Returns the cudaError_t (0 on success).
int score_topk_tiles_occupancy(int docs_bf16, int k, int* smem_bytes, int* blocks_per_sm,
                               int* registers, int* local_bytes) {
    *smem_bytes = (int)tiles_smem(k);
    return docs_bf16 ? (int)tiles_occupancy<__nv_bfloat16>(k, blocks_per_sm, registers,
                                                           local_bytes)
                     : (int)tiles_occupancy<float>(k, blocks_per_sm, registers, local_bytes);
}

// The same for a score_topk_stream block of n_queries (1..4) at this dim and
// k, with the registers a thread and the local memory a thread (spills)
// that the compiler gave it.
int score_topk_stream_occupancy(int docs_bf16, int n_queries, int dim, int k, int* smem_bytes,
                                int* blocks_per_sm, int* registers, int* local_bytes) {
    *smem_bytes = (int)stream_smem(n_queries, dim, k);
    return docs_bf16 ? (int)stream_occupancy<__nv_bfloat16>(n_queries, dim, k, blocks_per_sm,
                                                            registers, local_bytes)
                     : (int)stream_occupancy<float>(n_queries, dim, k, blocks_per_sm,
                                                    registers, local_bytes);
}

// The same for a score_topk_stream_mma block of n_queries (2..4) at this
// dim and k.
int score_topk_stream_mma_occupancy(int n_queries, int dim, int k, int* smem_bytes,
                                    int* blocks_per_sm, int* registers, int* local_bytes) {
    if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
    *smem_bytes = (int)stream_mma_smem(n_queries, dim, k);
    switch (n_queries) {
        case 2: return (int)stream_mma_occupancy_q<2>(dim, k, blocks_per_sm, registers, local_bytes);
        case 3: return (int)stream_mma_occupancy_q<3>(dim, k, blocks_per_sm, registers, local_bytes);
        case 4: return (int)stream_mma_occupancy_q<4>(dim, k, blocks_per_sm, registers, local_bytes);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The same for the score_topk_tiles_ring block of n_queries over splits
// of split_len docs (f32 docs, k <= WIDE_K), with the queries of its block
// and the docs of its tile; at split_len 0 the block the plan follows.
int score_topk_tiles_ring_split_occupancy(int n_queries, long long split_len, int k,
                                          int* smem_bytes, int* blocks_per_sm, int* registers,
                                          int* local_bytes, int* block_queries, int* tile_docs) {
    if (k < 1 || k > WIDE_K || n_queries < 1) return (int)cudaErrorInvalidValue;
    RingKernel kernel;
    size_t smem;
    cudaError_t err = ring_kernel(n_queries, split_len, &kernel, &smem, block_queries, tile_docs);
    if (err != cudaSuccess) return (int)err;
    *smem_bytes = (int)smem;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, RING_THREADS,
                                                              smem);
}

// The block the plan follows (split_len 0), as above.
int score_topk_tiles_ring_occupancy(int n_queries, int k, int* smem_bytes, int* blocks_per_sm,
                                    int* registers, int* local_bytes, int* block_queries,
                                    int* tile_docs) {
    return score_topk_tiles_ring_split_occupancy(n_queries, 0, k, smem_bytes, blocks_per_sm,
                                                 registers, local_bytes, block_queries, tile_docs);
}

// The same for a pass-2 block over `lists` lists of k: level 1
// (score_topk_merge_groups) when final_level == 0, else the last level.
int score_topk_merge_occupancy(int final_level, int lists, int k, int* smem_bytes,
                               int* blocks_per_sm, int* registers, int* local_bytes) {
    return final_level ? (int)merge_occupancy(score_topk_merge_final, lists, k, smem_bytes,
                                              blocks_per_sm, registers, local_bytes)
                       : (int)merge_occupancy(score_topk_merge_groups, lists, k, smem_bytes,
                                              blocks_per_sm, registers, local_bytes);
}

}  // extern "C"

