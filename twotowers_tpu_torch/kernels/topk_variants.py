"""Time variants of the score + top-k kernel in turns on one card.

    python -m twotowers_tpu_torch.kernels.topk_variants [--against DIR] [--only NAME ...]
                                                        [--k-sweep]

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
runs Q=256 f32 and Q=1 f32 for a few seconds each; last the card's name
and power limit. The variant "selection cut" times the Q >= 5 pass's
product alone, bf16 on the tensor cores and f32 on the CUDA cores.
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
          (4, torch.bfloat16, K), (1, torch.float32, 256), (1, torch.bfloat16, 256),
          (32, torch.float32, K), (32, torch.bfloat16, K), (256, torch.float32, K),
          (256, torch.bfloat16, K), (32, torch.float32, 256), (256, torch.float32, 256),
          (32, torch.bfloat16, 256), (256, torch.bfloat16, 256), (32, torch.float32, 100),
          (4, torch.float32, 256), (4, torch.bfloat16, 256), (1, torch.float32, 100)]
K_SWEEP = [(q, torch.float32, k) for q in (32, 256) for k in (10, 12, 14, 16, 24, 32)]
K_SWEEP += [(q, dtype, k) for q in (1, 4) for dtype in (torch.float32, torch.bfloat16)
            for k in (10, 14, 16, 24, 32, 64, 100, 256)]


def one_full_wave(q, n, sm, per_sm):
    """The plan with the split count rounded down, so that every block fits
    in one wave (the shipped plan rounds up: a few blocks more)."""
    if q <= 4:
        return topk.plan(q, n, sm, per_sm)
    tiles, q_blocks = -(-n // topk.BATCH_TILE_N), -(-q // 32)
    n_splits = max(1, min(sm * per_sm // q_blocks, tiles, topk.MAX_SPLITS))
    split_len = -(-tiles // n_splits) * topk.BATCH_TILE_N
    return 8, -(-n // split_len), split_len


def two_waves(q, n, sm, per_sm):
    return topk.plan(q, n, sm, 2 * per_sm)


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

# name -> (rewrites of the source, plan)
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
    # the Q >= 5 pass's product alone, bf16 on the tensor cores and f32 on the
    # CUDA cores: no score passes 1e30, so the narrow selection is one
    # block-wide vote a tile and the wide one keeps only its votes; every
    # sum is still read, so none is left out
    "selection cut": ([
        ("#pragma unroll\n        for (int h = 0; h < 2; ++h) {",
         "bool cut = false;\n#pragma unroll\n        for (int i = 0; i < 8; ++i)\n"
         "#pragma unroll\n            for (int j = 0; j < 8; ++j) cut |= acc[i][j] > 1.0e30f;\n"
         "#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n"
         "            if (!__syncthreads_or(cut)) break;"),
        ("if (doc < end && ranks_before(s, (int)doc, kth_v, kth_i)) mine |= 1u << jj;",
         "if (s > 1.0e30f && doc < end && ranks_before(s, (int)doc, kth_v, kth_i))\n"
         "                mine |= 1u << jj;"),
    ], topk.plan),
}
# variants whose output is not the function's: timed, never checked
CUT = {"stream narrow selection cut", "stream narrow selection and end merge cut",
       "selection cut"}
AGAINST = "against"


def compile_variants(against=None) -> dict:
    """name -> (loaded library, ptxas lines of passes 1, library path)."""
    source = (build.CSRC_DIR / "score_topk.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    todo = {name: (rewrites, source) for name, (rewrites, _) in VARIANTS.items()}
    if against is not None:
        todo[AGAINST] = ([], (Path(against) / "twotowers_tpu_torch" / "csrc"
                              / "score_topk.cu").read_text())
    for name, (rewrites, text) in todo.items():
        for old, new in rewrites:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        tag = re.sub(r"\W+", "_", name)
        src, lib = OUT_DIR / f"{tag}.cu", OUT_DIR / f"lib{tag}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
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
    ``score_topk_`` on, which two builds of the source share."""
    nvcc = Path(build.find_nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    kernels, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"score_topk_\w+", line)
            current = kernels.setdefault(m.group(0), []) if m else None
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


def launcher(lib: ctypes.CDLL, plan):
    """score_topk_cuda's launch through ``lib`` under ``plan``."""
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    tree = hasattr(lib, "score_topk_merge_launch")  # else pass 2 takes no group
    lib.score_topk_launch.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64, i32,
                                      ptr, ptr, ptr, ptr] + [i32] * tree + [ptr]
    if hasattr(lib, "score_topk_stream_inserts"):
        lib.score_topk_stream_inserts.restype = ctypes.c_ulonglong
    occupancy = {}

    def per_sm(dtype, q, k=K):
        """(shared-memory bytes, blocks per SM, registers, local bytes) of
        the pass that takes Q=q; the last two None where the source does
        not report them."""
        key = (dtype, min(q, 5), k)
        bf16 = int(dtype == torch.bfloat16)
        if key not in occupancy:
            out = [ctypes.c_int(-1) for _ in range(4)]
            if q > 4:  # an older source reads the first two pointers, ignores the rest
                err = lib.score_topk_tiles_occupancy(bf16, k, *map(ctypes.byref, out))
            elif hasattr(lib, "score_topk_stream_occupancy"):
                err = lib.score_topk_stream_occupancy(bf16, q, DIM, k, *map(ctypes.byref, out))
            else:  # a source whose Q <= 4 plan aimed at a fixed 8 blocks an SM
                err, out[1].value = 0, 8
            if err != 0:
                raise RuntimeError(f"occupancy query failed: cudaError_t {err}")
            occupancy[key] = tuple(o.value if o.value >= 0 else None for o in out)
        return occupancy[key]

    def plan_of(q, dtype, k, n=N):
        sm = torch.cuda.get_device_properties(0).multi_processor_count
        return plan(q, n, sm, per_sm(dtype, q, k)[1])

    def run(docs, queries, k=K):
        n, dim = docs.shape
        q = queries.shape[0]
        rows, n_splits, split_len = plan_of(q, docs.dtype, k, n)
        cand_v = torch.empty((q, n_splits, k), dtype=torch.float32, device=docs.device)
        cand_i = torch.empty((q, n_splits, k), dtype=torch.int32, device=docs.device)
        out_v = torch.empty((q, k), dtype=torch.float32, device=docs.device)
        out_i = torch.empty((q, k), dtype=torch.int32, device=docs.device)
        group = [topk.merge_plan(n_splits, k)[0]] if tree else []
        err = lib.score_topk_launch(
            docs.data_ptr(), queries.data_ptr(), int(docs.dtype == torch.bfloat16), n, q, dim,
            k, n, n_splits, split_len, rows, cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), *group, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out_v, out_i

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
                        help="time K_SWEEP (Q >= 5 at k = 10 to 32) instead of SHAPES")
    args = parser.parse_args()
    shapes = K_SWEEP if args.k_sweep else SHAPES
    if not torch.cuda.is_available():
        raise SystemExit("topk_variants: needs a CUDA card")
    if args.only:
        for name in set(VARIANTS) - set(args.only) - {"shipped"}:
            del VARIANTS[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    runs, libs = {}, compile_variants(args.against)
    for name, (lib, ptxas, _) in libs.items():
        run, per_sm = launcher(lib, VARIANTS[name][1] if name in VARIANTS else topk.plan)
        ints = torch.randint(-2, 3, (100_003, 128), device=dev, generator=gen).float()
        qints = torch.randint(-2, 3, (257, 128), device=dev, generator=gen).float()
        for dtype in (torch.float32, torch.bfloat16):
            for q, k in ((1, K), (4, K), (257, K), (1, 256), (4, 256), (1, 100), (2, 33),
                         (3, 64), (257, 256), (33, 100), (5, 33)):
                if name in CUT:
                    break
                got = run(ints.to(dtype), qints[:q].to(dtype), k)
                want = score_topk_reference(ints.to(dtype), qints[:q], k)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"variant {name!r} {dtype} Q={q} k={k}: not the "
                                         "plain version's result")
        runs[name] = (run, {"ptxas": ptxas, "occupancy_f32_bf16": {
            f"q{q} k{k}": [per_sm(torch.float32, q, k), per_sm(torch.bfloat16, q, k)]
            for q, k in ((1, K), (4, K), (1, 256), (4, 256), (5, K), (5, 256))}})
    docs = torch.randn(N, DIM, device=dev, generator=gen)
    docs /= docs.norm(dim=1, keepdim=True)
    inputs = {dtype: docs.to(dtype) for dtype in (torch.float32, torch.bfloat16)}
    queries = {q: torch.randn(q, DIM, device=dev, generator=gen) for q in (1, 4, 32, 256)}
    label = lambda q, dtype, k: f"q{q} {dtype} k{k}"  # noqa: E731
    if AGAINST in runs:  # the shipped kernel's output is "against"'s
        same, held = {}, {}
        for q, dtype, k in shapes:
            d, qs = inputs[dtype], queries[q].to(dtype)
            got, want = runs["shipped"][0](d, qs, k), runs[AGAINST][0](d, qs, k)
            if dtype == torch.bfloat16 and q > 4:  # the tensor cores' summation order
                err, swaps = topk.agree(d, qs, got, want)
                held[label(q, dtype, k)] = {"max_abs_err": err, "near_tie_swaps": swaps}
                continue
            same[label(q, dtype, k)] = (torch.equal(got[0].view(torch.int32),
                                                    want[0].view(torch.int32))
                                        and torch.equal(got[1], want[1]))
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
        for q, dtype, k in shapes:
            d, qs = inputs[dtype], queries[q].to(dtype)
            times[name][label(q, dtype, k)].append(event_ms(lambda: runs[name][0](d, qs, k)))
    for name, (run, info) in runs.items():
        ms = {shape: sum(t) / len(t) for shape, t in times[name].items()}
        if name in ("shipped", AGAINST):  # pass 1 and each level of pass 2 apart
            info["device_ms_by_kernel"] = {
                label(q, dtype, k): device_ms_by_kernel(
                    lambda: run(inputs[dtype], queries[q].to(dtype), k))
                for q, dtype, k in shapes}
        if hasattr(run.lib, "score_topk_stream_inserts"):  # a warp's inserts a query
            info["inserts_per_warp_and_query"] = {}
            for q, dtype, k in shapes:
                if q > 4:
                    continue
                run.lib.score_topk_stream_inserts()
                run(inputs[dtype], queries[q].to(dtype), k)
                torch.cuda.synchronize()
                n_splits = run.plan_of(q, dtype, k)[1]
                info["inserts_per_warp_and_query"][label(q, dtype, k)] = (
                    run.lib.score_topk_stream_inserts() / (n_splits * 8 * q))
        print(json.dumps({"variant": name, "ms": ms, "turns": times[name], "cut": name in CUT,
                          **info}), flush=True)
    shipped_sass = sass_kernels(libs["shipped"][2])
    for kernel in ("score_topk_tilesIfLb0", "score_topk_tilesIfLb1",
                   "score_topk_tilesI13__nv_bfloat16Lb0", "score_topk_tilesI13__nv_bfloat16Lb1",
                   "score_topk_streamIfLi1ELb0", "score_topk_streamIfLi1ELb1"):
        ops = sass_opcodes(shipped_sass, kernel)
        print(json.dumps({f"sass_opcodes shipped {kernel}": ops}), flush=True)
        if "tilesI13__nv_bfloat16" in kernel:  # the tensor cores: HMMA, no f32 FMA loop
            hmma = sum(n for op, n in ops.items() if op.startswith("HMMA"))
            ffma = sum(n for op, n in ops.items() if op.startswith("FFMA"))
            if hmma == 0 or ffma >= hmma:
                raise AssertionError(f"{kernel}: {hmma} HMMA, {ffma} FFMA")
    for q in (256, 1):
        d, qs = inputs[torch.float32], queries[q]
        print(json.dumps({f"clocks shipped q{q} f32":
                          clocks_while(lambda: runs["shipped"][0](d, qs))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
