"""Time variants of the score + top-k kernel's Q >= 5 pass in turns on one card.

    python -m twotowers_tpu_torch.kernels.topk_variants

Each variant is ``csrc/score_topk.cu`` with one constant or launch bound
rewritten, compiled by ``nvcc`` (all at once) into ``build/topk_variants/``,
or the shipped kernel under another plan. Each is first held bit-equal to
the plain version on integer-valued inputs, then timed with CUDA events at
N=1M, D=128, k=10 (Q=256 in f32 and bf16, Q=32 in f32) in the order
A B C ... C B A; a time is the mean of its two turns. Prints one JSON line
per variant; then the opcode counts of the shipped f32 pass 1
(``cuobjdump -sass``) and the SM clock and power that ``nvidia-smi``
samples while it runs Q=256 f32 for a few seconds; last the card's name
and power limit.
"""

from __future__ import annotations

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
SHAPES = [(256, torch.float32), (256, torch.bfloat16), (32, torch.float32)]


def one_full_wave(q, n, sm, per_sm):
    """The plan with the split count rounded down, so that every block fits
    in one wave (the shipped plan rounds up: a few blocks more)."""
    tiles, q_blocks = -(-n // topk.BATCH_TILE_N), -(-q // 32)
    n_splits = max(1, min(sm * per_sm // q_blocks, tiles, topk.MAX_SPLITS))
    split_len = -(-tiles // n_splits) * topk.BATCH_TILE_N
    return 8, -(-n // split_len), split_len


def two_waves(q, n, sm, per_sm):
    return topk.plan(q, n, sm, 2 * per_sm)


# name -> (rewrites of the source, plan)
VARIANTS = {
    "shipped": ([], topk.plan),
    "split count rounded down": ([], one_full_wave),
    "two waves of splits": ([], two_waves),
    "BK=32": ([("constexpr int BK = 16;", "constexpr int BK = 32;")], topk.plan),
    "BS=BN+8": ([("constexpr int BS = BN + 4;", "constexpr int BS = BN + 8;")], topk.plan),
    "launch bound 4 blocks": ([("__launch_bounds__(THREADS1)\nscore_topk_tiles(",
                                "__launch_bounds__(THREADS1, 4)\nscore_topk_tiles(")], topk.plan),
}


def compile_variants() -> dict:
    """name -> (loaded library, ptxas lines of score_topk_tiles, library path)."""
    source = (build.CSRC_DIR / "score_topk.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for name, (rewrites, _) in VARIANTS.items():
        text = source
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
                 if "Function properties" in line and "score_topk_tiles" in line
                 for j in (1, 2) if i + j < len(lines)]
        libs[name] = (ctypes.CDLL(str(lib)), ptxas, lib)
    return libs


def sass_opcodes(lib: Path) -> dict:
    """Opcode counts of score_topk_tiles<float> in ``lib``'s SASS."""
    nvcc = Path(build.find_nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, inside = collections.Counter(), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "score_topk_tilesIf" in line
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                counts[m.group(1)] += 1
    return dict(counts.most_common(24))


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
    lib.score_topk_launch.argtypes = [ptr, ptr, i32, i64, i32, i32, i32, i64, i32, i64, i32,
                                      ptr, ptr, ptr, ptr, ptr]
    occupancy = {}

    def per_sm(dtype):
        if dtype not in occupancy:
            smem, blocks = ctypes.c_int(), ctypes.c_int()
            err = lib.score_topk_tiles_occupancy(int(dtype == torch.bfloat16), K,
                                                 ctypes.byref(smem), ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"occupancy query failed: cudaError_t {err}")
            occupancy[dtype] = (smem.value, blocks.value)
        return occupancy[dtype]

    def run(docs, queries):
        n, dim = docs.shape
        q = queries.shape[0]
        sm = torch.cuda.get_device_properties(docs.device).multi_processor_count
        rows, n_splits, split_len = plan(q, n, sm, per_sm(docs.dtype)[1])
        cand_v = torch.empty((q, n_splits, K), dtype=torch.float32, device=docs.device)
        cand_i = torch.empty((q, n_splits, K), dtype=torch.int32, device=docs.device)
        out_v = torch.empty((q, K), dtype=torch.float32, device=docs.device)
        out_i = torch.empty((q, K), dtype=torch.int32, device=docs.device)
        err = lib.score_topk_launch(
            docs.data_ptr(), queries.data_ptr(), int(docs.dtype == torch.bfloat16), n, q, dim,
            K, n, n_splits, split_len, rows, cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return out_v, out_i

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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("topk_variants: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    runs, libs = {}, compile_variants()
    for name, (lib, ptxas, _) in libs.items():
        run, per_sm = launcher(lib, VARIANTS[name][1])
        ints = torch.randint(-2, 3, (100_003, 128), device=dev, generator=gen).float()
        qints = torch.randint(-2, 3, (257, 128), device=dev, generator=gen).float()
        for dtype in (torch.float32, torch.bfloat16):
            got, want = run(ints.to(dtype), qints.to(dtype)), score_topk_reference(ints.to(dtype), qints, K)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"variant {name!r} {dtype}: not the plain version's result")
        runs[name] = (run, {"ptxas": ptxas, "smem_bytes_blocks_per_sm_f32_bf16":
                            [per_sm(torch.float32), per_sm(torch.bfloat16)]})
    docs = torch.randn(N, DIM, device=dev, generator=gen)
    docs /= docs.norm(dim=1, keepdim=True)
    inputs = {dtype: docs.to(dtype) for dtype in (torch.float32, torch.bfloat16)}
    queries = {q: torch.randn(q, DIM, device=dev, generator=gen) for q in (32, 256)}
    order = list(runs) + list(runs)[::-1]
    times = {name: {f"q{q} {dtype}": [] for q, dtype in SHAPES} for name in runs}
    for name in order:
        for q, dtype in SHAPES:
            d, qs = inputs[dtype], queries[q].to(dtype)
            times[name][f"q{q} {dtype}"].append(event_ms(lambda: runs[name][0](d, qs)))
    for name, (_, info) in runs.items():
        ms = {shape: sum(t) / len(t) for shape, t in times[name].items()}
        print(json.dumps({"variant": name, "ms": ms, "turns": times[name], **info}), flush=True)
    print(json.dumps({"sass_opcodes shipped score_topk_tiles<float>":
                      sass_opcodes(libs["shipped"][2])}), flush=True)
    d, qs = inputs[torch.float32], queries[256]
    print(json.dumps({"clocks shipped q256 f32": clocks_while(lambda: runs["shipped"][0](d, qs))}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
