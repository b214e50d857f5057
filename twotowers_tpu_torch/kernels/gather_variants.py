"""Time the row-gather kernel (``csrc/gather_rows.cu``) at the port's five
lookup shapes, in turns, on one card, with its launch path's host time.

    python -m twotowers_tpu_torch.kernels.gather_variants [--against DIR] [--only NAME ...]
                                                          [--sass-against DIR]

``SHAPES`` are the lookups the port makes: (a) the word train step's
(1,048,576 Zipf(1.07) ids, D=64, f32 table -> bf16), (b) the #6 experiment's
(3,145,728 ids, bf16 -> bf16), (c) one batch of the pretrained phase (4,096
ids of a frozen D=300 f32 table -> f32), (d) one encode of the Hub-serve
phase (32 texts x 64 ids, D=64, f32 -> bf16) and (e) model rank 1's shard
in the parallel phase (524,288 ids less the shard's offset over its 16,384
rows, most of them outside it, f32 -> bf16).

Each "runner" gathers with one build of the kernel: "shipped" through
``gather.gather_rows``, the wrapper a user calls; "against" (``--against
DIR``: the ``gather_rows.cu`` of another checkout, say the parent commit
unpacked by ``git archive`` into the ignored ``baseline/``), launched
through its own C entry with the launch rule its wrapper had; and the
variants of ``VARIANTS``, each ``csrc/gather_rows.cu`` with some text
rewritten and/or the shipped plan with some fields replaced (a checkout
whose ``gather.py`` has no ``plan`` runs no variant). Every runner's output
is first held bit-equal to ``gather_rows_reference`` at every shape (the
run fails otherwise); then each shape is timed with CUDA events in the
order A B C ... C B A, a time being the mean of its two turns, and the
device ms by kernel (``torch.profiler``) read for each runner. Beside them:
the plain version, ``F.embedding`` on int64 ids and a table already in the
output's dtype (the library yardstick; none at (e), whose ids F.embedding
refuses), and the bytes bound (the ids, the
table rows the ids need and the output, each moved once, at 3.35 TB/s).

Host time (``--host`` mode, in a child process whose ``sys.path`` starts
at one checkout; ``--against`` runs the two checkouts' children in the
order this, against, against, this): at (c) and (d) the microseconds a call
of ``gather.gather_rows``, of ``Embedding.forward`` under
``torch.inference_mode()`` and of ``F.embedding``, each the median of 9
runs of 1,000 calls with one synchronise at the end of each, the three
taking turns within each round; and the same (3 rounds) for each stage of
the wrapper's launch path alone.

Then the SASS of each gather kernel (``cuobjdump -sass``: opcode counts)
and its registers (``ptxas -v``), for the shipped build and "against".
``--sass-against DIR`` also builds DIR's ``score_topk.cu`` and
``scatter_add_rows.cu`` and says, kernel by kernel, whether this checkout's
build compiled to the very same instructions. Last, the card's name and
power limit. One JSON object a line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
SHAPES = {  # name -> (ids, vocab, dim, table dtype, out dtype, model rank of 2 or None)
    "a word": (1_048_576, 32_768, 64, torch.float32, torch.bfloat16, None),
    "b #6": (3_145_728, 32_768, 64, torch.bfloat16, torch.bfloat16, None),
    "c pretrained": (4_096, 32_768, 300, torch.float32, torch.float32, None),
    "d hub-serve encode": (2_048, 32_768, 64, torch.float32, torch.bfloat16, None),
    "e sharded": (524_288, 32_768, 64, torch.float32, torch.bfloat16, 1),
}
# the host-time shapes: the ids' 2-D shape as the lookup takes them, the
# table's kind and whether it is trained
HOST_SHAPES = {"c pretrained": ((128, 32), "word2vec", False),
               "d hub-serve encode": ((32, 64), "lookup", True)}
AGAINST = "against"
# name -> (source rewrites: (old, new) pairs, each old found once; plan fields replaced)
VARIANTS = {
    "rows 1": ([], {"rows": 1}),
    "rows 2": ([], {"rows": 2}),
    "rows 4": ([], {"rows": 4}),
    "grid x2": ([], {"grid x": 2}),
    "half the columns a lane": ([], {"elems / 2": True}),
    "one column block at a time": ([("int G = SLOTS / R>", "int G = 1>")], {}),
    "ids loaded by every lane": ([(
        "id[r] = __shfl_sync(0xffffffffu, mine, r * teams + team);",
        "id[r] = base + (unsigned)(r * teams + team) < (unsigned)n"
        " ? ids[base + r * teams + team] : -1;")], {}),
    "launch bound of threads alone": ([
        ("__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)",
         "__global__ void __launch_bounds__(THREADS)")], {}),
    "plain stores": ([("__stcs(q + k, y.w[k]);", "q[k] = y.w[k];")], {}),
}
CALLS, ROUNDS = 1000, 9


def zipf_ids(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    """Ids drawn Zipf(1.07) over ranks 1..vocab-1 (bench.py's word-vocab
    inputs and chip_smoke.py's)."""
    ranks = np.arange(1, vocab)
    weights = 1.0 / np.power(ranks, 1.07)
    return rng.choice(ranks, size=n, p=weights / weights.sum()).astype(np.int32)


def make_inputs(name: str, dev, seed: int = 0):
    """(table, int32 ids) of a shape, from a seed; a sharded shape's table
    is the model rank's rows and its ids are less the rank's offset."""
    n, vocab, dim, table_dtype, _, rank = SHAPES[name]
    rng = np.random.default_rng(seed)
    ids = zipf_ids(rng, vocab, n)
    rows = vocab if rank is None else vocab // 2
    if rank is not None:
        ids = ids - np.int32(rank * rows)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(rows, dim, generator=gen, device=dev).to(table_dtype)
    return table, torch.from_numpy(ids).to(dev)


def bound_ms(table, ids, out_dtype) -> float:
    """Bytes bound: the ids, the distinct table rows they read and the
    output, each moved once, at the HBM rate."""
    owned = ids[(ids >= 0) & (ids < table.shape[0])]
    rows = int(torch.unique(owned).numel())
    row_bytes = table.shape[1] * table.element_size()
    n_bytes = ids.numel() * 4 + rows * row_bytes + ids.numel() * table.shape[1] * out_dtype.itemsize
    return n_bytes / H100_BYTES_PER_S * 1e3


def event_ms(fn, target_s: float = 0.05) -> float:
    """Mean ms a call of ``fn`` (CUDA events), over about ``target_s`` of
    calls after warm-up."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(2000, max(30, target_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_by_kernel(fn, reps: int = 100) -> dict:
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
            out[name[:80]] = us / reps / 1e3
    return out


# ---- host time (--host) -------------------------------------------------------

def per_call_us(fns: dict, calls: int = CALLS, rounds: int = ROUNDS) -> dict:
    """Microseconds a call of each of ``fns`` (name -> (fn, whether under
    ``torch.inference_mode``)): ``rounds`` rounds, each a run of ``calls``
    calls of every fn in turn with one synchronise at the end of the run;
    the median run of each fn. Turns within a round put the fns under the
    same load of the host."""
    runs = {name: [] for name in fns}
    for r in range(rounds + 1):
        for name, (fn, inference) in fns.items():
            with torch.inference_mode(inference):
                start = time.perf_counter()
                for _ in range(calls if r else 50):  # round 0 warms up
                    fn()
                torch.cuda.synchronize()
            if r:
                runs[name].append((time.perf_counter() - start) / calls * 1e6)
    return {name: statistics.median(times) for name, times in runs.items()}


def wrapper_stages(gather, table, ids, out_dtype) -> dict:
    """Each stage of ``gather.gather_rows``'s launch path as a call of its
    own, with what the stage computes on these tensors."""
    n, dim = ids.shape[0], table.shape[1]
    if not hasattr(gather, "plan"):  # the launch path before the plan
        fn = gather._lib().gather_rows_launch
        out = torch.empty((n, dim), dtype=out_dtype, device=table.device)
        vec = 16 // table.element_size()
        stream = torch.cuda.current_stream(table.device).cuda_stream
        args = (table.data_ptr(), int(table.dtype == torch.bfloat16), ids.data_ptr(), n, dim,
                table.shape[0], out.data_ptr(), int(out_dtype == torch.bfloat16),
                int(dim % vec == 0 and table.data_ptr() % 16 == 0), stream)

        def device_scope():
            with torch.cuda.device(table.device):
                pass

        return {"check_args": lambda: gather.check_args(table, ids, out_dtype),
                "2 x .contiguous()": lambda: (table.contiguous(), ids.contiguous()),
                "torch.empty": lambda: torch.empty((n, dim), dtype=out_dtype,
                                                   device=table.device),
                "vectorize test": lambda: dim % vec == 0 and table.data_ptr() % 16 == 0,
                "_lib() (build lock)": gather._lib,
                "with torch.cuda.device": device_scope,
                "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
                    table.device).cuda_stream,
                "ctypes launch": lambda: fn(*args)}
    index, table_ptr = table.get_device(), table.data_ptr()
    fn = gather._launcher()
    key = (table.shape, ids.shape, table.dtype, ids.dtype, out_dtype, index, ids.get_device(),
           table_ptr % 16)
    p, code, n, dim, vocab = gather._plans.get(key) or gather._plan_for(key, table, ids,
                                                                        out_dtype)
    out = torch.empty(n, dim, dtype=out_dtype, device=table.device)
    args = (table_ptr, ids.data_ptr(), out.data_ptr(), n, dim, vocab, code, p.blocks,
            torch._C._cuda_getCurrentRawStream(index))
    return {"is_cpu test": lambda: table.is_cpu and ids.is_cpu,
            "2 x is_contiguous()": lambda: (table.is_contiguous(), ids.is_contiguous()),
            "key": lambda: (table.shape, ids.shape, table.dtype, ids.dtype, out_dtype,
                            table.get_device(), ids.get_device(), table.data_ptr() % 16),
            "plan (dict)": lambda: gather._plans.get(key),
            "torch.empty": lambda: torch.empty(n, dim, dtype=out_dtype, device=table.device),
            "args + raw stream": lambda: (
                table_ptr, ids.data_ptr(), out.data_ptr(), n, dim, vocab, code, p.blocks,
                torch._C._cuda_getCurrentRawStream(index)),
            "current device test": lambda: torch._C._cuda_getDevice() == index,
            "ctypes call, refused (blocks=0)": lambda: fn(*args[:7], 0, args[8]),
            "ctypes launch": lambda: fn(*args),
            "check_args (first call of a key only)": lambda: gather.check_args(table, ids,
                                                                              out_dtype)}


def host_times() -> dict:
    """The --host measurement of the checkout first on ``sys.path``."""
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import gather
    from twotowers_tpu_torch.models.embeddings import Embedding, EmbeddingSpec

    dev = torch.device("cuda")
    out = {"root": str(Path(gather.__file__).resolve().parents[2])}
    for name, (shape, kind, trainable) in HOST_SHAPES.items():
        table, ids = make_inputs(name, dev)
        out_dtype = SHAPES[name][4]
        vocab, dim = table.shape
        module = Embedding(EmbeddingSpec(kind=kind, vocab_size=vocab, embedding_dim=dim,
                                         trainable=trainable)).to(dev)
        with torch.no_grad():
            module.table.copy_(table)
        ids2d = ids.reshape(shape)
        ids64, lib_table = ids.long(), table.to(out_dtype)

        def forward():
            with torch.inference_mode():
                return module(ids2d, out_dtype)

        want = gather.gather_rows_reference(table, ids, out_dtype).reshape(*shape, dim)
        if not torch.equal(forward(), want):
            raise AssertionError(f"{name}: Embedding.forward is not the plain gather")
        row = per_call_us({
            "gather_rows": (lambda: gather.gather_rows(table, ids, out_dtype), False),
            "Embedding.forward (inference_mode)": (lambda: module(ids2d, out_dtype), True),
            "F.embedding": (lambda: F.embedding(ids64, lib_table), False)})
        row["stages"] = per_call_us({stage: (fn, False) for stage, fn in
                                     wrapper_stages(gather, table, ids, out_dtype).items()},
                                    rounds=3)
        out[name] = row
    return out


def host_turns(roots: list) -> list:
    """The --host measurement of each checkout in ``roots``, each in a
    child process of its own, in that order."""
    rows = []
    for root in roots:
        root = Path(root).resolve()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--host",
                               "--root", str(root)], cwd=str(root), capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--host in {root} failed:\n{proc.stderr[-3000:]}")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return rows


# ---- the runners --------------------------------------------------------------

def compile_sources(todo: dict, out_dir: Path) -> dict:
    """name -> (library path, ptxas output), each source text built by one
    ``nvcc`` (all started together)."""
    from twotowers_tpu_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = build.find_nvcc(), {}
    for name, text in todo.items():
        tag = re.sub(r"\W+", "_", name)
        src, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    built = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{name!r} did not build:\n{out[-2000:]}")
        built[name] = (lib, out)
    return built


def rewrite(name: str, text: str, rewrites) -> str:
    for old, new in rewrites:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def against_runner(lib: ctypes.CDLL):
    """A launcher of another checkout's kernel under its own launch rule:
    the plan's C entry where the library has ``gather_rows_occupancy``,
    else the 16-byte rule of the entry before the plan."""
    from twotowers_tpu_torch.kernels import gather

    fn = lib.gather_rows_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if hasattr(lib, "gather_rows_occupancy"):
        return plan_runner(lib, {})
    fn.argtypes = [ptr, i32, ptr, i64, i32, i64, ptr, i32, i32, ptr]
    fn.restype = i32

    def run(table, ids, out_dtype):
        n, dim = ids.shape[0], table.shape[1]
        out = torch.empty((n, dim), dtype=out_dtype, device=table.device)
        vec = 16 // table.element_size()
        err = fn(table.data_ptr(), int(table.dtype == torch.bfloat16), ids.data_ptr(), n, dim,
                 table.shape[0], out.data_ptr(), int(out_dtype == torch.bfloat16),
                 int(dim % vec == 0 and table.data_ptr() % 16 == 0),
                 torch._C._cuda_getCurrentRawStream(table.get_device()))
        if err:
            raise RuntimeError(f"{AGAINST}: cudaError_t {err}")
        return out

    del gather
    return run


def plan_runner(lib: ctypes.CDLL, fields: dict):
    """A launcher of a build of this checkout's kernel under the shipped
    plan with ``fields`` replaced: "elems / 2" (half the columns a lane,
    twice the lanes a row), "rows" (the grid planned again for them) or
    "grid x" (the grid times that). Plans are made once a shape, so that the launch costs
    the host about what the wrapper's does."""
    from twotowers_tpu_torch.kernels import gather

    fn = gather.bind(lib)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}

    def planned(n, dim, table, out):
        p = gather.plan(n, dim, table.dtype, out.dtype, table.data_ptr(), out.data_ptr(),
                        sm_count)
        if "elems / 2" in fields and p.elems > 1:  # twice the lanes, half the bytes each
            lanes = min(32, 1 << (dim // (p.elems // 2) - 1).bit_length())
            rows = min(p.rows, lanes)
            p = dataclasses.replace(p, elems=p.elems // 2, lanes=lanes, rows=rows,
                                    blocks=gather.grid(n, lanes, rows, sm_count))
        if "rows" in fields:
            rows = min(fields["rows"], p.lanes)
            p = dataclasses.replace(p, rows=rows, blocks=gather.grid(n, p.lanes, rows, sm_count))
        return dataclasses.replace(p, blocks=p.blocks * fields.get("grid x", 1))

    def run(table, ids, out_dtype):
        n, dim = ids.shape[0], table.shape[1]
        out = torch.empty(n, dim, dtype=out_dtype, device=table.device)
        key = (n, dim, table.dtype, out_dtype, table.data_ptr() % 16, out.data_ptr() % 16)
        if key not in plans:
            plans[key] = planned(n, dim, table, out)
        p = plans[key]
        err = fn(table.data_ptr(), ids.data_ptr(), out.data_ptr(), n, dim, table.shape[0],
                 p.code | gather.dtype_bits(table.dtype, out_dtype), p.blocks,
                 torch._C._cuda_getCurrentRawStream(table.get_device()))
        if err:
            raise RuntimeError(f"cudaError_t {err}")
        return out

    return run


# ---- SASS ---------------------------------------------------------------------

def sass_functions(lib: Path, pattern: str) -> dict:
    """Each kernel's SASS instructions in ``lib`` (``cuobjdump -sass``;
    addresses and encodings left out), for the kernels whose mangled name
    holds ``pattern``, by that name less its anonymous namespace (which
    hashes the source's path, so two builds of one source differ there)."""
    from twotowers_tpu_torch.kernels import build

    nvcc = Path(build.find_nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    kernels, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "",
                          line.split("Function :")[1].strip())
            current = kernels.setdefault(name, []) if re.search(pattern, name) else None
        elif current is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                current.append(m.group(1))
    return kernels


def opcode_mix(instructions: list) -> dict:
    """Opcode counts (with their suffixes), most common first."""
    counts = collections.Counter()
    for ins in instructions:
        m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ins)
        if m:
            counts[m.group(1)] += 1
    return dict(counts.most_common())


def ptxas_registers(log: str) -> dict:
    """Registers and spill bytes of each gather kernel in a ``ptxas -v`` log."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\S*gather_rows_kernel[^'\s]*)", line)
        if m:
            current = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.setdefault(current, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            out.setdefault(current, {})["spill_stores"] = int(m.group(1))
    return out


# ---- main ---------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of another checkout whose kernel to time too")
    parser.add_argument("--only", nargs="*", help="the variants to keep (default: all)")
    parser.add_argument("--sass-against", help="root of another checkout whose score_topk.cu "
                                               "and scatter_add_rows.cu SASS to compare")
    parser.add_argument("--host", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--root", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.host:  # a child of host_turns: the checkout at --root first on sys.path
        sys.path = [args.root] + [p for p in sys.path if Path(p or ".").resolve()
                                   != Path(__file__).resolve().parent]
        print(json.dumps(host_times()), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: gather_variants runs on the card only")
    import torch.nn.functional as F

    from twotowers_tpu_torch.kernels import build, gather

    root = Path(gather.__file__).resolve().parents[2]
    out_dir = build.BUILD_DIR.parent / "gather_variants"
    source = (build.CSRC_DIR / "gather_rows.cu").read_text()
    planned = hasattr(gather, "plan")
    todo = {}
    if planned:
        todo = {name: rewrite(name, source, rw) for name, (rw, _) in VARIANTS.items()
                if not args.only or name in args.only}
    if args.against:
        todo[AGAINST] = (Path(args.against) / "twotowers_tpu_torch" / "csrc"
                         / "gather_rows.cu").read_text()
    others = ("score_topk", "scatter_add_rows")
    if args.sass_against:
        for name in others:
            todo[f"{name} (sass against)"] = (Path(args.sass_against) / "twotowers_tpu_torch"
                                             / "csrc" / f"{name}.cu").read_text()
    start = time.perf_counter()
    build.build(["gather_rows", *(others if args.sass_against else ())])
    built = compile_sources(todo, out_dir)
    print(json.dumps({"build_s": time.perf_counter() - start}), flush=True)

    runners = {"shipped": gather.gather_rows}
    for name, (lib, _) in built.items():
        if name == AGAINST:
            runners[name] = against_runner(ctypes.CDLL(str(lib)))
        elif name in VARIANTS:
            runners[name] = plan_runner(ctypes.CDLL(str(lib)), VARIANTS[name][1])

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, (n, _, dim, _, out_dtype, _) in SHAPES.items():
        table, ids = make_inputs(shape, dev)
        want = gather.gather_rows_reference(table, ids, out_dtype)
        for name, run in runners.items():
            got = run(table, ids, out_dtype)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} at {shape}: not bit-equal to the plain version")
        order = list(runners) + list(reversed(runners))
        turns = collections.defaultdict(list)
        for name in order:
            run = runners[name]
            turns[name].append(event_ms(lambda: run(table, ids, out_dtype)))
        ids64, lib_table = ids.long(), table.to(out_dtype)
        outside = float(((ids < 0) | (ids >= table.shape[0])).float().mean())
        row = {"n": n, "d": dim, "table": str(table.dtype), "out": str(out_dtype),
               "rows": table.shape[0],
               "outside": outside,
               "ms": {name: statistics.mean(t) for name, t in turns.items()},
               "ms_turns": dict(turns),
               "device_ms_by_kernel": {name: device_ms_by_kernel(
                   lambda: run(table, ids, out_dtype)) for name, run in runners.items()},
               "plain_ms": event_ms(lambda: gather.gather_rows_reference(table, ids, out_dtype)),
               # F.embedding refuses ids outside the table: no library call there
               "library_ms": None if outside else event_ms(lambda: F.embedding(ids64,
                                                                               lib_table)),
               "bound_ms": bound_ms(table, ids, out_dtype), "bound_by": "bytes"}
        if planned:
            out = torch.empty(0, dtype=out_dtype, device=dev)
            row["plan"] = dataclasses.asdict(gather.plan(n, dim, table.dtype, out_dtype,
                                                         table.data_ptr(), out.data_ptr(),
                                                         sm_count))
        print(json.dumps({"shape": shape, **row}), flush=True)
        del table, ids, ids64, lib_table, want
        torch.cuda.empty_cache()
    print(json.dumps({"bit_equal": "every runner at every shape, to gather_rows_reference",
                      "runners": list(runners)}), flush=True)

    theirs = [Path(args.against)] if args.against else []
    for i, row in enumerate(host_turns([root, *theirs, *theirs, root][:4 if theirs else 2])):
        print(json.dumps({"host_us": row, "turn": i}), flush=True)

    libs = {"shipped": (build.library_path("gather_rows"),
                        (build.BUILD_DIR / "gather_rows.log").read_text())}
    if AGAINST in built:
        libs[AGAINST] = built[AGAINST]
    for name, (lib, log) in libs.items():
        kernels = sass_functions(lib, r"gather_rows_kernel\w*")
        print(json.dumps({"sass": name, "registers": ptxas_registers(log),
                          "kernels": {k: {"instructions": len(v), "opcodes": opcode_mix(v)}
                                      for k, v in kernels.items()}}), flush=True)
    if args.sass_against:
        equal = {}
        for name in others:
            ours = sass_functions(build.library_path(name), name.split("_")[0])
            theirs_sass = sass_functions(built[f"{name} (sass against)"][0],
                                         name.split("_")[0])
            equal[name] = {k: ours.get(k) == theirs_sass.get(k)
                           for k in sorted(set(ours) | set(theirs_sass))}
        print(json.dumps({"sass_equal_to_against": equal}), flush=True)
        if not all(all(v.values()) for v in equal.values()):
            raise AssertionError("a score_topk or scatter_add_rows kernel's SASS changed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
