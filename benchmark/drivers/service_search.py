"""Client threads in a closed loop each call ``RetrievalService.search``,
as the FastAPI app's sync ``/search`` handler does in its threadpool.

Set-up: the corpus and queries from the seed, the tokenizer fit and the
weights from the seed written as a checkpoint (under ``TMPDIR``, removed
once loaded) and loaded by ``ModelRuntime``; the ``VectorCollection`` is
filled by one ``add`` with ``ModelRuntime.encode``'s vectors of every
document; ``warm_queries`` searches build the store's device copy. Window:
``clients`` threads, each taking the pool's next query when its last one
returns, for ``--seconds``; each request timed from call to return. Check:
a sample of the answered requests (those the seed marks as kept), against
the plain reference (with the store's normalisation).

End-to-end: ``search_qps`` (requests answered over the window, which ends
when the last one returns) and ``search_p95_ms`` (95th percentile of all).
A request that raises counts as failed.
"""

from __future__ import annotations

import contextlib
import itertools
import shutil
import tempfile
import threading
import time
import traceback

from .. import serving, weights
from ..measure import describe, percentile


def run(run) -> None:
    import torch

    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.ops import topk_score
    from twotowers_tpu_torch.serve import store as store_mod
    from twotowers_tpu_torch.serve.app import ModelRuntime
    from twotowers_tpu_torch.serve.service import RetrievalService
    from twotowers_tpu_torch.serve.store import VectorCollection
    from twotowers_tpu_torch.train.checkpoint import save_params

    cfg, traffic = run.cell.config, run.cell.traffic
    k, clients = int(traffic["top_k"]), int(traffic["clients"])
    s = serving.setup(run)
    ckpt = tempfile.mkdtemp(prefix="benchmark-checkpoint-")
    try:
        save_params(ckpt, weights.to_numpy(s.tree), s.tokenizer.state_dict(), cfg["model"])
        runtime = ModelRuntime(ckpt, batch_size=int(cfg["encode_batch_size"]),
                               device=run.device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    run.mark("checkpoint, ModelRuntime")
    service = RetrievalService(model=runtime,
                               collection=VectorCollection("documents", device=run.device),
                               device=run.device)
    vectors = runtime.encode(s.doc_strings, "document")
    run.mark("ModelRuntime.encode")
    service.collection.add([f"d{i}" for i in range(len(s.doc_strings))], vectors,
                           s.doc_strings)
    del vectors
    n_docs = service.collection.count()
    run.mark("VectorCollection.add")

    warm = int(traffic.get("warm_queries", 16))
    for i in range(warm):
        service.search(s.query(i), k)
    restore = _instrument(run, store_mod) if run.trace else (lambda: None)
    launches, torch_route = topk.LAUNCHES, topk_score.TORCH_ROUTE_CALLS
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    run.mark("warm searches")

    keep = serving.kept(run)
    per_thread = [([], [], []) for _ in range(clients)]  # latencies, ends, kept answers
    errors = []
    order = itertools.count(warm)
    label = (lambda: torch.profiler.record_function("bench.search")) if run.trace \
        else contextlib.nullcontext

    def client(deadline: float, latencies, ends, answers) -> None:
        while time.perf_counter() < deadline:
            i = next(order)
            t = time.perf_counter()
            try:
                with label():
                    response = service.search(s.query(i), k)
            except Exception:  # a failed request is counted, not fatal
                errors.append(traceback.format_exc())
                response = None
            end = time.perf_counter()
            latencies.append(end - t)
            ends.append(end)
            if response is not None and keep[i % len(keep)]:
                answers.append((i, response))

    run.tracer.open_window()
    start = time.perf_counter()
    run.setup_s = start - run.t0
    threads = [threading.Thread(target=client, args=(start + run.seconds, *lists), daemon=True)
               for lists in per_thread]
    for thread in threads:
        thread.start()
    while any(thread.is_alive() for thread in threads):
        run.tracer.poll()
        time.sleep(0.02)
    for thread in threads:
        thread.join()
    run.tracer.stop()
    restore()
    run.window_s = max(max(ends) for _, ends, _ in per_thread if ends) - start

    latencies = [lat for lats, _, _ in per_thread for lat in lats]
    answered = sorted((a for _, _, kept in per_thread for a in kept), key=lambda a: a[0])
    run.attempted, run.failed = len(latencies), len(errors)
    run.e2e["setup_s"] = run.setup_s
    run.e2e["search_qps"] = (run.attempted - run.failed) / run.window_s
    run.e2e["search_p95_ms"] = percentile(latencies, 95) * 1e3
    run.work.update(queries=run.attempted - run.failed, window_s=run.window_s, n_docs=n_docs,
                    traced_queries=len(run.calls.get("score_topk", [])),
                    dim=s.spec.output_dim, emb=s.spec.embedding.embedding_dim,
                    hid=s.spec.tower.hidden_dim)
    run.note(f"setup_s {run.setup_s!r}; window_s {run.window_s!r}; requests "
             f"{run.attempted}; failed {len(errors)}; search_qps {run.e2e['search_qps']!r}")
    run.note(describe("search latency", latencies))
    run.note(f"kernel #1 launches {topk.LAUNCHES - launches}; torch-route calls "
             f"{topk_score.TORCH_ROUTE_CALLS - torch_route}")
    if errors:
        run.note(f"first failed request:\n{errors[0]}")
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    del service, runtime
    serving.free_device_memory()
    _check(run, s, answered, k)


def _instrument(run, store_mod):
    """Record each ``score_topk`` call made while the profiler runs (the
    traced run only). Returns the undo."""
    score = store_mod.score_topk
    calls = run.calls.setdefault("score_topk", [])
    lock = threading.Lock()

    def recorded_score(docs, queries, k, n_docs):
        if run.tracer.active:
            with lock:
                calls.append((int(n_docs), int(docs.shape[1]), int(queries.shape[0]), int(k),
                              str(docs.dtype).replace("torch.", "")))
        return score(docs, queries, k, n_docs)

    store_mod.score_topk = recorded_score

    def restore():
        store_mod.score_topk = score

    return restore


def _check(run, s, answered, k: int) -> None:
    picked = serving.sample(run, len(answered))
    got, bad_text = [], 0
    for pos in picked:
        _, response = answered[pos]
        answer = []
        for result in response["results"]:
            doc = result["id"]
            i = int(doc[1:]) if doc[:1] == "d" and doc[1:].isdigit() else -1
            if not 0 <= i < len(s.doc_strings) or result["document"] != s.doc_strings[i]:
                bad_text += 1
                i = -1
            answer.append((i, 1.0 - result["distance"]))
        got.append(answer)
    ids, scores, bad = serving.answers_to_arrays(got, k)
    query_idx = [answered[pos][0] for pos in picked]
    gaps = serving.judge(run, s, query_idx, ids, scores, renormalize=True)
    run.note(f"checked {len(picked)} of {len(answered)} kept answers of "
             f"{run.attempted - run.failed} answered requests")
    run.check("rank_gap", gaps["rank_gap"])
    run.check("score_gap", gaps["score_gap"])
    run.check("bad_answers", bad + bad_text)
    run.check("failed_requests", run.failed)
