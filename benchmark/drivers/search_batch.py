"""One client in a closed loop calls ``TwoTowerSearch.search_batch`` on
batches of fresh queries.

Set-up: the corpus and queries from the seed, the char tokenizer fit on
the first documents, weights from the seed, ``index_documents`` over the
whole corpus, then ``warm_calls`` batches (the shapes of every later
call). Window: batch after batch for ``--seconds``; each call timed from
call to return. Check: a sample of the window's answered queries (those
the seed marks as kept), against the plain reference over every document.

End-to-end: ``search_qps`` (queries answered over the window) and
``batch_p95_ms`` (95th percentile of all calls). Traced run: each call's
encode (tokenize + tower, synchronised) is timed by a wrapper
(``spans["encode"]``), and each ``score_topk`` call made while the
profiler runs is recorded with its shapes (``calls["score_topk"]``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import serving, weights
from ..measure import describe, percentile


def run(run) -> None:
    import torch

    from twotowers_tpu_torch.convert import params_from_jax
    from twotowers_tpu_torch.index import two_tower
    from twotowers_tpu_torch.kernels import topk
    from twotowers_tpu_torch.ops import topk_score

    cfg, traffic = run.cell.config, run.cell.traffic
    batch, k = int(traffic["batch"]), int(traffic["top_k"])
    s = serving.setup(run)
    model = params_from_jax(weights.to_numpy(s.tree), s.spec)
    search = two_tower.TwoTowerSearch(model, s.spec, s.tokenizer,
                                      max_length=serving.max_len(run),
                                      encode_batch_size=int(cfg["encode_batch_size"]),
                                      device=run.device)
    search.index_documents(s.doc_strings)
    n_docs = len(s.doc_strings)
    run.mark("index_documents")

    def batch_of(call: int):
        return [s.query(call * batch + j) for j in range(batch)]

    warm = int(traffic.get("warm_calls", 3))
    for call in range(warm):
        search.search_batch(batch_of(call), k)
    restore = _instrument(run, search, two_tower, torch) if run.trace else (lambda: None)
    launches, ring, torch_route = topk.LAUNCHES, topk.RING_LAUNCHES, topk_score.TORCH_ROUTE_CALLS
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    sync()
    run.mark("warm calls")

    keep = serving.kept(run)
    latencies, answers = [], []  # answers: (pool index, answer) of the kept queries
    label = (lambda: torch.profiler.record_function("bench.search_batch")) if run.trace \
        else contextlib.nullcontext
    run.tracer.open_window()
    start = time.perf_counter()
    run.setup_s = start - run.t0
    call = warm
    while time.perf_counter() - start < run.seconds:
        queries = batch_of(call)
        t = time.perf_counter()
        with label():
            answer = search.search_batch(queries, k)
        latencies.append(time.perf_counter() - t)
        first = call * batch
        for j in np.flatnonzero(keep[(first + np.arange(batch)) % len(keep)]):
            answers.append((first + int(j), answer[j]))
        del answer
        call += 1
        run.tracer.poll()
    run.window_s = time.perf_counter() - start
    run.tracer.stop()
    restore()

    n_calls = len(latencies)
    run.attempted = n_calls * batch
    run.e2e["setup_s"] = run.setup_s
    run.e2e["search_qps"] = run.attempted / run.window_s
    run.e2e["batch_p95_ms"] = percentile(latencies, 95) * 1e3
    run.work.update(queries=run.attempted, window_s=run.window_s, n_docs=n_docs,
                    traced_queries=sum(c[2] for c in run.calls.get("score_topk", [])),
                    dim=s.spec.output_dim, emb=s.spec.embedding.embedding_dim,
                    hid=s.spec.tower.hidden_dim)
    run.note(f"setup_s {run.setup_s!r}; window_s {run.window_s!r}; calls {n_calls}; "
             f"queries {run.attempted}; search_qps {run.e2e['search_qps']!r}")
    run.note(describe("search_batch latency", latencies))
    run.note(f"kernel #1 launches {topk.LAUNCHES - launches} (ring pass "
             f"{topk.RING_LAUNCHES - ring}); torch-route calls {topk_score.TORCH_ROUTE_CALLS - torch_route}")
    if run.trace and run.spans.get("encode"):
        run.note(describe("encode (synchronised)", run.spans["encode"]))
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    del search, model
    serving.free_device_memory()
    _check(run, s, answers, k)


def _instrument(run, search, two_tower, torch):
    """Time each encode, synchronised, and record each ``score_topk`` call
    made while the profiler runs (the traced run only). Returns the undo."""
    encode, score = search._encode_texts_device, two_tower.score_topk
    spans = run.spans.setdefault("encode", [])
    calls = run.calls.setdefault("score_topk", [])

    def timed_encode(texts, tower):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.encode"):
            out = encode(texts, tower)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
        spans.append(time.perf_counter() - t)
        return out

    def recorded_score(docs, queries, k, n_docs):
        if run.tracer.active:
            calls.append((int(n_docs), int(docs.shape[1]), int(queries.shape[0]), int(k),
                          str(docs.dtype).replace("torch.", "")))
        return score(docs, queries, k, n_docs)

    search._encode_texts_device = timed_encode
    two_tower.score_topk = recorded_score

    def restore():
        del search._encode_texts_device
        two_tower.score_topk = score

    return restore


def _check(run, s, answers, k: int) -> None:
    index = {text: i for i, text in enumerate(s.doc_strings)}
    picked = serving.sample(run, len(answers))
    got = [[(index.get(text, -1), score) for text, score in answers[pos][1]] for pos in picked]
    ids, scores, bad = serving.answers_to_arrays(got, k)
    gaps = serving.judge(run, s, [answers[pos][0] for pos in picked], ids, scores,
                         renormalize=False)
    run.note(f"checked {len(picked)} of {len(answers)} kept answers of "
             f"{run.attempted} answered queries")
    run.check("rank_gap", gaps["rank_gap"])
    run.check("score_gap", gaps["score_gap"])
    run.check("bad_answers", bad)
