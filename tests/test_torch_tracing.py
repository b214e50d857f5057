"""The port's spans (``utils/tracing.py``): recorded only while a profiler
runs, in the batch search's and the training epoch's tree, on the
profiler's own clock, with a parent stack per thread and a bounded store.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from twotowers_tpu_torch.index.two_tower import TwoTowerSearch
from twotowers_tpu_torch.models.losses import build_loss
from twotowers_tpu_torch.models.towers import TwoTower, spec_from_config
from twotowers_tpu_torch.tokenizers import build_tokenizer
from twotowers_tpu_torch.train.loop import trace_to, train_epoch
from twotowers_tpu_torch.train.optim import build_optimizer
from twotowers_tpu_torch.train.pipeline import Pipeline
from twotowers_tpu_torch.train.step import create_train_state, make_train_step
from twotowers_tpu_torch.utils import tracing

CONFIG = {
    "tokeniser": {"type": "char", "max_len": 16},
    "embedding": {"type": "lookup", "embedding_dim": 8},
    "encoder": {"arch": "mean", "hidden_dim": 12, "tied_weights": False},
    "optimizer": {"type": "adamw", "lr": 1e-3},
}
SEARCH_SPANS = {"search.batch", "encode", "encode.tokenize", "encode.tower", "score_topk",
                "readback", "search.results"}
TRAIN_SPANS = {"train.epoch", "train.batch", "train.step", "train.drain"}


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("abcdefghij "))
    return ["".join(rng.choice(alphabet, size=rng.integers(4, 14))) for _ in range(n)]


@pytest.fixture(scope="module")
def search():
    docs = _texts(30)
    tok = build_tokenizer("char").fit(docs)
    spec = spec_from_config(CONFIG, tok.vocab_size)
    index = TwoTowerSearch(TwoTower(spec, generator=torch.Generator().manual_seed(0)), spec,
                           tok, max_length=16, encode_batch_size=2, device="cpu")
    index.index_documents(docs)
    return index


class _Pairs:
    def __init__(self, n, seq=16, vocab=30, seed=0):
        rng = np.random.default_rng(seed)
        self.queries = rng.integers(1, vocab, size=(n, seq)).astype(np.int32)
        self.positives = rng.integers(1, vocab, size=(n, seq)).astype(np.int32)

    def arrays(self):
        return self.queries, self.positives, None

    def __len__(self):
        return len(self.queries)


def _epoch(steps, batch=4):
    spec = spec_from_config(CONFIG, 30)
    model = TwoTower(spec, generator=torch.Generator().manual_seed(0))
    optimizer = build_optimizer(CONFIG)
    loss_def = build_loss("in_batch", temperature=0.1)
    pipeline = Pipeline(None, _Pairs(steps * batch - 1), spec, model, optimizer, loss_def, 16)
    state = create_train_state(model, optimizer, seed=0)
    return train_epoch(make_train_step(loss_def, optimizer), state, pipeline, batch, epoch=1,
                       seed=0)


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_without_a_profiler(search):
    assert tracing.span("x", n=1) is tracing.NO_SPAN
    assert tracing.span("y") is tracing.span("z")
    with tracing.span("x") as s:
        assert s is tracing.NO_SPAN
    search.search_batch(["abc", "de f"], top_k=3)
    _epoch(steps=2)
    assert tracing.spans() == []


def test_search_batch_records_its_tree_on_the_profilers_clock(search):
    queries = ["abc", "de f", "ghij", "a b c", "jj"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search.search_batch(queries[:2], top_k=3)  # the profiler's first ranges start cold
        got = search.search_batch(queries, top_k=3)
    assert len(got) == 5 and all(len(row) == 3 for row in got)
    all_spans = tracing.spans()
    assert [s.name for s in all_spans].count("search.batch") == 2
    assert len({s.root_id for s in all_spans}) == 2
    spans = [s for s in all_spans if s.root_id == all_spans[-1].root_id]
    by = _by_name(spans)
    assert set(by) == SEARCH_SPANS and all(len(v) == 1 for v in by.values())
    one = {name: v[0] for name, v in by.items()}
    root = one["search.batch"]
    assert root.parent_id is None and {s.root_id for s in spans} == {root.span_id}
    parents = {"encode": "search.batch", "encode.tokenize": "encode", "encode.tower": "encode",
               "score_topk": "search.batch", "readback": "search.batch",
               "search.results": "search.batch"}
    for child, parent in parents.items():
        c, p = one[child], one[parent]
        assert c.parent_id == p.span_id, child
        assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns, child
    assert len({s.span_id for s in spans}) == len(spans)
    assert len({s.thread for s in spans}) == 1
    assert root.attrs == {"queries": 5, "k": 3}
    assert one["encode"].attrs == {"texts": 5, "chunks": 3}
    assert one["score_topk"].attrs == {"n_docs": 30, "dim": 12, "queries": 5, "k": 3,
                                       "dtype": "float32", "route": "plain"}
    # the order of the steps: encode, then score + top-k, readback, results
    order = sorted(["encode", "score_topk", "readback", "search.results"],
                   key=lambda n: one[n].start_ns)
    assert order == ["encode", "score_topk", "readback", "search.results"]

    ranges = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.device_type == DeviceType.CPU and e.name in SEARCH_SPANS:
            ranges.setdefault(e.name, []).append(e.time_range.elapsed_us())
    assert {n: len(v) for n, v in ranges.items()} == {n: 2 for n in SEARCH_SPANS}
    for name, (_, profiled) in ranges.items():
        recorded = one[name].duration_ns / 1e3
        assert abs(profiled - recorded) <= max(0.1 * recorded, 50.0), name


def test_train_epoch_records_an_epoch_and_three_spans_a_step():
    with profile(activities=[ProfilerActivity.CPU]):
        _, metrics = _epoch(steps=3)
    assert np.isfinite(metrics["loss"]) and "avg_batch_time" not in metrics
    by = _by_name(tracing.spans())
    assert set(by) == TRAIN_SPANS
    assert {n: len(v) for n, v in by.items()} == {"train.epoch": 1, "train.batch": 3,
                                                    "train.step": 3, "train.drain": 3}
    (epoch,) = by["train.epoch"]
    assert epoch.attrs == {"epoch": 1} and epoch.parent_id is None
    for s in tracing.spans():
        assert s.root_id == epoch.span_id
        if s is not epoch:
            assert s.parent_id == epoch.span_id
            assert epoch.start_ns <= s.start_ns <= s.end_ns <= epoch.end_ns
    assert [s.attrs for s in by["train.step"]] == [
        {"step": 0, "rows": 4}, {"step": 1, "rows": 4}, {"step": 2, "rows": 3}]
    # a step's batch, then its dispatch, then the previous step's read
    starts = sorted((s.start_ns, s.name) for s in tracing.spans() if s is not epoch)
    assert [n for _, n in starts] == ["train.batch", "train.step"] + \
        ["train.batch", "train.step", "train.drain"] * 2 + ["train.drain"]


def test_the_chrome_trace_of_profile_shows_the_epochs_spans(tmp_path):
    """``profile: {trace_dir}`` writes its Chrome trace through ``trace_to``."""
    with trace_to(str(tmp_path), torch.device("cpu")):
        _epoch(steps=2)
    (trace,) = tmp_path.glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(trace.read_text())["traceEvents"]]
    assert {n: names.count(n) for n in TRAIN_SPANS} == {
        "train.epoch": 1, "train.batch": 2, "train.step": 2, "train.drain": 2}


def test_two_threads_keep_their_own_parent_stacks(monkeypatch):
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    both_open = threading.Barrier(2, timeout=10)
    done = threading.Barrier(2, timeout=10)

    def work(name):
        with tracing.span(name):
            both_open.wait()
            with tracing.span(name + ".child"):
                done.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    one = {s.name: s for s in tracing.spans()}
    assert set(one) == {"a", "b", "a.child", "b.child"}
    for name in ("a", "b"):
        parent, child = one[name], one[name + ".child"]
        assert parent.parent_id is None and parent.root_id == parent.span_id
        assert child.parent_id == parent.span_id and child.root_id == parent.span_id
        assert child.thread == parent.thread
    assert one["a"].thread != one["b"].thread


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: True)
    assert tracing.RECORDER._spans.maxlen == tracing.CAPACITY == 65_536
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder(capacity=4))
    for i in range(10):
        with tracing.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in tracing.spans()] == [6, 7, 8, 9]
    tracing.clear()
    assert tracing.spans() == []
