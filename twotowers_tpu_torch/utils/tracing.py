"""Spans of the program's own steps, recorded while ``torch.profiler`` runs.

A span is a named interval of host time at a layer boundary: the batch
search (``search.batch``, ``encode``, ``encode.tokenize``, ``encode.tower``,
``score_topk``, ``readback``, ``search.results``) and the training epoch
(``train.epoch``; ``train.batch``, ``train.step`` and ``train.drain`` a
step). ``span(name, **attrs)`` records one only while a profiler session
is active on the calling thread (``torch.autograd._profiler_enabled()``);
otherwise it returns one shared no-op context, so a span costs the program
a check. While recording, a span also opens
``torch.profiler.record_function(name)``: it is then a host range in the
profiler's own trace, on the clock of the kernels it launched (the Chrome
trace of ``train_model``'s ``profile: {trace_dir}``, or any caller's
session).

A recorded span keeps its name, start and end (``time.perf_counter_ns``),
its id, its parent's id and its root's id (one id for every span of one
``search_batch`` call or one epoch), the thread it ran on, and its
attributes (counts, and names such as a dtype or a route). The parent stack
is kept per thread. Spans go into a bounded in-memory deque that
``spans()`` reads and ``clear()`` empties; nothing is written to disk.

Span names never start with ``bench.`` (a benchmark's own ranges) and never
equal a kernel's name: trace readers tell the profiler's device copies of
these ranges from kernels by that.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    root_id: int
    thread: int
    attrs: Dict[str, Any]

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _NoSpan:
    """What ``span`` returns while no profiler runs: enters and exits."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


def _plain(value: Any) -> Any:
    return str(value).removeprefix("torch.") if isinstance(value, torch.dtype) else value


class _OpenSpan:
    __slots__ = ("recorder", "name", "attrs", "span_id", "parent_id", "root_id", "start_ns",
                 "range")

    def __init__(self, recorder: "Recorder", name: str, attrs: Dict[str, Any]):
        self.recorder, self.name, self.attrs = recorder, name, attrs

    def __enter__(self):
        stack = self.recorder._stack()
        self.span_id = next(self.recorder._ids)
        if stack:
            self.parent_id, self.root_id = stack[-1].span_id, stack[-1].root_id
        else:
            self.parent_id, self.root_id = None, self.span_id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.range.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        self.recorder._stack().pop()
        self.recorder._spans.append(Span(
            self.name, self.start_ns, end_ns, self.span_id, self.parent_id, self.root_id,
            threading.get_ident(), {k: _plain(v) for k, v in self.attrs.items()}))


class Recorder:
    """A bounded store of finished spans, with a parent stack per thread."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[_OpenSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def spans(self) -> List[Span]:
        """The finished spans held, oldest first."""
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()


RECORDER = Recorder()


def span(name: str, **attrs: Any):
    """A context that records the span ``name`` into ``RECORDER`` while a
    profiler runs on this thread, else ``NO_SPAN``."""
    return _OpenSpan(RECORDER, name, attrs) if _profiler_enabled() else NO_SPAN


def spans() -> List[Span]:
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()
