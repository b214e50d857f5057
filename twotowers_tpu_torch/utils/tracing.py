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

Work whose cost is on the card has spans on the card's clock too:
``span(name, device=x, ...)``, with ``x`` the tensor the work is on, also
records a pair of CUDA events on the current stream around the span; on a
CPU tensor it records the span's host time instead. The expert layer
(``models/moe.py``) has ``moe.route``, ``moe.dispatch``, ``moe.experts``
and ``moe.combine`` so, and the latent attention ``mla``.
``device_spans()`` waits for the card once and gives each such span with
its milliseconds; ``device_ms()`` sums them by name. ``count(name,
value)`` adds a device tensor to the counter ``name`` with no host read
(``moe.assignments``); ``counters()`` reads their totals once,
``counter_values()`` their elementwise sums (the assignments by held
expert). Like spans, device spans and counters record only while a
profiler runs, and ``clear()`` empties them.
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


class DeviceSpan(NamedTuple):
    """A span of work on the card: its host interval (``perf_counter_ns``,
    the clock of ``Span``), attributes, and the milliseconds between its
    CUDA events (its host time for work on the CPU)."""

    name: str
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]
    ms: float


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
                 "range", "device", "events")

    def __init__(self, recorder: "Recorder", name: str, attrs: Dict[str, Any],
                 device: Optional[torch.Tensor] = None):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self.device = device is not None
        self.events = None
        if self.device and device.is_cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

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
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        end_ns = time.perf_counter_ns()
        self.recorder._stack().pop()
        attrs = {k: _plain(v) for k, v in self.attrs.items()}
        self.recorder._spans.append(Span(
            self.name, self.start_ns, end_ns, self.span_id, self.parent_id, self.root_id,
            threading.get_ident(), attrs))
        if self.device:
            self.recorder._device.append(
                (self.name, self.start_ns, end_ns, attrs,
                 self.events if self.events is not None else (end_ns - self.start_ns) * 1e-6))


class Recorder:
    """A bounded store of finished spans, with a parent stack per thread."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        # (name, start_ns, end_ns, attrs, (start, end) CUDA events or host ms)
        self._device: collections.deque = collections.deque(maxlen=capacity)
        self._counters: Dict[str, torch.Tensor] = {}
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

    def device_spans(self) -> List[DeviceSpan]:
        """The finished device spans held, oldest first, with their
        milliseconds; waits for the card once."""
        held = list(self._device)
        if any(not isinstance(t, float) for *_, t in held):
            torch.cuda.synchronize()
        return [DeviceSpan(name, start, end, attrs,
                           t if isinstance(t, float) else t[0].elapsed_time(t[1]))
                for name, start, end, attrs, t in held]

    def count(self, name: str, value: torch.Tensor) -> None:
        held = self._counters.get(name)
        value = value.detach().double()
        self._counters[name] = value if held is None else held + value

    def counter_values(self) -> Dict[str, torch.Tensor]:
        """Each counter's elementwise sum, copied to the host."""
        return {name: value.cpu() for name, value in self._counters.items()}

    def counters(self) -> Dict[str, float]:
        """Each counter's total."""
        return {name: float(value.sum()) for name, value in self.counter_values().items()}

    def clear(self) -> None:
        self._spans.clear()
        self._device.clear()
        self._counters.clear()


RECORDER = Recorder()


def span(name: str, device: Optional[torch.Tensor] = None, **attrs: Any):
    """A context that records the span ``name`` into ``RECORDER`` while a
    profiler runs on this thread, else ``NO_SPAN``. With ``device``, the
    tensor the work is on, it is also a device span: CUDA events on the
    current stream, or host time where the tensor is on the CPU."""
    return _OpenSpan(RECORDER, name, attrs, device) if _profiler_enabled() else NO_SPAN


def count(name: str, value: torch.Tensor) -> None:
    """Add ``value`` elementwise to the counter ``name`` on its device (each
    call the same shape), while a profiler runs on this thread; no host
    read."""
    if _profiler_enabled():
        RECORDER.count(name, value)


def spans() -> List[Span]:
    return RECORDER.spans()


def device_spans() -> List[DeviceSpan]:
    return RECORDER.device_spans()


def device_ms() -> Dict[str, float]:
    """Milliseconds of the device spans held, summed by name."""
    out: Dict[str, float] = collections.defaultdict(float)
    for s in RECORDER.device_spans():
        out[s.name] += s.ms
    return dict(out)


def counters() -> Dict[str, float]:
    return RECORDER.counters()


def counter_values() -> Dict[str, torch.Tensor]:
    return RECORDER.counter_values()


def clear() -> None:
    RECORDER.clear()
