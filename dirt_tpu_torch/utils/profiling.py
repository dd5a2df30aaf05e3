"""Profiling and tracing of the port (PyTorch port of
dirt_tpu/utils/profiling.py).

  * ``trace(logdir)``: a torch.profiler trace of the enclosed computation
    (host activity, and the card's where there is one), written to
    `logdir` as Chrome trace JSON (Perfetto, chrome://tracing), with the
    port's own spans of that session merged in.
  * ``span(name, tensor)`` and ``count(name, value)``: the port's stage
    spans and schedule counters, called at the stage boundaries of the
    blocks path (rasterise_ops, forward_blocks, grad_blocks).  They record
    exactly while a torch.profiler session is active; otherwise a span is
    one shared null context after a single flag read, and a count returns
    at once, making no event, tensor or record.
  * ``records()``: the recorded spans, oldest first;
  * ``recording()``: whether they record now.

A span records its name, its parent (the span open on the same thread at
its entry), the entry call it belongs to (the id of its outermost span),
its host start and end on time.time_ns() (the Unix clock that the
profiler's Chrome trace stamps its events on, after its
baseTimeNanoseconds) and, where `tensor` is on a CUDA card, a pair of
timing events (torch.Event, on the tensor's device) recorded on the
current stream at entry and exit, taken from a pool: their
elapsed time is the stream's time in the stage, its device work plus any
wait for the host inside it.  A counter keeps a reference to a tensor the
code already made, or to a function that makes one from such tensors, and
launches nothing; the function is called and the sum taken when the
records are read, outside the steps.  Spans are not record_function
ranges, so a profile still places each device operation in the caller's
own ranges.
Records go to a buffer of CAPACITY; past it the oldest are dropped.
"""

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 16
SPAN_CATEGORY = "dirt_span"
SPAN_PID = 1 << 30          # the spans' own process track in a trace
_NULL = contextlib.nullcontext()


class Record:
    """One span.  `stream_ms` is None where the stage ran on no card;
    `counters` maps a counter's name to its sum once the records are
    read."""
    __slots__ = ("name", "id", "parent", "entry", "thread", "start_ns",
                 "end_ns", "stream_ms", "counters", "_events", "_pending")

    def __init__(self, name, id, parent=None, entry=None, thread=0):
        self.name, self.id, self.parent = name, id, parent
        self.entry, self.thread = entry, thread
        self.start_ns = self.end_ns = self.stream_ms = self._events = None
        self.counters = {}
        self._pending = []


class _Recorder:
    """The spans' buffer, the per-thread stacks of open spans and the
    pools of timing events, by device."""

    def __init__(self):
        self.buffer = collections.deque(maxlen=CAPACITY)
        self.ids = itertools.count()
        self.local = threading.local()
        self.events = collections.defaultdict(list)
        self.lock = threading.Lock()

    def stack(self):
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def event(self, device):
        pool = self.events[device]
        return pool.pop() if pool else torch.Event(device,
                                                   enable_timing=True)

    def resolve(self, record):
        """Turns a finished record's events and counted tensors into
        numbers (this waits for the card), and frees the events."""
        if record._events is not None:
            start, end = record._events
            end.synchronize()
            record.stream_ms = start.elapsed_time(end)
            record._events = None
            self.events[start.device] += (start, end)
        for name, value in record._pending:
            tensor = value() if callable(value) else value
            record.counters[name] = (record.counters.get(name, 0)
                                     + int(tensor.sum()))
        record._pending.clear()


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "device", "record")

    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        rid = next(_RECORDER.ids)
        record = self.record = Record(
            name=self.name, id=rid, parent=parent.id if parent else None,
            entry=parent.entry if parent else rid,
            thread=threading.get_ident())
        stack.append(record)
        _RECORDER.buffer.append(record)
        if self.device is not None:
            record._events = (_RECORDER.event(self.device),
                              _RECORDER.event(self.device))
            record._events[0].record()
        record.start_ns = time.time_ns()
        return record

    def __exit__(self, *exc):
        record = self.record
        record.end_ns = time.time_ns()
        if record._events is not None:
            record._events[1].record()
        _RECORDER.stack().pop()
        return False


def span(name, tensor):
    """A context that records the stage `name` while a torch.profiler
    session is active; `tensor`, one of the stage's inputs, says whether
    its stream is timed (on a CUDA card)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, tensor.device if tensor.is_cuda else None)


def recording():
    """True while a torch.profiler session is active: spans and counters
    record, and a stage may make the tensor a counter reads."""
    return _profiler._is_profiler_enabled


def count(name, value):
    """Adds the sum of `value`, a tensor or a function of no arguments that
    returns one, taken (and the function called) when the records are
    read, to the counter `name` of the innermost span open on this thread,
    while a torch.profiler session is active and a span is open."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _RECORDER.stack()
    if stack:
        stack[-1]._pending.append((name, value))


def records():
    """The finished spans in the buffer, oldest first, their stream times
    and counters read (this waits for the card)."""
    with _RECORDER.lock:
        done = [r for r in list(_RECORDER.buffer) if r.end_ns is not None]
        for record in done:
            _RECORDER.resolve(record)
    return done


def chrome_events(spans, base_ns):
    """The spans as Chrome trace "X" events on their own process track,
    on a trace's clock (microseconds after `base_ns`), with a process-name
    event first."""
    names = {r.id: r.name for r in spans}
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
               "args": {"name": "dirt_tpu_torch spans"}}]
    for r in spans:
        args = {"id": r.id, "entry": r.entry, "parent": names.get(r.parent),
                "stream_ms": r.stream_ms, **r.counters}
        events.append({"ph": "X", "cat": SPAN_CATEGORY, "name": r.name,
                       "pid": SPAN_PID, "tid": r.thread,
                       "ts": (r.start_ns - base_ns) * 1e-3,
                       "dur": (r.end_ns - r.start_ns) * 1e-3, "args": args})
    return events


@contextlib.contextmanager
def trace(logdir):
    """Captures a torch.profiler trace of the enclosed computation (host
    activity, and the card's where there is one) and writes it to
    `logdir` as a Chrome trace JSON file, the port's spans of the session
    merged in (category SPAN_CATEGORY).  Yields the profiler.

    Example:
        with profiling.trace('/tmp/dirt_trace'):
            pixels = dirt_tpu_torch.rasterise(...)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = next(_RECORDER.ids)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, raw = tempfile.mkstemp(suffix=".json", dir=logdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        with open(raw) as f:
            chrome = json.load(f)
    finally:
        os.unlink(raw)
    spans = [r for r in records() if r.id > first]
    chrome["traceEvents"] += chrome_events(
        spans, chrome["baseTimeNanoseconds"])
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with open(path, "w") as f:
        json.dump(chrome, f)
