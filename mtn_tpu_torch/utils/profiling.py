"""Profiling and debug hooks (``mtn_tpu/utils/profiling.py``).

- :func:`trace` is a ``torch.profiler`` context (host and, on a GPU,
  device activity) that records the first :data:`TRACE_STEPS` steps and
  writes them as a Chrome trace under its directory, also when the body
  raises; for ``None`` it does nothing;
- :func:`step_annotation` names a train or eval step in the trace and
  advances its window;
- :func:`check_finite` is the trainer's finiteness check under
  ``Trainer(nan_checks=True)`` (``--nan-checks``; the contract of JAX's
  process-wide ``jax_debug_nans``): a step whose loss or any gradient is
  not finite raises ``FloatingPointError`` naming the step, at the cost
  of one host sync per step;
- :func:`checkify_fn` wraps a function so that a non-finite tensor in its
  output raises;
- :func:`recording` turns on the span recorder: host spans
  (:func:`span`) and device spans (:func:`device_span`,
  :func:`driven_span`) on one clock, kept in memory and handed back as a
  :class:`Recording`, which writes them as a Chrome trace.

Spans. A host span records its name, its start and end on
``time.perf_counter_ns()``, its parent (the innermost span open on its
thread, or one given), its thread, its batch (the index of the turn
batch it serves; a child inherits its parent's) and counters attached to
it. A device span is a pair of CUDA timing events on the current stream,
recorded where the work is enqueued and resolved after the work has
been fetched, so recording one adds no host read; the stream runs its
work between them back to back (a graphed batch). Where the host drives
the work kernel by kernel (an eager batch, a capture's warm-up), the
card idles inside such a span while the host launches or reads, so a
driven span also runs the profiler's CUDA activity (CUPTI) over its
block and keeps its kernels: each kernel's start and end, placed on the
span's clock so that the last kernel of the span's stream ends at the
span's end event (which that stream reaches right after it); copies to
and from the host are left out. Inside another profiler's block a
driven span keeps no kernels. The tracer's own host spans are named
``profiler.*``: ``profiler.start`` and ``profiler.stop`` around a driven
span (stopping waits for the card). Each recording reads one clock:
:meth:`Recording.anchor` records an event, waits for it and reads
``perf_counter_ns()`` right after; an event then lies at the anchor's
host time plus the anchor's ``elapsed_time`` to it. With the recorder
off, :func:`span`, :func:`device_span` and :func:`driven_span` return
one shared null context after a single ``is None`` test: no event, no
synchronisation, no allocation.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from collections import Counter
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch


# steps a trace records (train and eval steps alike, from the first):
# a run's profile is bounded however long the run is
TRACE_STEPS = 10

_profiler = None   # the open trace's profiler, stepped by step_annotation


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the body's first :data:`TRACE_STEPS` steps (each closed
    :func:`step_annotation`); writes ``<logdir>/trace_<pid>.json`` when
    the window ends or the body exits, also by an exception."""
    global _profiler
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    with warnings.catch_warnings():   # "won't be using warmup": by design
        warnings.simplefilter("ignore", UserWarning)
        window = schedule(wait=0, warmup=0, active=TRACE_STEPS, repeat=1)
    # leaving the window, or the body, exports (torch's RECORD -> stop
    # transition calls on_trace_ready)
    with profile(activities=activities, schedule=window,
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        _profiler = prof
        try:
            yield
        finally:
            _profiler = None


@contextlib.contextmanager
def step_annotation(name: str, step: int):
    """Names a step ``<name>#<step>`` in the trace; its normal end
    advances the open trace's window."""
    with torch.profiler.record_function(f"{name}#{step}"):
        yield
    if _profiler is not None:
        _profiler.step()


def check_finite(step: int, loss: torch.Tensor,
                 grads: Iterable[torch.Tensor]) -> None:
    """Raise ``FloatingPointError`` if ``loss`` or a gradient holds a NaN
    or an infinity (one host sync)."""
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for g in grads])
    if not bool(flags.all()):
        what = "loss" if not bool(flags[0]) else "a gradient"
        raise FloatingPointError(
            f"non-finite {what} at train step {step} (--nan-checks)")


def checkify_fn(fn: Callable) -> Callable:
    """``fn`` that raises ``FloatingPointError`` when a tensor it returns
    (at any depth of tuples, lists and dicts) is not finite."""
    def tensors(out):
        if isinstance(out, torch.Tensor):
            yield out
        elif isinstance(out, (tuple, list)):
            for o in out:
                yield from tensors(o)
        elif isinstance(out, dict):
            for o in out.values():
                yield from tensors(o)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        for t in tensors(out):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite output")
        return out

    return wrapper


class _Null:
    """The one context :func:`span`, :func:`device_span` and
    :func:`driven_span` return while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()
_ACTIVE: Optional["Recording"] = None   # the open recording, if any
_LOCAL = threading.local()              # each thread's open host spans


class Span:
    """One host span; ``end_ns`` is 0 while it is open. ``counters``:
    numbers (or lists of them) attached with :meth:`count`."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "thread",
                 "batch", "counters", "_rec")

    def __init__(self, rec: "Recording", name: str, batch: Optional[int],
                 parent: Optional["Span"]):
        self._rec, self.name, self.batch = rec, name, batch
        self.parent = parent
        self.thread = threading.current_thread().name
        self.counters: Dict[str, object] = {}
        self.id, self.start_ns, self.end_ns = -1, 0, 0

    def count(self, **counters) -> None:
        self.counters.update(counters)

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        if self.batch is None and self.parent is not None:
            self.batch = self.parent.batch
        self._rec._add(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        return False


class DeviceSpan:
    """A device span: CUDA timing events before and after the work it
    brackets, on the stream current at each; ``start_ns`` and ``end_ns``
    on the host spans' clock once :meth:`Recording.resolve` has run. A
    ``driven`` span also keeps the ``kernels`` the profiler saw over its
    block, as ``(start_ns, end_ns)`` on the same clock."""

    __slots__ = ("name", "parent", "batch", "start_ns", "end_ns", "driven",
                 "kernels", "_start", "_end", "_anchor", "_prof")

    def __init__(self, name: str, anchor, driven: bool = False):
        self.name, self._anchor, self.driven = name, anchor, driven
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.batch = self.parent.batch if self.parent is not None else None
        self.start_ns = self.end_ns = 0
        self.kernels: List[Tuple[int, int]] = []
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._prof = None

    def __enter__(self) -> "DeviceSpan":
        # under another profiler (one profiler at a time) it keeps none
        if self.driven and not torch._C._autograd._profiler_enabled():
            with span("profiler.start"), warnings.catch_warnings():
                # "clears events at the end of each cycle": one cycle here
                warnings.simplefilter("ignore", UserWarning)
                self._prof = _kernel_profiler()
                self._prof.__enter__()
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        if self._prof is not None:
            with span("profiler.stop"):
                self._prof.__exit__(None, None, None)
        return False


def _kernel_profiler():
    """A profiler of the card's activity alone (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_kernels(prof) -> List[Tuple[int, int, int]]:
    """``(start_ns, end_ns, stream)`` of each kernel and memset a stopped
    :func:`_kernel_profiler` saw on the card, on the profiler's clock;
    copies to and from the host (uploads, reads) left out."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.name().startswith(
                ("Memcpy HtoD", "Memcpy DtoH")):
            continue
        start = e.start_ns()
        out.append((start, start + e.duration_ns(), e.device_resource_id()))
    return out


def place_kernels(kernels: Sequence[Tuple[int, int, int]], end_ns: int
                  ) -> List[Tuple[int, int]]:
    """``kernels`` (:func:`device_kernels`) moved onto the host clock:
    the last kernel to end on the stream that ran most of them ends at
    ``end_ns``, the span's end event on that stream."""
    if not kernels:
        return []
    runs = Counter(k[2] for k in kernels)
    stream = max(runs, key=runs.get)
    shift = end_ns - max(e for _, e, st in kernels if st == stream)
    return sorted((s + shift, e + shift) for s, e, _ in kernels)


def _stack() -> List[Span]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Recording:
    """The spans of one :func:`recording`: ``spans`` (host, by id) and
    ``device`` (device spans, in the order they were entered)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.device: List[DeviceSpan] = []
        self.t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._anchor = None           # (event, host ns) of this clock
        self._unresolved: List[DeviceSpan] = []

    def _add(self, span: Span) -> None:
        with self._lock:
            span.id = len(self.spans)
            self.spans.append(span)

    def anchor(self, device) -> None:
        """Tie the device's events to the host clock: an event on the
        current stream, waited for, and ``perf_counter_ns()`` right
        after (the start of a traced pass; nothing on a CPU device)."""
        if torch.device(device).type != "cuda":
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        self._anchor = (ev, time.perf_counter_ns())

    def _device_span(self, name: str, driven: bool) -> DeviceSpan:
        if self._anchor is None:
            self.anchor("cuda")
        ds = DeviceSpan(name, self._anchor, driven)
        with self._lock:
            self.device.append(ds)
            self._unresolved.append(ds)
        return ds

    def resolve(self) -> None:
        """Place the device spans recorded so far on the host clock,
        waiting for their end events (after the work has been fetched,
        so this waits for nothing)."""
        with self._lock:
            todo, self._unresolved = self._unresolved, []
        for ds in todo:
            ds._end.synchronize()
            ev, host_ns = ds._anchor
            ds.start_ns = host_ns + round(ev.elapsed_time(ds._start) * 1e6)
            ds.end_ns = host_ns + round(ev.elapsed_time(ds._end) * 1e6)
            if ds._prof is not None:
                ds.kernels = place_kernels(device_kernels(ds._prof),
                                           ds.end_ns)
            ds._start = ds._end = ds._anchor = ds._prof = None

    def records(self) -> Dict[str, List[dict]]:
        """The spans as plain records, times in ns on the host clock:
        ``host`` (id, name, start_ns, end_ns, parent, thread, batch,
        counters) and ``device`` (name, start_ns, end_ns, parent,
        batch, driven, kernels)."""
        self.resolve()
        pid = lambda s: s.id if s is not None else None
        return {
            "host": [dict(id=s.id, name=s.name, start_ns=s.start_ns,
                          end_ns=s.end_ns, parent=pid(s.parent),
                          thread=s.thread, batch=s.batch,
                          counters=dict(s.counters)) for s in self.spans],
            "device": [dict(name=d.name, start_ns=d.start_ns,
                            end_ns=d.end_ns, parent=pid(d.parent),
                            batch=d.batch, driven=d.driven,
                            kernels=list(d.kernels)) for d in self.device]}

    def write_chrome_trace(self, logdir: str, stem: str) -> str:
        """``<logdir>/<stem>_<pid>.json``: the host spans on a track per
        thread, the device spans on a ``cuda:0`` track and the driven
        spans' kernels on a ``cuda:0 kernels`` track, each span's batch
        and counters in its ``args``; times in µs from the recording's
        start. Returns the path."""
        rec = self.records()
        pid = os.getpid()
        threads = {}
        for s in rec["host"]:
            threads.setdefault(s["thread"], len(threads) + 1)
        device_tid = len(threads) + 1
        us = lambda ns: (ns - self.t0_ns) / 1e3
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": f"mtn_tpu_torch ({pid})"}}]
        events += [{"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}}
                   for name, tid in threads.items()]
        if rec["device"]:
            events += [{"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": device_tid + i, "args": {"name": name}}
                       for i, name in enumerate(("cuda:0", "cuda:0 kernels"))]

        def complete(s, tid, args):
            return {"ph": "X", "name": s["name"], "pid": pid, "tid": tid,
                    "ts": us(s["start_ns"]),
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": args}
        events += [complete(s, threads[s["thread"]],
                            dict(batch=s["batch"], **s["counters"]))
                   for s in rec["host"]]
        events += [complete(d, device_tid, {"batch": d["batch"],
                                            "driven": d["driven"]})
                   for d in rec["device"]]
        events += [complete(dict(name=d["name"], start_ns=a, end_ns=b),
                            device_tid + 1, {"batch": d["batch"]})
                   for d in rec["device"] for a, b in d["kernels"]]
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{stem}_{pid}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


@contextlib.contextmanager
def recording():
    """Record spans inside the block; yields the :class:`Recording`,
    whose device spans are resolved when the block ends."""
    global _ACTIVE
    rec, prev = Recording(), _ACTIVE
    _ACTIVE = rec
    try:
        yield rec
    finally:
        _ACTIVE = prev
        rec.resolve()


def active() -> Optional[Recording]:
    """The open recording, or None while the recorder is off."""
    return _ACTIVE


def span(name: str, batch: Optional[int] = None, parent=None):
    """A host span ``name`` over the block (the shared null context while
    the recorder is off); ``batch`` defaults to the parent's, ``parent``
    to the innermost span open on this thread."""
    rec = _ACTIVE
    if rec is None:
        return NULL
    return Span(rec, name, batch, parent)


def device_span(name: str, device):
    """A device span ``name`` over the work the block enqueues on the
    current stream of ``device``, which the stream runs back to back
    (the shared null context while the recorder is off, on a device
    other than CUDA, and inside a capture)."""
    rec = _ACTIVE
    if rec is None or device.type != "cuda" or _capturing():
        return NULL
    return rec._device_span(name, False)


def driven_span(name: str, device):
    """A device span ``name`` over work the host drives kernel by kernel,
    keeping the kernels the profiler sees over the block (the shared null
    context while the recorder is off, on a device other than CUDA, and
    inside a capture)."""
    rec = _ACTIVE
    if rec is None or device.type != "cuda" or _capturing():
        return NULL
    return rec._device_span(name, True)


def _capturing() -> bool:
    """Whether the current stream is being captured into a CUDA graph: a
    device span there would record its events into the graph, so it
    records nothing (the graph's launch is the span)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
