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
  output raises; :class:`Timer` is a wall clock.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable, Iterable, Optional

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


class Timer:
    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def reset(self) -> float:
        now = time.time()
        dt = now - self.start
        self.start = now
        return dt
