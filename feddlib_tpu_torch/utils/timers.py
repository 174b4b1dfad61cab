"""Hierarchical timer registry — counterpart of feddlib_tpu/utils/timers.py
(the Teuchos::TimeMonitor equivalent; reference: FEDD_TIMER macros,
core/FEDDCore.hpp:5-6) — and the program's spans and counters.

Usage:
    with timer("assembly/laplace"):
        ...
    print(report())

Every scope is a span.  Nesting is tracked by a path stack, one per
thread; `report()` prints a sorted table of totals, counts, and
percentages by path, as the JAX registry does.  Each span also has an
integer `id`, its `parent`'s id (the span open below it on the same
thread, None at the top) and a `root` id, the id of the outermost open
span, which every span of one operation (a solve, a time step) shares.
Its `start_ns` / `end_ns` are `time.perf_counter_ns()` readings, and
`seconds` their difference.

CUDA work is asynchronous: a scope times what the host did, the enqueue
of device work included, not the device's work.  `timer(name, sync=True)`
synchronises the current CUDA device at open and at close (when CUDA is
initialised), so that the span holds its own device work and none of the
work before it; it is for whole-layer boundaries, never inside a Krylov
iteration.

`count(name, n)` adds to a counter of the same registry (`counters()`,
`reset_counters()`): Krylov iterations and restarts, refinement passes,
Newton iterations and line-search halvings, and the kernel launches of
`la/_cuda.py` as `kernel.<name>`.

`subscribe(fn)` delivers each closed `Span` and each counter increment,
as a `CountRecord` (name, n), to `fn`, on the thread that made it, until
`unsubscribe(fn)`.  With no subscriber no record is built.
`observed()` says whether a subscriber or a profiler would see a span:
spans inside a Krylov iteration open only then (solvers/krylov.py), since
a span costs microseconds of host time and the loop runs hundreds of
iterations a solve.

While a `torch.profiler` profile runs, each span also opens a
`torch.profiler.record_function` named `fedd/<name>`, so that it sits on
the profiler's timeline around the operators and launches it issues
(`profile_trace`).  With no profiler running none is entered."""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, NamedTuple

import torch

ANNOTATION_PREFIX = "fedd/"

_totals: Dict[str, list] = {}   # path -> [seconds, calls]
_counters: Dict[str, int] = defaultdict(int)
_ids = itertools.count(1)
_listeners: tuple = ()
_listeners_lock = threading.Lock()
_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Local(threading.local):
    def __init__(self):
        self.stack = []   # the open spans of this thread, outermost first


_local = _Local()


class CountRecord(NamedTuple):
    name: str
    n: int


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Span:
    """One scope of `timer`; after it closes, `seconds` is its duration."""

    __slots__ = ("name", "sync", "id", "parent", "root", "path",
                 "start_ns", "end_ns", "_ann", "_stack")

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync

    def __enter__(self) -> "Span":
        stack = self._stack = _local.stack
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.root = top.id, top.root
            self.path = top.path + "/" + self.name
        else:
            self.parent, self.root, self.path = None, self.id, self.name
        stack.append(self)
        if self.sync:
            _synchronize()
        self._ann = None
        if _profiling():
            self._ann = torch.profiler.record_function(
                ANNOTATION_PREFIX + self.name)
            self._ann.__enter__()
        self.start_ns = _now()
        return self

    def __exit__(self, *exc) -> None:
        if self.sync:
            _synchronize()
        self.end_ns = _now()
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
        self._stack.pop()
        total = _totals.get(self.path)
        if total is None:
            total = _totals[self.path] = [0.0, 0]
        total[0] += (self.end_ns - self.start_ns) * 1e-9
        total[1] += 1
        for fn in _listeners:
            fn(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def observed() -> bool:
    """Whether a subscriber or a running torch.profiler sees spans."""
    return bool(_listeners) or _profiling()


def timer(name: str, sync: bool = False) -> Span:
    """A span named `name` (a context manager); `sync=True` synchronises
    the current CUDA device at its open and its close."""
    return Span(name, sync)


def count(name: str, n: int = 1) -> None:
    _counters[name] += n
    if _listeners:
        rec = CountRecord(name, n)
        for fn in _listeners:
            fn(rec)


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters(*names: str) -> None:
    """Zero the named counters, or every counter when none is named."""
    if not names:
        _counters.clear()
    for k in names:
        _counters.pop(k, None)


def subscribe(fn: Callable) -> None:
    global _listeners
    with _listeners_lock:
        _listeners = _listeners + (fn,)


def unsubscribe(fn: Callable) -> None:
    global _listeners
    with _listeners_lock:
        rest = list(_listeners)
        if fn in rest:
            rest.remove(fn)
        _listeners = tuple(rest)


@contextmanager
def profile_trace(log_dir: str):
    """Profile the enclosed region with `torch.profiler` (CPU activity,
    and CUDA activity when a card is present), spans annotated as
    `fedd/<name>`, and write a Chrome trace `trace.json` into `log_dir`.
    Yields the profiler, whose `key_averages()` / `events()` can be read
    after the region."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def reset() -> None:
    _totals.clear()


def totals() -> Dict[str, float]:
    return {k: v[0] for k, v in _totals.items()}


def report() -> str:
    if not _totals:
        return "(no timers)"
    grand = sum(v[0] for k, v in _totals.items() if "/" not in k) or \
        sum(v[0] for v in _totals.values())
    lines = [f"{'timer':<48} {'total [s]':>10} {'calls':>7} {'%':>6}"]
    for k in sorted(_totals):
        depth = k.count("/")
        name = "  " * depth + k.split("/")[-1]
        sec, calls = _totals[k]
        lines.append(f"{name:<48} {sec:>10.4f} {calls:>7} "
                     f"{100*sec/grand:>5.1f}%")
    return "\n".join(lines)
