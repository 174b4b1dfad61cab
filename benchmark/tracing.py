"""The traced sub-window of a `--trace 1` run: torch.profiler over a few
whole operations, reduced to the device's busy time, the kernels' times and
the idle gaps named by what the host was doing in them.

Busy time is the union of the card's kernel and copy intervals, as
`chip_smoke.py`'s `_busy_share` takes it; `window_s` is the host clock
across the profiled operations, each ended by a synchronise.  Spans are
`torch.profiler.record_function` scopes named `bench/<name>`, opened by the
harness around its calls into the program; an idle gap of the card is
named by the innermost span and the innermost host event open at its
middle.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

SPAN_PREFIX = "bench/"


@contextmanager
def span(name: str):
    """A named span of the harness (free when no profiler runs)."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def _events(prof):
    """(device [(name, start_ns, end_ns)], host [(name, start_ns, end_ns,
    thread)]) of a finished profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no work
            if e.is_user_annotation() or rec[0].startswith(SPAN_PREFIX):
                continue
            dev.append(rec)
        elif e.device_type() == DeviceType.CPU:
            host.append(rec + (e.start_thread_id(),))
    return dev, host


def _merge(intervals):
    """Sorted union of [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _name_gaps(gaps, host):
    """For each gap (start, end), what the host was doing in it: the
    innermost span and host event open at the gap's middle, on the thread
    that opened the spans ("(python)" where no event is open: the
    interpreter between two calls)."""
    spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
    thread = spans[0][3] if spans else None
    evs = sorted((h for h in host if thread is None or h[3] == thread),
                 key=lambda h: (h[1], -h[2]))
    names, stack, k = [], [], 0
    for g0, g1 in gaps:  # sorted, disjoint: their middles are sorted too
        mid = (g0 + g1) // 2
        while k < len(evs) and evs[k][1] <= mid:
            stack.append(evs[k])
            k += 1
        stack = [h for h in stack if h[2] > mid]
        sp = next((h[0][len(SPAN_PREFIX):] for h in reversed(stack)
                   if h[0].startswith(SPAN_PREFIX)), "(no span)")
        op = next((h[0] for h in reversed(stack)
                   if not h[0].startswith(SPAN_PREFIX)), "(python)")
        names.append(f"{sp} | {op}")
    return names


class Trace:
    """Profile whole operations: `start()` before the first, `stop()` after
    the last (each ended by a synchronise).  After `stop()`: `busy_s`,
    `window_s`, `kernels` (name -> [seconds, launches]) and `breakdown`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.done = False
        self.busy_s = self.window_s = None
        self.kernels = {}
        self.breakdown = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        dev, host = _events(self.prof)
        self.prof = None
        self.done = True
        kern = defaultdict(lambda: [0.0, 0])
        for name, a, b in dev:
            kern[name][0] += (b - a) * 1e-9
            kern[name][1] += 1
        self.kernels = dict(kern)
        busy = _merge([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-9
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        idle = defaultdict(float)
        for (a, b), name in zip(gaps, _name_gaps(gaps, host)):
            idle[name] += (b - a) * 1e-9
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        self.breakdown = {
            "device_ops": [[n, v[0]] for n, v in top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda kv: -kv[1])[:10]}

    def kernel(self, fragment: str):
        """(seconds, launches) summed over the kernels whose name holds
        `fragment`; None where none ran."""
        hits = [v for n, v in self.kernels.items() if fragment in n]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)
