"""Arithmetic shared by the per-layer metric readers of `metrics/`.  A
reader returns None where its cell gives it nothing to read; the harness
then leaves the metric out."""

from __future__ import annotations

import statistics

from benchmark import roofline


def mean_of(run, key: str):
    """Mean over the window's operations of one recorded count."""
    vals = [op[key] for op in run.ops if key in op]
    return statistics.fmean(vals) if vals else None


def device_idle_pct(run):
    t = run.trace
    if t is None or not t.done or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def b3_roofline_pct(run):
    """B3's share of its roofline: the least time of its launches at the
    card's peaks (unpadded bytes, `roofline.b3_least_s`) over their device
    time in the traced sub-window."""
    t = run.trace
    cache = run.system.mixed_cache() if run.system is not None else None
    if t is None or not t.done or cache is None:
        return None
    hit = t.kernel("dense_gemv_f32")
    if hit is None:
        return None
    seconds, launches = hit
    db = cache["db32"]
    rows, cols = roofline.unpadded_blocks(db.old_of_pad.cpu().numpy(),
                                          db.ghost_idx.cpu().numpy(),
                                          db.n, db.R)
    return 100.0 * roofline.b3_least_s(rows, cols) * launches / seconds
