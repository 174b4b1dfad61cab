"""The program's own spans and counters (`feddlib_tpu_torch/utils/timers.py`)
for the per-layer readers of `metrics/`, filed by the window operation in
progress (`run.op_index`; -1 before the window) through `run.add_span`:

    span:<name>    seconds of the spans of that name
    spans:<name>   their number
    count:<name>   the counter's increments

A reader calls `install(run)` from its own `install`; the harness calls
those only in a `--trace 1` run, so a `--trace 0` run has no subscriber.
A program without the registry's `subscribe` files nothing, and the
readers then return None."""

from __future__ import annotations


def install(run) -> None:
    """Subscribe once per run."""
    if getattr(run, "program_trace", False):
        return
    run.program_trace = True
    from feddlib_tpu_torch.utils import timers

    subscribe = getattr(timers, "subscribe", None)
    if subscribe is None:
        return

    def file(rec):
        if hasattr(rec, "end_ns"):
            run.add_span("span:" + rec.name,
                         (rec.end_ns - rec.start_ns) * 1e-9)
            run.add_span("spans:" + rec.name, 1.0)
        else:
            run.add_span("count:" + rec.name, float(rec.n))

    subscribe(file)


def window_ops(run) -> list:
    """The window operations a reader averages over: those the profiler
    did not see (it slows the host's part severalfold), or all of them
    where it saw every one."""
    unseen = [i for i, op in enumerate(run.ops) if not op.get("profiled")]
    return unseen or list(range(len(run.ops)))


def total(run, key: str, ops=None):
    """Sum of `key` over the operations `ops` (every index filed, set-up
    included, where None); None where nothing was filed under `key`."""
    per_op = run.spans.get(key)
    if not per_op:
        return None
    if ops is None:
        return sum(per_op.values())
    return sum(per_op.get(i, 0.0) for i in ops)


def per_op(run, key: str):
    """Mean of `key` per window operation (`window_ops`)."""
    ops = window_ops(run)
    v = total(run, key, ops)
    return None if v is None or not ops else v / len(ops)


def ratio(run, num: str, den: str):
    """Sum of `num` over sum of `den`, over `window_ops`."""
    ops = window_ops(run)
    a, b = total(run, num, ops), total(run, den, ops)
    return None if a is None or not b else a / b
