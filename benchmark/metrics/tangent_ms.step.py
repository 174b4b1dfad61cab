"""Milliseconds per time step in the tangent reassembly that each Newton
iteration calls (`NonLinElasticity.reassemble`), from a span of this file
that synchronises the card at both ends, averaged over the window's steps
that the profiler did not see (it slows the host's part threefold), or
over all of them where it saw every one."""

import time

SPAN = "tangent_ms"


def install(run):
    import torch

    prob = run.system.prob
    inner = prob.reassemble
    cuda = run.device.type == "cuda"

    def reassemble(*a, **k):
        if cuda:
            torch.cuda.synchronize(run.device)
        t = time.perf_counter()
        out = inner(*a, **k)
        if cuda:
            torch.cuda.synchronize(run.device)
        run.add_span(SPAN, time.perf_counter() - t)
        return out

    prob.reassemble = reassemble


def read(run):
    per_op = run.spans.get(SPAN, {})
    unseen = [i for i, op in enumerate(run.ops) if not op.get("profiled")]
    vals = [per_op.get(i, 0.0) for i in unseen or range(len(run.ops))]
    return 1e3 * sum(vals) / len(vals) if vals else None
