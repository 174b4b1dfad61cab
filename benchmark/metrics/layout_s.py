"""Seconds of the mixed solve's operator layout in the run, set-up
included: the program's `mixed.partition` (mesh partition, dof map) and
`mixed.layout` (cluster blocks, padded SELL) spans, each synchronised."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    parts = [program_trace.total(run, "span:mixed." + k)
             for k in ("partition", "layout")]
    return None if None in parts else sum(parts)
