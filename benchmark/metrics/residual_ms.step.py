"""Milliseconds per time step in the Newton loop's residual evaluations:
the program's `newton.residual` spans (synchronised at both ends), per
window step that the profiler did not see (all of them where it saw every
one)."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    v = program_trace.per_op(run, "span:newton.residual")
    return None if v is None else 1e3 * v
