"""Refinement passes per solve: the program's `refinement.passes` counter
(f64 iterative refinement around the f32 inner solve), over the window's
solves that the profiler did not see (all of them where it saw every
one)."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    return program_trace.per_op(run, "count:refinement.passes")
