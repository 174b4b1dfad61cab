"""Milliseconds of one inner GMRES iteration: the program's `krylov.gmres`
spans over its `krylov.iterations` counter, over the window's solves that
the profiler did not see (all of them where it saw every one)."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    v = program_trace.ratio(run, "span:krylov.gmres",
                            "count:krylov.iterations")
    return None if v is None else 1e3 * v
