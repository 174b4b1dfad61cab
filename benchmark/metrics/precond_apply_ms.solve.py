"""Mean milliseconds of one preconditioner apply inside GMRES: the
program's `precond.apply` spans, not synchronised, so the host's time to
issue it, over the window's solves that the profiler did not see (all of
them where it saw every one)."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    v = program_trace.ratio(run, "span:precond.apply",
                            "spans:precond.apply")
    return None if v is None else 1e3 * v
