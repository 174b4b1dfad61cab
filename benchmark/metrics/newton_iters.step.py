"""Newton iterations per time step (one linear solve each), averaged over
the window."""

from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "newton")
