"""Inner GMRES iterations per time step: the sum over the step's Newton
iterations of what each linear solve returns, averaged over the window."""

from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "gmres")
