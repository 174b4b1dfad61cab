"""Inner GMRES iterations per solve (all refinement passes), as the solve
returns them, averaged over the window."""

from benchmark.readers import mean_of


def read(run):
    return mean_of(run, "gmres")
