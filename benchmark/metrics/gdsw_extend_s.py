"""Seconds of the GDSW coarse space's harmonic extensions in the run,
set-up included: the program's `gdsw.extend` span (synchronised at both
ends, inside `prec.gdsw`), summed."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    return program_trace.total(run, "span:gdsw.extend")
