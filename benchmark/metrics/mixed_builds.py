"""Builds of the mixed solve's operators and preconditioner over the
set-up: the program's `mixed.builds` counter, counted before the window
(a refresh of the operator's values on an unchanged pattern is
`mixed.refreshes`, not a build)."""

from benchmark import program_trace


def install(run):
    program_trace.install(run)


def read(run):
    return program_trace.total(run, "count:mixed.builds", ops=[-1])
