"""The card's idle share of the profiled sub-window: 1 - (union of its
kernel and copy intervals) / wall time (%)."""

from benchmark.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
