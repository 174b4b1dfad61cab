"""B3 (`csrc/dense_gemv.cu`, the level-1 Schwarz apply) against its
roofline, from the profiled sub-window (%)."""

from benchmark.readers import b3_roofline_pct


def read(run):
    return b3_roofline_pct(run)
