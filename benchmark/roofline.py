"""The yardstick of the kernels: the card's published peaks and each
kernel's bytes as a function of the work it has to do, counted from the
UNPADDED sizes, so that a layout with less padding cannot read above 100 %.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power
limit (a card set lower reads a lower share; the run prints its limit).
"""

from __future__ import annotations

import numpy as np

PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_F32_S = 67e12      # f32 on the CUDA cores
F32 = 4


def b3_bytes(rows, cols) -> float:
    """Bytes one launch of B3 (the batched dense GEMV of the level-1
    Schwarz apply, `csrc/dense_gemv.cu`) has to move: every cluster's
    true owned rows x true overlap columns of the f32 inverse, its overlap
    slice of x read once and its rows of y written once.  `rows[p]`,
    `cols[p]` are cluster p's counts without padding."""
    rows = np.asarray(rows, dtype=np.float64)
    cols = np.asarray(cols, dtype=np.float64)
    return float(F32 * (rows * cols + cols + rows).sum())


def b3_flops(rows, cols) -> float:
    """Multiply-adds of one B3 launch, counted as two operations each."""
    rows = np.asarray(rows, dtype=np.float64)
    cols = np.asarray(cols, dtype=np.float64)
    return float(2.0 * (rows * cols).sum())


def b3_least_s(rows, cols) -> float:
    """The least time one B3 launch can take on the card: the larger of
    its bytes at the memory peak and its operations at the f32 peak."""
    return max(b3_bytes(rows, cols) / PEAK_BYTES_S,
               b3_flops(rows, cols) / PEAK_F32_S)


def unpadded_blocks(old_of_pad, ghost_idx, n: int, R: int):
    """(rows, cols) per cluster of a padded cluster layout: `old_of_pad`
    [P*R] maps a padded row to its dof (n marks padding), `ghost_idx`
    [P, G] a cluster's ghost columns (P*R marks padding)."""
    old_of_pad = np.asarray(old_of_pad)
    ghost_idx = np.asarray(ghost_idx)
    P = ghost_idx.shape[0]
    rows = (old_of_pad.reshape(P, R) < n).sum(axis=1)
    ghosts = (ghost_idx < P * R).sum(axis=1)
    return rows, rows + ghosts
