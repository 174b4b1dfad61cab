"""Block systems — BlockMatrix / BlockVector.

Counterpart of feddlib_tpu/la/block.py: a block (i,j)-indexed collection of
CsrMatrix with a blocked apply and a `merge()` that flattens into one
monolithic CSR with global block offsets, used by monolithic solvers and
preconditioners.  Vectors are lists of torch tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.utils.device import resolve_device

# merged pattern of each block layout, across merges: (the block positions
# with id() of each block's pattern, row sizes, col sizes) → (the block
# patterns, merged pattern).  A Newton loop merges the same patterns at
# every reassembly; one merged pattern lets the mixed solve's cache
# (solvers/linear.py) refresh its values instead of rebuilding.
_merged_pattern_cache: dict = {}


class BlockVector:
    """List of per-block device vectors.

    A vector may carry a `_dist_mirror = (pipe, shards)` attachment: the
    same values as the owned shards [n_dev, N_o] of a DistributedPipeline's
    dof map.  axpy / scale / copy propagate it, so Newton and time updates
    keep the shards on the device and the distributed solve does not
    upload the solution again; a block write (`v[i] = ...`) drops it."""

    def __init__(self, blocks: List[torch.Tensor]):
        self.blocks = list(blocks)
        self._dist_mirror = None

    @classmethod
    def zeros(cls, sizes, dtype=torch.float64, device="cuda"):
        dev = resolve_device(device)
        return cls([torch.zeros(s, dtype=dtype, device=dev) for s in sizes])

    @property
    def sizes(self):
        return [b.shape[0] for b in self.blocks]

    def __getitem__(self, i):
        return self.blocks[i]

    def __setitem__(self, i, v):
        self.blocks[i] = v
        self._dist_mirror = None  # the shards no longer hold these values

    def __len__(self):
        return len(self.blocks)

    def concat(self) -> torch.Tensor:
        return torch.cat(self.blocks)

    @classmethod
    def split(cls, flat: torch.Tensor, sizes) -> "BlockVector":
        return cls(list(torch.split(flat, list(sizes))))

    def norm2(self) -> torch.Tensor:
        return torch.sqrt(sum(torch.dot(b, b) for b in self.blocks))

    def dot(self, other: "BlockVector") -> torch.Tensor:
        return sum(torch.dot(a, b) for a, b in zip(self.blocks, other.blocks))

    def axpy(self, alpha, x: "BlockVector") -> "BlockVector":
        out = BlockVector([a + alpha * b
                           for a, b in zip(self.blocks, x.blocks)])
        ma, mb = self._dist_mirror, getattr(x, "_dist_mirror", None)
        if ma is not None and mb is not None and ma[0] is mb[0]:
            out._dist_mirror = (ma[0], ma[1] + alpha * mb[1])
        return out

    def scale(self, alpha) -> "BlockVector":
        out = BlockVector([alpha * b for b in self.blocks])
        if self._dist_mirror is not None:
            out._dist_mirror = (self._dist_mirror[0],
                                alpha * self._dist_mirror[1])
        return out

    def copy(self) -> "BlockVector":
        out = BlockVector(list(self.blocks))
        out._dist_mirror = self._dist_mirror
        return out


class BlockMatrix:
    """(i,j)-indexed sparse blocks over fixed block row/col sizes."""

    def __init__(self, row_sizes: List[int],
                 col_sizes: Optional[List[int]] = None):
        self.row_sizes = list(row_sizes)
        self.col_sizes = list(col_sizes if col_sizes is not None
                              else row_sizes)
        self.blocks: Dict[Tuple[int, int], CsrMatrix] = {}
        self._merged: Optional[CsrMatrix] = None

    @property
    def n_block_rows(self):
        return len(self.row_sizes)

    @property
    def n_block_cols(self):
        return len(self.col_sizes)

    def add_block(self, i: int, j: int, m: CsrMatrix) -> None:
        if m.shape != (self.row_sizes[i], self.col_sizes[j]):
            raise ValueError(
                f"block ({i},{j}) shape {m.shape} != "
                f"({self.row_sizes[i]},{self.col_sizes[j]})"
            )
        self.blocks[(i, j)] = m
        self._merged = None

    def get_block(self, i: int, j: int) -> Optional[CsrMatrix]:
        return self.blocks.get((i, j))

    def __contains__(self, ij):
        return ij in self.blocks

    def apply(self, x: BlockVector) -> BlockVector:
        """Blocked SpMV."""
        out = []
        for i in range(self.n_block_rows):
            acc = None
            for j in range(self.n_block_cols):
                m = self.blocks.get((i, j))
                if m is None:
                    continue
                y = m.matvec(x[j])
                acc = y if acc is None else acc + y
            if acc is None:
                acc = torch.zeros(self.row_sizes[i], dtype=torch.float64,
                                  device=x[0].device)
            out.append(acc)
        return BlockVector(out)

    def merge(self) -> CsrMatrix:
        """Flatten to one monolithic CSR with global block offsets.
        Memoized until a block changes; a build is the synchronised span
        `block.merge` (utils/timers.py).  Merges of the same block
        patterns share one merged pattern (`_merged_pattern_cache`)."""
        if self._merged is None:
            with timers.timer("block.merge", sync=True):
                self._merged = self._merge()
        return self._merged

    def _merge(self) -> CsrMatrix:
        items = sorted(self.blocks.items())
        pats = tuple(m.pattern for _, m in items)
        key = (tuple((i, j, id(m.pattern)) for (i, j), m in items),
               tuple(self.row_sizes), tuple(self.col_sizes))
        ent = _merged_pattern_cache.get(key)
        if ent is None:
            row_off = np.concatenate([[0], np.cumsum(self.row_sizes)])
            col_off = np.concatenate([[0], np.cumsum(self.col_sizes)])
            rows = np.concatenate([p.rows_of_slots() + row_off[i]
                                   for ((i, _), _), p in zip(items, pats)])
            cols = np.concatenate([p.indices + col_off[j]
                                   for ((_, j), _), p in zip(items, pats)])
            # hold the block patterns so the id() key stays valid
            ent = (pats, SparsityPattern.from_coo(
                rows, cols, int(row_off[-1]), int(col_off[-1])))
            _merged_pattern_cache[key] = ent
        out = CsrMatrix(ent[1], device=items[0][1].device)
        out.assemble(torch.cat([m.data for _, m in items]))
        return out

    def __repr__(self):
        return (f"BlockMatrix({self.n_block_rows}x{self.n_block_cols}, "
                f"blocks={sorted(self.blocks)})")
