"""Distributed index maps — the Tpetra/Xpetra Map equivalent.

Reference: core/LinearAlgebra/Map_decl.hpp:28.  A Map describes which global
indices each partition holds.  Two flavours everywhere in the reference
(Mesh_decl.hpp:138-149): the *repeated* map (owned + ghost/overlapping ids)
and the *unique* map (each id on exactly one partition).

TPU-natively there is no per-rank process: the host holds ALL partitions'
index lists (list of numpy arrays) and bakes them into static gather/scatter
plans for shard_map programs.  Partition p's local index of global id g is
its position in partition_indices[p].
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class IndexMap:
    """Global-index ownership table over `n_parts` partitions."""

    def __init__(self, n_global: int, partition_indices: Sequence[np.ndarray]):
        self.n_global = int(n_global)
        self.partition_indices: List[np.ndarray] = [
            np.asarray(ix, dtype=np.int64) for ix in partition_indices
        ]

    @property
    def n_parts(self) -> int:
        return len(self.partition_indices)

    @property
    def local_sizes(self) -> np.ndarray:
        return np.array([len(ix) for ix in self.partition_indices])

    @property
    def max_local_size(self) -> int:
        return int(self.local_sizes.max()) if self.n_parts else 0

    @classmethod
    def contiguous(cls, n_global: int, n_parts: int = 1) -> "IndexMap":
        """Uniform contiguous split of [0, n_global)."""
        bounds = np.linspace(0, n_global, n_parts + 1).astype(np.int64)
        return cls(n_global, [np.arange(bounds[p], bounds[p + 1])
                              for p in range(n_parts)])

    def is_unique(self) -> bool:
        total = sum(len(ix) for ix in self.partition_indices)
        if total != self.n_global:
            return False
        seen = np.concatenate(self.partition_indices) if total else np.array([], np.int64)
        return len(np.unique(seen)) == total

    def owner_of(self) -> np.ndarray:
        """[n_global] owner partition of each global id (requires unique map
        covering all ids)."""
        owner = np.full(self.n_global, -1, dtype=np.int32)
        for p, ix in enumerate(self.partition_indices):
            owner[ix] = p
        return owner

    def build_unique_map(self) -> "IndexMap":
        """Unique (owned) map from a repeated (overlapping) map: each global
        id is assigned to the LOWEST partition holding it.  Deterministic
        replacement for the reference's import-based arbitration
        (Map_decl.hpp:100-102 buildUniqueMap / Map_def.hpp)."""
        owner = np.full(self.n_global, np.iinfo(np.int32).max, dtype=np.int32)
        for p, ix in enumerate(self.partition_indices):
            np.minimum.at(owner, ix, p)
        parts = [np.array([], np.int64)] * self.n_parts
        held = owner != np.iinfo(np.int32).max
        gids = np.nonzero(held)[0].astype(np.int64)
        ow = owner[held]
        order = np.argsort(ow, kind="stable")
        gids, ow = gids[order], ow[order]
        splits = np.searchsorted(ow, np.arange(1, self.n_parts))
        parts = [np.sort(a) for a in np.split(gids, splits)]
        return IndexMap(self.n_global, parts)

    def with_free_parts(self, num_free: int) -> "IndexMap":
        """Append `num_free` empty partitions — the reference's reserved
        coarse-solver ranks: domain rows live on the first parts, the last
        `num_free` own nothing and serve the coarse level only
        (Map::buildUniqueMap numFreeProcs, Map_decl.hpp:97-100;
        'Mpi Ranks Coarse', Preconditioner_def.hpp:384-423)."""
        if num_free < 0:
            raise ValueError("num_free must be >= 0")
        return IndexMap(self.n_global, list(self.partition_indices)
                        + [np.array([], np.int64)] * num_free)

    def build_vec_field_map(self, dofs_per_node: int) -> "IndexMap":
        """Dof map from node map, NodeWise ordering: dof gid = node_gid*dofs+d
        (reference: Map::buildVecFieldMap, Map_decl.hpp:72; FROSch
        DofOrdering=NodeWise)."""
        parts = []
        for ix in self.partition_indices:
            dofs = (ix[:, None] * dofs_per_node
                    + np.arange(dofs_per_node, dtype=np.int64)[None, :])
            parts.append(dofs.reshape(-1))
        return IndexMap(self.n_global * dofs_per_node, parts)

    def global_to_local(self, part: int) -> dict:
        ix = self.partition_indices[part]
        return {int(g): i for i, g in enumerate(ix)}

    def local_lookup(self, part: int, gids: np.ndarray) -> np.ndarray:
        """Vectorised local ids of `gids` in partition `part` (-1 if absent)."""
        ix = self.partition_indices[part]
        order = np.argsort(ix, kind="stable")
        pos = np.searchsorted(ix[order], gids)
        pos = np.clip(pos, 0, len(ix) - 1)
        ok = ix[order][pos] == gids
        out = np.where(ok, order[pos], -1)
        return out.astype(np.int64)

    def __repr__(self):
        return (f"IndexMap(n_global={self.n_global}, n_parts={self.n_parts}, "
                f"sizes={self.local_sizes.tolist()})")
