"""Distributed linear algebra over a domain-decomposition axis of shards —
counterpart of feddlib_tpu/parallel/spmd.py.

The host precomputes *static* communication plans (the analog of Tpetra
Import objects), and the applies execute them with three collectives over
the shard axis:

- unique→repeated import (halo exchange): neighbour-wise — the partition
  neighbour graph is edge-coloured on the host and each colour becomes one
  `ppermute` round moving only that pair's boundary values.  The
  all_gather plan (`import_ghosts`, `export_add`) is kept on the host for
  a caller that runs it; no solve or assembly path of the package does
  (nor of the JAX package, whose `matvec_fn` is its one user);
- repeated→unique export/add: the same rounds reversed, ghost
  contributions added into owner rows (Tpetra Export, Add);
- global reductions are a `psum`.

Shards stacked on one device: where the JAX package runs one shard_map
program per device, here every per-shard array is one [n_dev, ...] tensor
on one torch device (the layout the JAX package stacks on the host before
shard_map), and each collective is a tensor operation over the leading
axis.  The plans, the rounds and the values they move are the JAX
package's.  Owned vectors are zero-padded to the largest local size; the
padded lanes stay zero through the SpMV, the preconditioners and the
Krylov updates.

Local matrix layout: rows = owned dofs (padded), columns in column-map
local numbering [owned (padded to N_o) | ghosts], transposed ELL [K, N_o]
per shard.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix, scatter_sum
from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.utils.device import resolve_device


@dataclass
class DeviceAxis:
    """The domain-decomposition axis: `n_dev` shards stacked on `device`.

    Its collectives act on stacked tensors whose axis 0 is the shard."""

    n_dev: int
    device: torch.device

    @classmethod
    def make(cls, n_dev: int, device="cuda") -> "DeviceAxis":
        return cls(int(n_dev), resolve_device(device))

    def perm_source(self, perm) -> torch.Tensor:
        """[n_dev] sender of each shard in the round `perm` ((src, dst)
        pairs, a matching); n_dev where a shard receives nothing."""
        src = np.full(self.n_dev, self.n_dev, np.int64)
        for s, d in perm:
            src[d] = s
        return torch.as_tensor(src, device=self.device)

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        """out[dst] = buf[src] for each (src, dst) of `perm`, zeros for a
        shard that receives nothing (`lax.ppermute`).  `perm` is the pair
        list or its `perm_source` tensor."""
        src = perm if torch.is_tensor(perm) else self.perm_source(perm)
        zero = buf.new_zeros((1,) + tuple(buf.shape[1:]))
        return torch.cat([buf, zero]).index_select(0, src)

    @staticmethod
    def psum(x: torch.Tensor) -> torch.Tensor:
        """The sum over the shards of x [n_dev, ...]; every shard sees the
        same value, so the stacked form keeps one copy [...]."""
        return x.sum(0)

    @staticmethod
    def all_gather(x: torch.Tensor) -> torch.Tensor:
        """Every shard sees all of x [n_dev, B]: the stacked tensor is
        already that view."""
        return x


def _col_local_ids(owned: np.ndarray, ghosts: np.ndarray, cols: np.ndarray,
                   N_o: int) -> np.ndarray:
    """Global column ids → column-map local numbering [owned (padded to
    N_o) | ghosts] through sorted-array lookups.  `owned` and `ghosts`
    must be sorted; every col must appear in one of them."""
    cols = np.asarray(cols, dtype=np.int64)
    i = np.searchsorted(owned, cols)
    i_c = np.minimum(i, max(len(owned) - 1, 0))
    is_own = (owned[i_c] == cols) if len(owned) else np.zeros(len(cols), bool)
    j = np.searchsorted(ghosts, cols)
    return np.where(is_own, i_c, N_o + j)


def _pad_stack(arrs: List[np.ndarray], pad_value, width: Optional[int] = None,
               dtype=None) -> np.ndarray:
    w = width if width is not None else max((len(a) for a in arrs), default=0)
    w = max(w, 1)
    out = np.full((len(arrs), w), pad_value,
                  dtype=dtype or (arrs[0].dtype if len(arrs) else np.int64))
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a
    return out


def _dev_index(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.int64, device=device)


class HaloPlan:
    """Static unique↔repeated exchange plan over the shard axis.

    Built from a unique (owned) map and per-part global column lists
    (col_gids[p] = owned gids ++ ghost gids, owned first, the ghosts
    ascending — the local column map).  The rounds' index arrays are
    stacked [n_dev, ...] int64 tensors on `device`; the all_gather plan
    (send_idx, ghost_src, recv_src, recv_dst) stays host numpy.  All hold
    the JAX package's values."""

    def __init__(self, unique_map: IndexMap, col_gids: List[np.ndarray],
                 device="cuda"):
        self.device = dev = resolve_device(device)
        n_dev = unique_map.n_parts
        self.n_dev = n_dev
        self.axis = DeviceAxis(n_dev, dev)
        self.n_owned = unique_map.local_sizes  # [n_dev]
        self.N_o = int(self.n_owned.max())
        owner = unique_map.owner_of()

        owned_lists = unique_map.partition_indices
        ghost_lists = []
        for p in range(n_dev):
            n_own = len(owned_lists[p])
            if not np.array_equal(col_gids[p][:n_own], owned_lists[p]):
                raise ValueError("col_gids must start with the owned gids")
            ghost_lists.append(np.asarray(col_gids[p][n_own:], np.int64))
        self.G = max(max((len(g) for g in ghost_lists), default=0), 1)

        # position of each global id within its owner's owned list
        pos_in_owner = np.full(unique_map.n_global, -1, dtype=np.int64)
        for p in range(n_dev):
            pos_in_owner[owned_lists[p]] = np.arange(len(owned_lists[p]))

        # send sets: the owned ids each part's neighbours hold as ghosts
        # (sorted by owner, then gid: np.unique of each owner's list)
        all_g = (np.concatenate(ghost_lists) if ghost_lists
                 else np.zeros(0, np.int64))
        all_o = owner[all_g].astype(np.int64)
        pairs = np.unique(all_o * unique_map.n_global + all_g)
        p_own, p_gid = pairs // unique_map.n_global, pairs % unique_map.n_global
        cuts = np.searchsorted(p_own, np.arange(n_dev + 1))
        send_gids = [p_gid[cuts[q]:cuts[q + 1]] for q in range(n_dev)]
        self.B = max(max((len(s) for s in send_gids), default=0), 1)
        # send_idx: positions in x_own to pull (pad 0: a value nobody reads)
        send_idx = _pad_stack([pos_in_owner[s] for s in send_gids], 0,
                              self.B, np.int64)

        # ghost_src: for each ghost gid of part p, the flat index
        # owner*B + slot into the all-gathered [n_dev, B] buffer
        slot = np.zeros(unique_map.n_global, np.int64)
        for q in range(n_dev):
            slot[send_gids[q]] = np.arange(len(send_gids[q]))
        ghost_src = _pad_stack(
            [owner[g].astype(np.int64) * self.B + slot[g]
             for g in ghost_lists], 0, self.G, np.int64)

        # export/add reverse plan: ghost contributions → owner rows.  For
        # owner p: the entries (q, k) with ghost_lists[q][k] owned by p, in
        # (q, k) order; destination = the local owned position
        base_q = np.repeat(np.arange(n_dev), [len(g) for g in ghost_lists])
        pos_k = (np.concatenate([np.arange(len(g)) for g in ghost_lists])
                 if ghost_lists else np.zeros(0, np.int64))
        order = np.argsort(all_o, kind="stable")
        cuts = np.searchsorted(all_o[order], np.arange(n_dev + 1))
        recv_src, recv_dst = [], []
        for p in range(n_dev):
            sel = order[cuts[p]:cuts[p + 1]]
            recv_src.append(base_q[sel] * self.G + pos_k[sel])
            recv_dst.append(pos_in_owner[all_g[sel]])
        self.R = max(max((len(s) for s in recv_src), default=0), 1)
        recv_src = _pad_stack(recv_src, 0, self.R, np.int64)
        # pad destination → N_o (an extra accumulator slot that is dropped)
        recv_dst = _pad_stack(recv_dst, self.N_o, self.R, np.int64)

        # ---- neighbour-wise ppermute schedule --------------------------
        # the partition neighbour graph, edge-coloured greedily; each colour
        # is one ppermute round moving only that pair's boundary
        pair_gids = {}  # (src q, dst p) -> gids owned by q ghosted on p
        for p in range(n_dev):
            gl = ghost_lists[p]
            if not len(gl):
                continue
            own = owner[gl]
            for q in np.unique(own):
                pair_gids[(int(q), p)] = np.sort(gl[own == q])
        edges = sorted({tuple(sorted((q, p))) for (q, p) in pair_gids})
        color_of = {}
        used = [set() for _ in range(n_dev)]
        for e in edges:
            c = 0
            while c in used[e[0]] or c in used[e[1]]:
                c += 1
            color_of[e] = c
            used[e[0]].add(c)
            used[e[1]].add(c)
        n_rounds = 1 + max(color_of.values()) if color_of else 0

        self._round_meta = []  # [(perm, W)]
        si_rounds, rev_rounds, exp_dst = [], [], []
        base = 0
        gidx = np.full((n_dev, self.G), -1, np.int64)
        for r in range(n_rounds):
            perm = []
            W = 1
            members = {}
            for e, c in color_of.items():
                if c != r:
                    continue
                a, b = e
                perm += [(a, b), (b, a)]
                members[a] = b
                members[b] = a
                W = max(W,
                        len(pair_gids.get((a, b), ())),
                        len(pair_gids.get((b, a), ())))
            si = np.zeros((n_dev, W), np.int64)    # owned positions to send
            rev = np.full((n_dev, W), self.G, np.int64)  # ghost-section pos
            n_send = np.zeros(n_dev, np.int64)
            for q, p in list(members.items()):
                g = pair_gids.get((q, p))
                if g is None:
                    continue
                si[q, : len(g)] = pos_in_owner[g]
                n_send[q] = len(g)
                # receiver p: where these land in its ghost section, and
                # their flat position in the concatenated recv stream
                gpos = np.searchsorted(ghost_lists[p], g)
                rev[p, : len(g)] = gpos
                gidx[p, gpos] = base + np.arange(len(g))
            self._round_meta.append((perm, W))
            si_rounds.append(si)
            rev_rounds.append(rev)
            # the exporter's scatter targets: the pad lanes go to a dump
            # slot N_o, so a round's targets in a shard are distinct
            exp_dst.append(np.where(np.arange(W)[None, :] < n_send[:, None],
                                    si, self.N_o))
            base += W
        self._recv_total = base
        gidx[gidx < 0] = base  # pad → the zero slot

        ix = lambda a: _dev_index(a, dev)  # noqa: E731
        self.send_idx, self.ghost_src = send_idx, ghost_src
        self.recv_src, self.recv_dst = recv_src, recv_dst
        # mask of real (non-pad) owned lanes
        self.owned_mask = torch.as_tensor(
            np.arange(self.N_o)[None, :] < self.n_owned[:, None], device=dev)
        si_t = tuple(ix(a) for a in si_rounds)
        self.import_arrays = (si_t, ix(gidx))
        self.export_arrays = (tuple(ix(a) for a in rev_rounds), si_t)
        # the sender of each shard in each round
        self._round_src = [self.axis.perm_source(perm)
                           for perm, _ in self._round_meta]
        self._exp_dst = tuple(ix(a) for a in exp_dst)

    def importer(self):
        """f(x_own [n_dev, N_o], import_arrays) → x_col [n_dev, N_o + G]."""
        srcs, axis = self._round_src, self.axis

        def imp(x_own, arrs):
            si_rounds, gidx = arrs
            bufs = [axis.ppermute(torch.gather(x_own, 1, si), src)
                    for si, src in zip(si_rounds, srcs)]
            bufs.append(x_own.new_zeros(x_own.shape[0], 1))  # pad-ghost slot
            stream = torch.cat(bufs, 1)
            return torch.cat([x_own, torch.gather(stream, 1, gidx)], 1)

        return imp

    def exporter(self):
        """f(y_col [n_dev, N_o + G], export_arrays) → y_own [n_dev, N_o]
        with the remote ghost contributions summed into their owners
        (Export/Add): each round sends ghost contributions back along the
        reversed pairs."""
        srcs, axis, N_o, dsts = self._round_src, self.axis, self.N_o, \
            self._exp_dst

        def exp(y_col, arrs):
            rev_rounds, _ = arrs
            n = y_col.shape[0]
            yg = torch.cat([y_col[:, N_o:], y_col.new_zeros(n, 1)], 1)
            y = torch.cat([y_col[:, :N_o], y_col.new_zeros(n, 1)], 1)
            for rv, src, dst in zip(rev_rounds, srcs, dsts):
                recv = axis.ppermute(torch.gather(yg, 1, rv), src)
                y = y.scatter_add(1, dst, recv)
            return y[:, :N_o]

        return exp

    def comm_stats(self) -> dict:
        """Per-apply exchange volume (elements per shard, worst case)."""
        pp = sum(w for _, w in self._round_meta)
        return {"rounds": len(self._round_meta),
                "ppermute_elems": pp,
                "allgather_elems": self.n_dev * int(self.B)}


def import_ghosts(x_own, send_idx, ghost_src):
    """The all_gather import: x_own [n_dev, N_o], send_idx [n_dev, B],
    ghost_src [n_dev, G] (host or device index arrays) → x_col
    [n_dev, N_o + G]."""
    send_idx, ghost_src = (_dev_index(a, x_own.device)
                           for a in (send_idx, ghost_src))
    buf = DeviceAxis.all_gather(torch.gather(x_own, 1, send_idx))
    ghosts = buf.reshape(-1)[ghost_src]
    return torch.cat([x_own, ghosts], 1)


def export_add(y_col, N_o, recv_src, recv_dst):
    """The all_gather export: y_col [n_dev, N_o + G] local contributions
    (owned ++ ghost rows) → y_own [n_dev, N_o] with the remote ghost
    contributions summed in (Tpetra Export, Add).  A part's recv_dst
    repeats a row for each neighbour ghosting it, so the sum goes through
    the fixed-order `scatter_sum` on the card."""
    n = y_col.shape[0]
    recv_src, recv_dst = (_dev_index(a, y_col.device)
                          for a in (recv_src, recv_dst))
    buf = DeviceAxis.all_gather(y_col[:, N_o:])
    vals = buf.reshape(-1)[recv_src]
    seg = (recv_dst + (N_o + 1) * torch.arange(
        n, device=y_col.device)[:, None]).reshape(-1)
    add = scatter_sum(vals.reshape(-1), seg, n * (N_o + 1))
    return y_col[:, :N_o] + add.view(n, N_o + 1)[:, :N_o]


class DistributedCsr:
    """Row-distributed sparse matrix in stacked per-shard ELL layout.

    Built on the host from a global CsrMatrix and a unique row map: rows go
    to their owners; a shard's column map is its owned ids and the column
    support of its rows (ghosts), which defines the halo plan of the SpMV.
    The tensors live on the matrix's device."""

    @classmethod
    def from_parts(cls, unique_map: IndexMap, col_gids: List[np.ndarray],
                   ell_cols, ell_data: torch.Tensor, K: int,
                   plan: Optional["HaloPlan"] = None,
                   row_lens: Optional[np.ndarray] = None,
                   ell_cols_host: Optional[np.ndarray] = None
                   ) -> "DistributedCsr":
        """Construct from per-shard data: col_gids[p] the local column map
        (owned ++ ghost gids); ell_cols [n_dev, K, N_o] column-map-local;
        ell_data [n_dev, K, N_o] the values (on the device they run on);
        row_lens [n_dev, N_o] the nonzeros of each row (needed by the
        symbolic locator of the preconditioner setup).  An int64 ell_cols
        already on that device is taken as it is, with its host copy
        `ell_cols_host` (a reassembly uploads no plan)."""
        obj = cls.__new__(cls)
        obj.n_global = unique_map.n_global
        obj.unique_map = unique_map
        obj.n_dev = unique_map.n_parts
        obj.K = K
        obj.device = ell_data.device
        obj.plan = (plan if plan is not None
                    else HaloPlan(unique_map, col_gids, device=obj.device))
        obj.col_gids = col_gids
        on_dev = (torch.is_tensor(ell_cols) and ell_cols.device == obj.device
                  and ell_cols.dtype == torch.int64)
        if ell_cols_host is None:
            ell_cols_host = (ell_cols.cpu() if torch.is_tensor(ell_cols)
                             else ell_cols)
        obj._ell_cols_host = np.asarray(ell_cols_host, np.int64)
        obj.ell_cols = (ell_cols if on_dev
                        else _dev_index(obj._ell_cols_host, obj.device))
        obj.ell_data = ell_data
        obj.row_lens = row_lens
        obj._locator = None
        return obj

    def __init__(self, global_csr: CsrMatrix, unique_map: IndexMap,
                 dtype=torch.float64):
        self.n_global = global_csr.shape[0]
        if global_csr.shape[0] != global_csr.shape[1]:
            raise ValueError("DistributedCsr requires a square matrix")
        if unique_map.n_global != self.n_global:
            raise ValueError("row map size mismatch")
        self.unique_map = unique_map
        self.device = global_csr.device
        n_dev = unique_map.n_parts
        self.n_dev = n_dev

        t0 = time.perf_counter()
        sp = global_csr.to_scipy()
        col_gids = []
        K = 0
        rows_info = []
        N_o = unique_map.max_local_size
        for p in range(n_dev):
            owned = unique_map.partition_indices[p]
            sub = sp[owned]  # [n_own, n_global] CSR
            ghosts = np.setdiff1d(np.unique(sub.indices), owned)
            col_gids.append(np.concatenate([owned, ghosts]))
            rows_info.append((sub, owned, ghosts))
            K = max(K, int(np.diff(sub.indptr).max()) if sub.nnz else 1)
        self.K = K
        t1 = time.perf_counter()
        self.plan = HaloPlan(unique_map, col_gids, device=self.device)
        t2 = time.perf_counter()
        if self.plan.N_o != N_o:
            raise AssertionError("plan width != the largest owned set")

        ell_cols = np.zeros((n_dev, K, N_o), dtype=np.int64)
        ell_data = np.zeros((n_dev, K, N_o), dtype=np.float64)
        row_lens = np.zeros((n_dev, N_o), dtype=np.int64)
        for p in range(n_dev):
            sub, owned_p, ghosts_p = rows_info[p]
            n_own = sub.shape[0]
            # transposed ELL [K, N_o]: rows along the contiguous axis; ghost
            # locals start at N_o (the x_col layout [owned padded | ghosts])
            lens = np.diff(sub.indptr)
            r = np.repeat(np.arange(n_own), lens)
            pos = np.arange(sub.nnz) - np.repeat(sub.indptr[:-1], lens)
            ell_cols[p, pos, r] = _col_local_ids(owned_p, ghosts_p,
                                                 sub.indices, N_o)
            ell_data[p, pos, r] = sub.data
            row_lens[p, :n_own] = lens
        self._ell_cols_host = ell_cols
        self.ell_cols = _dev_index(ell_cols, self.device)
        self.ell_data = torch.as_tensor(ell_data, dtype=dtype,
                                        device=self.device)
        self.col_gids = col_gids
        self.row_lens = row_lens
        self._locator = None
        # setup seconds: the shards' rows and column maps, the halo plan,
        # the ELL layout and its upload
        self.timings = {"rows_s": t1 - t0, "plan_s": t2 - t1,
                        "ell_s": time.perf_counter() - t2}

    def _cmap(self, p: int) -> np.ndarray:
        """Global gid of each column-map-local id of shard p (owned padded
        to N_o, then the ghosts)."""
        owned = self.unique_map.partition_indices[p]
        n_own, N_o = len(owned), self.plan.N_o
        n_gh = max(len(self.col_gids[p]) - n_own, 0)
        cmap = np.zeros(N_o + n_gh + 1, dtype=np.int64)
        cmap[:n_own] = owned
        cmap[N_o: N_o + n_gh] = self.col_gids[p][n_own:]
        return cmap

    def locator(self):
        """Symbolic global pattern locator (host, integers only): a scipy
        CSR over the global index space whose .data are 1 + flat positions
        into the stacked [n_dev, K, N_o] ELL values, so preconditioner setup
        addresses any entry without a global numeric matrix."""
        if self._locator is not None:
            return self._locator
        import scipy.sparse as sps

        if self.row_lens is None:
            raise ValueError("locator requires row_lens metadata")
        K, N_o = self.K, self.plan.N_o
        rows_l, cols_l, pos_l = [], [], []
        for p in range(self.n_dev):
            owned = self.unique_map.partition_indices[p]
            lens = self.row_lens[p][: len(owned)]
            kk, ii = np.nonzero(np.arange(K)[:, None] < lens[None, :])
            rows_l.append(owned[ii])
            cols_l.append(self._cmap(p)[self._ell_cols_host[p, kk, ii]])
            pos_l.append(1 + p * K * N_o + kk * N_o + ii)
        self._locator = sps.csr_matrix(
            (np.concatenate(pos_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(self.n_global, self.n_global))
        return self._locator

    def ell_host(self) -> np.ndarray:
        """Host copy of the stacked ELL values [n_dev, K, N_o], cached per
        value tensor (one process holds every shard; the multi-process
        gather is ROADMAP A10c)."""
        cached = getattr(self, "_host_ell", None)
        if cached is not None and cached[0] is self.ell_data:
            return cached[1]
        vals = self.ell_data.cpu().numpy()
        self._host_ell = (self.ell_data, vals)
        return vals

    def values_host(self) -> np.ndarray:
        """Flat host copy of the stacked ELL values (preconditioner setup:
        the f64 subdomain factorizations)."""
        return self.ell_host().reshape(-1)

    def local_rows(self, p: int):
        """(owned_gids, scipy CSR [n_own, n_global]) of shard p's owned
        rows — the row view preconditioner setup works from (GDSW harmonic
        extensions, RAP) without a global matrix."""
        import scipy.sparse as sps

        if self.row_lens is None:
            raise ValueError("local_rows requires row_lens metadata")
        owned = self.unique_map.partition_indices[p]
        n_own = len(owned)
        lens = self.row_lens[p][:n_own]
        ec = self._ell_cols_host[p]
        ed = self.ell_host()[p]
        kk, ii = np.nonzero(np.arange(self.K)[:, None] < lens[None, :])
        return owned, sps.csr_matrix(
            (ed[kk, ii], (ii, self._cmap(p)[ec[kk, ii]])),
            shape=(n_own, self.n_global))

    @staticmethod
    def local_matvec(ell_data, ell_cols, x_col):
        """ell_* [n_dev, K, N_o]; x_col [n_dev, N_o + G] → y [n_dev, N_o]."""
        n, K, N_o = ell_cols.shape
        xg = torch.gather(x_col, 1, ell_cols.reshape(n, K * N_o))
        return (ell_data * xg.view(n, K, N_o)).sum(1)

    def matvec_fn(self):
        """f(x_own, ell_data, ell_cols, send_idx, ghost_src) → y_own, the
        SpMV through the all_gather import."""
        def f(x_own, ell_data, ell_cols, send_idx, ghost_src):
            x_col = import_ghosts(x_own, send_idx, ghost_src)
            return self.local_matvec(ell_data, ell_cols, x_col)
        return f


# -- host-side vector scatter/gather ----------------------------------------


def lane_index(unique_map: IndexMap, N_o: int):
    """(gids, lanes): each owned global id and its lane p*N_o + i in the
    flattened stacked [n_dev, N_o] vector."""
    gids = (np.concatenate(unique_map.partition_indices)
            if unique_map.n_parts else np.zeros(0, np.int64))
    lanes = np.concatenate(
        [p * N_o + np.arange(len(ix))
         for p, ix in enumerate(unique_map.partition_indices)])
    return gids.astype(np.int64), lanes.astype(np.int64)


def distribute_vector(x_global, unique_map: IndexMap,
                      N_o: Optional[int] = None, device="cuda",
                      dtype=torch.float64) -> torch.Tensor:
    """Global [n] → stacked owned [n_dev, N_o] (zero-padded) on `device`."""
    N_o = N_o or unique_map.max_local_size
    xg = (x_global.detach().cpu().numpy() if torch.is_tensor(x_global)
          else np.asarray(x_global))
    gids, lanes = lane_index(unique_map, N_o)
    out = np.zeros(unique_map.n_parts * N_o, dtype=np.float64)
    out[lanes] = xg[gids]
    return torch.as_tensor(out.reshape(unique_map.n_parts, N_o), dtype=dtype,
                           device=resolve_device(device))


def collect_vector(x_dist, unique_map: IndexMap) -> np.ndarray:
    """Stacked owned [n_dev, N_o] → global [n] (host numpy)."""
    xd = (x_dist.detach().cpu().numpy() if torch.is_tensor(x_dist)
          else np.asarray(x_dist))
    gids, lanes = lane_index(unique_map, xd.shape[1])
    out = np.zeros(unique_map.n_global, dtype=xd.dtype)
    out[gids] = xd.reshape(-1)[lanes]
    return out
