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

Shards stacked: where the JAX package runs one shard_map program per
device, here a process stacks its shards into one [n_local, ...] tensor on
one torch device (the layout the JAX package stacks on the host before
shard_map).  In one process n_local = n_dev and each collective is a
tensor operation over the leading axis; with several processes
(parallel/multihost.py) each rank holds a contiguous range of shards and
the collectives add the process group's transfers.  The plans, the rounds
and the values they move are the JAX package's.  Owned vectors are
zero-padded to the largest local size; the padded lanes stay zero through
the SpMV, the preconditioners and the Krylov updates.

Local matrix layout: rows = owned dofs (padded), columns in column-map
local numbering [owned (padded to N_o) | ghosts], transposed ELL [K, N_o]
per shard.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix, scatter_sum
from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.utils.device import resolve_device


def shard_ranges(n_dev: int, world: int):
    """[(lo, hi)] of each rank: contiguous shard ranges, the first
    n_dev % world ranks one shard longer."""
    base, extra = divmod(int(n_dev), int(world))
    out, lo = [], 0
    for r in range(world):
        hi = lo + base + (1 if r < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


class _RankedPerm:
    """A ppermute round of one rank: `local` [n_local] the local sender of
    each local receiver (n_local: from no local shard), and per peer rank
    the local rows it sends there and the local rows it fills, both in the
    order of the global (src, dst) pairs."""

    def __init__(self, local, peers):
        self.local = local
        self.peers = peers  # [(peer, send_rows, recv_rows)]


@dataclass
class DeviceAxis:
    """The domain-decomposition axis of `n_dev` shards.

    Without a process group (`group` None) every shard is stacked on
    `device` and the collectives act on the leading axis of [n_dev, ...]
    tensors.  With one, this rank holds the shards [lo, hi) stacked on
    `device` — every per-shard tensor is [hi − lo, ...] — and the
    collectives go through the group (parallel/multihost.py)."""

    n_dev: int
    device: torch.device
    group: object = None
    rank: int = 0
    world: int = 1
    lo: int = 0
    hi: Optional[int] = None
    backend: Optional[str] = None
    #: cross-rank traffic: bytes sent (this rank), seconds in the
    #: collectives (host clock; exact where the transfer is synchronous,
    #: as gloo's), and the number of collective calls
    xfer: dict = field(default_factory=lambda: {"bytes": 0, "seconds": 0.0,
                                                "calls": 0})

    def __post_init__(self):
        if self.hi is None:
            self.hi = self.n_dev
        self._host_bufs = {}

    @classmethod
    def make(cls, n_dev: int, device="cuda", **ranks) -> "DeviceAxis":
        return cls(int(n_dev), resolve_device(device), **ranks)

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    @property
    def ranks(self):
        return shard_ranges(self.n_dev, self.world)

    @property
    def _staged(self) -> bool:
        """gloo moves host memory: device tensors go through pinned host
        buffers (chosen by the backend's name)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_xfer(self) -> None:
        self.xfer.update(bytes=0, seconds=0.0, calls=0)

    # -- host plans → this rank's rows ---------------------------------------
    def put(self, a, dtype=None) -> torch.Tensor:
        """Rows [lo, hi) of a stacked host array [n_dev, ...] on the
        device (all of it without ranks)."""
        if self.group is not None:
            a = a[self.lo:self.hi]
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def ix(self, a) -> torch.Tensor:
        return self.put(a, torch.int64)

    def rank_of(self, shard: int) -> int:
        for r, (lo, hi) in enumerate(self.ranks):
            if lo <= shard < hi:
                return r
        raise ValueError(f"shard {shard} outside [0, {self.n_dev})")

    # -- collectives -----------------------------------------------------------
    def perm_source(self, perm):
        """The round `perm` ((src, dst) shard pairs, a matching) for
        `ppermute`: without ranks (or when no pair of this rank crosses to
        another) the [n_local] local sender of each local shard, n_local
        where a shard receives nothing from a local one; else a
        `_RankedPerm` that adds the cross-rank rows."""
        lo, hi, n = self.lo, self.hi, self.n_local
        src = np.full(n, n, np.int64)
        sends, recvs = {}, {}
        for s, d in sorted(perm):
            s_in, d_in = lo <= s < hi, lo <= d < hi
            if s_in and d_in:
                src[d - lo] = s - lo
            elif s_in:
                sends.setdefault(self.rank_of(d), []).append(s - lo)
            elif d_in:
                recvs.setdefault(self.rank_of(s), []).append(d - lo)
        local = torch.as_tensor(src, device=self.device)
        if self.group is None or not (sends or recvs):
            return local
        ix = lambda v: torch.as_tensor(np.asarray(v, np.int64),  # noqa: E731
                                       device=self.device)
        peers = [(r, ix(sends.get(r, [])), ix(recvs.get(r, [])))
                 for r in sorted(set(sends) | set(recvs))]
        return _RankedPerm(local, peers)

    def ppermute(self, buf: torch.Tensor, perm) -> torch.Tensor:
        """out[dst] = buf[src] for each (src, dst) of `perm`, zeros for a
        shard that receives nothing (`lax.ppermute`); buf and out are this
        rank's [n_local, ...].  `perm` is the pair list or its
        `perm_source`."""
        if not torch.is_tensor(perm) and not isinstance(perm, _RankedPerm):
            perm = self.perm_source(perm)
        local = perm if torch.is_tensor(perm) else perm.local
        zero = buf.new_zeros((1,) + tuple(buf.shape[1:]))
        out = torch.cat([buf, zero]).index_select(0, local)
        if torch.is_tensor(perm):
            return out
        got = self._exchange([(r, buf.index_select(0, s), len(rv))
                              for r, s, rv in perm.peers])
        for (_, _, rv), g in zip(perm.peers, got):
            if len(rv):
                out.index_copy_(0, rv, g)
        return out

    def _exchange(self, items):
        """One batch of point-to-point transfers: items (peer, send rows
        [m, ...], rows to receive) → the received [rows, ...] per item."""
        dist = _dist()
        t0 = time.perf_counter()
        ops, recv = [], []
        for r, snd, n_recv in items:
            shape = (n_recv,) + tuple(snd.shape[1:])
            if self._staged:
                sb = self._host_buf(("s", r), snd.shape, snd.dtype)
                sb.copy_(snd)
                rb = self._host_buf(("r", r), shape, snd.dtype)
            else:
                sb = snd.contiguous()
                rb = snd.new_empty(shape)
            if sb.numel():
                ops.append(dist.P2POp(dist.isend, sb, r, self.group))
                self.xfer["bytes"] += sb.numel() * sb.element_size()
            if rb.numel():
                ops.append(dist.P2POp(dist.irecv, rb, r, self.group))
            recv.append(rb)
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out = [rb.to(self.device) if self._staged else rb for rb in recv]
        self.xfer["seconds"] += time.perf_counter() - t0
        self.xfer["calls"] += 1
        return out

    def _host_buf(self, key, shape, dtype):
        """A pinned host buffer reused per (key, shape, dtype); every
        transfer through it completes before the call returns."""
        k = (key, tuple(shape), dtype)
        b = self._host_bufs.get(k)
        if b is None:
            b = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self._host_bufs[k] = b
        return b

    def allsum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of a per-rank tensor over the ranks (identity without
        ranks)."""
        if self.group is None:
            return t
        dist = _dist()
        t0 = time.perf_counter()
        if self._staged:
            h = self._host_buf("sum", t.shape, t.dtype)
            h.copy_(t)
            dist.all_reduce(h, group=self.group)
            out = h.to(self.device)
        else:
            out = t.clone()
            dist.all_reduce(out, group=self.group)
        self.xfer["bytes"] += out.numel() * out.element_size()
        self.xfer["seconds"] += time.perf_counter() - t0
        self.xfer["calls"] += 1
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the shards of x [n_local, ...]; every shard sees the
        same value, so the result keeps one copy [...]."""
        return self.allsum(x.sum(0))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard sees all of x: this rank's [n_local, ...] → [n_dev,
        ...] (the stacked tensor is already that view)."""
        if self.group is None:
            return x
        dist = _dist()
        t0 = time.perf_counter()
        cnt = max(hi - lo for lo, hi in self.ranks)
        shape = (cnt,) + tuple(x.shape[1:])
        pad = (self._host_buf("gather", shape, x.dtype) if self._staged
               else x.new_empty(shape))
        pad[: x.shape[0]] = x  # rows past this rank's count are not read
        full = (self._host_buf("gathered", (self.world,) + shape, x.dtype)
                if self._staged else x.new_empty((self.world,) + shape))
        full = full.view((self.world * cnt,) + tuple(x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(full, pad, group=self.group)
        rows = torch.as_tensor(np.concatenate(
            [r * cnt + np.arange(hi - lo) for r, (lo, hi)
             in enumerate(self.ranks)]), device=full.device)
        out = full.index_select(0, rows).to(self.device)
        self.xfer["bytes"] += pad.numel() * pad.element_size()
        self.xfer["seconds"] += time.perf_counter() - t0
        self.xfer["calls"] += 1
        return out

    def broadcast(self, t: torch.Tensor, src_rank: int) -> torch.Tensor:
        """`t` of rank `src_rank` on every rank (identity without ranks)."""
        if self.group is None:
            return t
        dist = _dist()
        t0 = time.perf_counter()
        if self._staged:
            h = self._host_buf("bcast", t.shape, t.dtype)
            h.copy_(t)
        else:
            h = t.contiguous()
        dist.broadcast(h, src_rank, group=self.group)
        self.xfer["bytes"] += h.numel() * h.element_size()
        self.xfer["seconds"] += time.perf_counter() - t0
        self.xfer["calls"] += 1
        return h.to(self.device)


def _dist():
    import torch.distributed as dist

    return dist


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
    ascending — the local column map).  The plan is global on the host;
    the rounds' index arrays are this rank's rows ([n_local, ...] int64
    tensors on the axis' device: all [n_dev, ...] without ranks); the
    all_gather plan (send_idx, ghost_src, recv_src, recv_dst) stays host
    numpy.  All hold the JAX package's values."""

    def __init__(self, unique_map: IndexMap, col_gids: List[np.ndarray],
                 device="cuda", axis: Optional[DeviceAxis] = None):
        n_dev = unique_map.n_parts
        if axis is None:
            axis = DeviceAxis(n_dev, resolve_device(device))
        elif axis.n_dev != n_dev:
            raise ValueError("device axis size != the map's part count")
        self.device = axis.device
        self.n_dev = n_dev
        self.axis = axis
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

        ix = axis.ix  # this rank's rows of a stacked host plan
        self.send_idx, self.ghost_src = send_idx, ghost_src
        self.recv_src, self.recv_dst = recv_src, recv_dst
        # mask of real (non-pad) owned lanes
        self.owned_mask = axis.put(
            np.arange(self.N_o)[None, :] < self.n_owned[:, None])
        si_t = tuple(ix(a) for a in si_rounds)
        self.import_arrays = (si_t, ix(gidx))
        self.export_arrays = (tuple(ix(a) for a in rev_rounds), si_t)
        # the sender of each shard in each round
        self._round_src = [self.axis.perm_source(perm)
                           for perm, _ in self._round_meta]
        self._exp_dst = tuple(ix(a) for a in exp_dst)

    def importer(self):
        """f(x_own [n_local, N_o], import_arrays) → x_col [n_local,
        N_o + G]."""
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
        """f(y_col [n_local, N_o + G], export_arrays) → y_own [n_local,
        N_o] with the remote ghost contributions summed into their owners
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


def _rows(axis, a, device):
    """This rank's rows of a stacked index array (host or device)."""
    if axis is not None and axis.group is not None:
        a = a[axis.lo:axis.hi]
    return _dev_index(a, device)


def import_ghosts(x_own, send_idx, ghost_src, axis=None):
    """The all_gather import: x_own [n_local, N_o], send_idx [n_dev, B],
    ghost_src [n_dev, G] (host or device index arrays) → x_col
    [n_local, N_o + G].  `axis` None: the shards stacked in one
    process."""
    dev = x_own.device
    buf = torch.gather(x_own, 1, _rows(axis, send_idx, dev))
    if axis is not None:
        buf = axis.all_gather(buf)
    ghosts = buf.reshape(-1)[_rows(axis, ghost_src, dev)]
    return torch.cat([x_own, ghosts], 1)


def export_add(y_col, N_o, recv_src, recv_dst, axis=None):
    """The all_gather export: y_col [n_local, N_o + G] local contributions
    (owned ++ ghost rows) → y_own [n_local, N_o] with the remote ghost
    contributions summed in (Tpetra Export, Add).  A part's recv_dst
    repeats a row for each neighbour ghosting it, so the sum goes through
    the fixed-order `scatter_sum` on the card."""
    n = y_col.shape[0]
    recv_src, recv_dst = (_rows(axis, a, y_col.device)
                          for a in (recv_src, recv_dst))
    buf = y_col[:, N_o:]
    if axis is not None:
        buf = axis.all_gather(buf)
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
    The host plans are global; the device tensors hold the shards of the
    axis' rank ([n_local, K, N_o]: every shard without ranks)."""

    @classmethod
    def from_parts(cls, unique_map: IndexMap, col_gids: List[np.ndarray],
                   ell_cols, ell_data: torch.Tensor, K: int,
                   plan: Optional["HaloPlan"] = None,
                   row_lens: Optional[np.ndarray] = None,
                   ell_cols_host: Optional[np.ndarray] = None,
                   axis: Optional[DeviceAxis] = None) -> "DistributedCsr":
        """Construct from per-shard data: col_gids[p] the local column map
        (owned ++ ghost gids); ell_cols column-map-local (this rank's
        [n_local, K, N_o] on the device, or the host [n_dev, K, N_o]);
        ell_data [n_local, K, N_o] the values (on the device they run on);
        row_lens [n_dev, N_o] the nonzeros of each row (needed by the
        symbolic locator of the preconditioner setup).  An int64 ell_cols
        already on that device is taken as it is, with its global host copy
        `ell_cols_host` (a reassembly uploads no plan).  The axis is the
        plan's, else `axis`, else the stacked one."""
        obj = cls.__new__(cls)
        obj.n_global = unique_map.n_global
        obj.unique_map = unique_map
        obj.n_dev = unique_map.n_parts
        obj.K = K
        obj.device = ell_data.device
        if plan is None:
            axis = axis or DeviceAxis(obj.n_dev, obj.device)
            plan = HaloPlan(unique_map, col_gids, axis=axis)
        obj.plan = plan
        obj.axis = plan.axis
        obj.col_gids = col_gids
        on_dev = (torch.is_tensor(ell_cols) and ell_cols.device == obj.device
                  and ell_cols.dtype == torch.int64)
        if ell_cols_host is None:
            if on_dev and obj.axis.group is not None:
                raise ValueError("a rank's ell_cols needs its global host "
                                 "copy ell_cols_host")
            ell_cols_host = (ell_cols.cpu() if torch.is_tensor(ell_cols)
                             else ell_cols)
        obj._ell_cols_host = np.asarray(ell_cols_host, np.int64)
        obj.ell_cols = (ell_cols if on_dev
                        else obj.axis.ix(obj._ell_cols_host))
        obj.ell_data = ell_data
        obj.row_lens = row_lens
        obj._locator = None
        return obj

    def __init__(self, global_csr: CsrMatrix, unique_map: IndexMap,
                 dtype=torch.float64, axis: Optional[DeviceAxis] = None):
        self.n_global = global_csr.shape[0]
        if global_csr.shape[0] != global_csr.shape[1]:
            raise ValueError("DistributedCsr requires a square matrix")
        if unique_map.n_global != self.n_global:
            raise ValueError("row map size mismatch")
        self.unique_map = unique_map
        n_dev = unique_map.n_parts
        self.n_dev = n_dev
        if axis is None:
            axis = DeviceAxis(n_dev, global_csr.device)
        self.axis = axis
        self.device = axis.device

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
        self.plan = HaloPlan(unique_map, col_gids, axis=axis)
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
        self.ell_cols = axis.ix(ell_cols)
        self.ell_data = axis.put(ell_data, dtype)
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
        """Host copy of the ELL values of every shard [n_dev, K, N_o],
        cached per value tensor: with ranks, the remote shards are gathered
        once (the JAX package's process_allgather; the replicated host
        setup of the preconditioners reads every shard's rows).  Every
        rank must call it."""
        cached = getattr(self, "_host_ell", None)
        if cached is not None and cached[0] is self.ell_data:
            return cached[1]
        ed = self.ell_data
        if self.axis.group is not None:
            ed = self.axis.all_gather(ed.reshape(ed.shape[0], -1)).view(
                self.n_dev, *ed.shape[1:])
        vals = ed.cpu().numpy()
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
        """ell_* [n_local, K, N_o]; x_col [n_local, N_o + G] → y [n_local,
        N_o]."""
        n, K, N_o = ell_cols.shape
        xg = torch.gather(x_col, 1, ell_cols.reshape(n, K * N_o))
        return (ell_data * xg.view(n, K, N_o)).sum(1)

    def matvec_fn(self):
        """f(x_own, ell_data, ell_cols, send_idx, ghost_src) → y_own, the
        SpMV through the all_gather import."""
        axis = self.axis

        def f(x_own, ell_data, ell_cols, send_idx, ghost_src):
            x_col = import_ghosts(x_own, send_idx, ghost_src, axis)
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


def local_lanes(unique_map: IndexMap, N_o: int,
                axis: Optional[DeviceAxis] = None):
    """(gids, lanes) of `lane_index` restricted to the shards of the axis'
    rank, the lanes counted from its first shard (all of them without
    ranks)."""
    gids, lanes = lane_index(unique_map, N_o)
    if axis is None or axis.group is None:
        return gids, lanes
    sel = (lanes >= axis.lo * N_o) & (lanes < axis.hi * N_o)
    return gids[sel], lanes[sel] - axis.lo * N_o


def distribute_vector(x_global, unique_map: IndexMap,
                      N_o: Optional[int] = None, device="cuda",
                      dtype=torch.float64,
                      axis: Optional[DeviceAxis] = None) -> torch.Tensor:
    """Global [n] → owned [n_dev, N_o] (zero-padded) on `device`; with an
    axis, its rank's rows on the axis' device."""
    N_o = N_o or unique_map.max_local_size
    xg = (x_global.detach().cpu().numpy() if torch.is_tensor(x_global)
          else np.asarray(x_global))
    gids, lanes = lane_index(unique_map, N_o)
    out = np.zeros(unique_map.n_parts * N_o, dtype=np.float64)
    out[lanes] = xg[gids]
    out = out.reshape(unique_map.n_parts, N_o)
    if axis is not None:
        return axis.put(out, dtype)
    return torch.as_tensor(out, dtype=dtype, device=resolve_device(device))


def collect_vector(x_dist, unique_map: IndexMap,
                   axis: Optional[DeviceAxis] = None) -> np.ndarray:
    """Owned [n_dev, N_o] → global [n] (host numpy).  With an axis, x_dist
    is its rank's rows, gathered first: every rank gets the full vector
    (every rank must call it)."""
    if axis is not None:
        x_dist = axis.all_gather(x_dist)
    xd = (x_dist.detach().cpu().numpy() if torch.is_tensor(x_dist)
          else np.asarray(x_dist))
    gids, lanes = lane_index(unique_map, xd.shape[1])
    out = np.zeros(unique_map.n_global, dtype=xd.dtype)
    out[gids] = xd.reshape(-1)[lanes]
    return out
