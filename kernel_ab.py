#!/usr/bin/env python3
"""Time two or more builds of the port's CUDA kernels on one card, in turns.

Each build is a directory of CUDA sources with the C entries of
feddlib_tpu_torch/csrc/, for example an older commit's csrc/ unpacked in a
git-ignored directory.  At the shapes of chip_smoke.py's default run
(its own helpers build the operators), it times:
  - B1 at the ghost fetches of the Laplace main path and of the P1
    elasticity solve and at the entry and exit gathers of the P2 elasticity
    operator's split, back to back and with x and the plan out of L2, and
    the operator applies it runs in (the padded A(x) of both solves, the
    split apply), where it follows its real predecessor;
  - B2 on the padded SELL operator of the Laplace main path and of the P1
    elasticity solve, back to back and with the planes out of L2;
  - B3 at the level-1 shapes of both solves, and B4 at the main path's
    (random stores: a GEMV's time does not depend on the values), B4 also
    on the bench chain's bf16 level-1 inverse;
  - the bench chain's M(A(x)) apply;
  - B5 on the block-SELL residue of the P2 elasticity operator, back to
    back and with its inputs out of L2: a build with the sliced layout's
    entry (fedd_block_sell_slices_f32) reads that layout, an older build
    with only fedd_block_sell_spmv_f32 reads the planes (the same operator);
with the builds in the order A B .. B A, each a median of calls queued
behind a spin kernel (chip_smoke._device_ms), and beside them the one-call
PyTorch yardsticks, the byte bounds and the time of an empty launch.  Each
build's output is also held against the plain version.  Run from the
repository root on the card:

    mkdir -p .scratch/parent
    git archive a82472c feddlib_tpu_torch/csrc | tar -x -C .scratch/parent
    python3 kernel_ab.py \\
        --build parent=.scratch/parent/feddlib_tpu_torch/csrc --build change

--build NAME[=DIR]; DIR defaults to feddlib_tpu_torch/csrc.  --kernels
picks the kernels to time (default B1,B2,B3,B4,B5; B4 brings the bench
chain's M(A(x))).
Prints one line per time and writes them all to chiprun_out/kernel_ab.json.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain  # noqa: E402
from feddlib_tpu_torch.la import _cuda  # noqa: E402
from feddlib_tpu_torch.la import dense_kernels as dk  # noqa: E402
from feddlib_tpu_torch.la import permute as pm  # noqa: E402
from feddlib_tpu_torch.la import sell as sl  # noqa: E402
from feddlib_tpu_torch.solvers import linear  # noqa: E402

# B5's C entry in builds older than the sliced layout: the planes
_P = ctypes.c_void_p
_PLANES_B5 = {"fedd_block_sell_spmv_f32": [
    _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, _P]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--build", action="append", required=True,
                    help="NAME[=DIR]")
    ap.add_argument("--kernels", default="B1,B2,B3,B4,B5",
                    help="comma-separated kernels to time")
    args = ap.parse_args(argv)
    want = set(args.kernels.split(","))
    size = cs._parser().parse_args([])
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip() or torch.cuda.get_device_name(0)
    print(card, flush=True)

    builds = []
    for spec in args.build:
        name, _, path = spec.partition("=")
        path = os.path.abspath(path) if path else _cuda.CSRC_DIR
        builds.append((name, _cuda.load(_cuda.build(path), _PLANES_B5)))
        print(f"built {name} from {path}", flush=True)
    order = builds + builds[::-1]
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(kernel, shape, build, ms, **extra):
        rows.append({"kernel": kernel, "shape": shape, "build": build,
                     "ms": ms, **extra})
        more = " ".join(f"{k}={v}" for k, v in extra.items())
        print(f"  {kernel} [{shape}] {build}: {ms:.5f} ms {more}",
              flush=True)

    def turns(kernel, shape, fn, check=None, per_build=False):
        """fn() under each build in the order A B .. B A; `fn` is one call
        or a list of calls taken in turn (cs._cold_calls), or with
        `per_build` a function of the build's library that gives one."""
        for name, lib in order:
            _cuda.use(lib)
            f = fn(lib) if per_build else fn
            first = f[0] if isinstance(f, list) else f
            extra = {"rel_err": check(first())} if check else {}
            record(kernel, shape, name, cs._device_ms(torch, f), **extra)

    def rel(y, y0):
        return float((y - y0).abs().max() / y0.abs().max())

    def gemv_turns(blocks, xs):
        P, R, W = blocks.shape
        if blocks.dtype == torch.bfloat16:
            kernel, fn, plain = ("B4", dk.dense_block_mv_lowp,
                                 dk.dense_block_mv_lowp_plain)
            xs_b = xs.to(torch.bfloat16).unsqueeze(-1)
        else:
            kernel, fn, plain = ("B3", dk.dense_block_mv,
                                 dk.dense_block_mv_plain)
            xs_b = xs.unsqueeze(-1)
        shape = f"[{P}, {R}, {W}] {str(blocks.dtype).split('.')[-1]}"
        y0 = plain(blocks, xs)
        turns(kernel, shape, lambda: fn(blocks, xs), lambda y: rel(y, y0))
        record("torch.bmm", shape, "library",
               cs._device_ms(torch, lambda: torch.bmm(blocks, xs_b)))
        esz = blocks.element_size()
        bound = cs._bound(esz * P * R * W + 4 * P * W + 4 * P * R,
                          2 * P * R * W,
                          cs.PEAK_BF16_S if esz == 2 else cs.PEAK_F32_S)
        record("bound", shape, bound[1], bound[0])

    def b1_turns(where, idx, n_in):
        """B1 on one plan, back to back and out of L2, beside x[idx]."""
        x = torch.randn(n_in, generator=g, device=dev)
        y0 = pm.permute_gather_plain(x, idx)
        shape = f"{where}: n_in={n_in} n_out={idx.numel()}"

        def lib_call(x_ext, idx_lib):
            return x_ext[idx_lib]

        b1 = pm.permute_gather
        turns("B1", shape, lambda: b1(x, idx), lambda y: rel(y, y0))
        turns("B1 L2 cold", shape, cs._cold_calls(b1, x, idx),
              lambda y: rel(y, y0))
        x_ext = torch.cat([x, x.new_zeros(1)])
        idx_lib = torch.where(idx < 0, n_in, idx).long()
        record("x[idx]", shape, "library",
               cs._device_ms(torch, lambda: lib_call(x_ext, idx_lib)))
        record("x[idx] L2 cold", shape, "library", cs._device_ms(
            torch, cs._cold_calls(lib_call, x_ext, idx_lib)))
        record("bound", shape, "bytes",
               cs._bound(4 * n_in + 8 * idx.numel(), 0, cs.PEAK_F32_S)[0])
        # what the plan's scatter costs: the same sizes with an identity
        # plan (every gather instruction reads 128 contiguous bytes), and
        # the 32-byte sectors of x that the plan's gather instructions (32
        # consecutive outputs each) touch, against x's own
        n = idx.numel()
        ident = torch.arange(n, dtype=torch.int32, device=dev) % n_in
        turns("B1 identity plan", shape, lambda: b1(x, ident))
        pad = torch.full((-n % 32,), -1, dtype=idx.dtype, device=dev)
        sec = torch.cat([idx, pad]).reshape(-1, 32).long() // 8
        sec = torch.where(sec < 0, -1, sec).sort(dim=1).values
        distinct = ((sec[:, 1:] != sec[:, :-1]) & (sec[:, 1:] >= 0)).sum()
        distinct = int(distinct + (sec[:, 0] >= 0).sum())
        ratio = distinct / -(-n_in // 8)
        rows.append({"kernel": "x sectors", "shape": shape,
                     "sector_bytes": 32 * distinct, "ratio_to_x": ratio})
        print(f"  x sectors [{shape}]: {32 * distinct} bytes, {ratio:.3f} "
              f"x the sectors of x", flush=True)

    def b2_turns(where, Ac):
        """B2 on one padded SELL operator, back to back and out of L2,
        beside the two CSR calls."""
        nx2 = (Ac.shape[1] + 127) // 128
        x2d = torch.randn(nx2, 128, generator=g, device=dev)
        slots = Ac.vals.numel()
        stored = int((Ac.data_slots >= 0).sum())
        nonzero = int((Ac.vals != 0).sum())
        shape = (f"{where}: nchunks={Ac.vals.shape[0]} E={Ac.E} K={Ac.K} "
                 f"slots={slots} stored={stored} nonzero={nonzero}")
        y0 = sl.sell_spmv_plain(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)

        def b2(v, p, b):
            return sl.sell_spmv(v, p, b, x2d, Ac.E)

        def mv(c):
            return c @ xcol

        turns("B2", shape, lambda: b2(Ac.vals, Ac.pidx, Ac.bids),
              lambda y: rel(y, y0))
        turns("B2 L2 cold", shape,
              cs._cold_calls(b2, Ac.vals, Ac.pidx, Ac.bids),
              lambda y: rel(y, y0))
        xcol = x2d.reshape(-1)
        for kind, st in (("nonzero", False), ("stored", True)):
            csr = cs._sell_to_torch_csr(torch, Ac, stored=st)
            record("torch CSR", shape, kind,
                   cs._device_ms(torch, lambda: mv(csr)))
            record("torch CSR L2 cold", shape, kind,
                   cs._device_ms(torch, cs._cold_calls(mv, csr)))
            del csr
        bound = cs._bound(6 * slots + 4 * Ac.bids.numel() + 4 * x2d.numel()
                          + 4 * (slots // Ac.E), 2 * nonzero, cs.PEAK_F32_S)
        record("bound", shape, bound[1], bound[0])

    if "B1" in want:
        record("launch floor", "torch.cuda._sleep(0)", "empty launch",
               cs._device_ms(torch, lambda: torch.cuda._sleep(0)))

    # -- B1 and B2 at the main path's and the elasticity solve's shapes; B4
    # and B3 at the main path's level-1 shape --------------------------------
    ops = (("main path", lambda: cs._laplace(torch, size.n, size.clusters,
                                             dev), size.clusters),
           ("elasticity solve", lambda: cs._linelas(
               torch, Domain.structured(3, size.n_solve, device=dev), {},
               dev), size.solve_clusters))
    for where, make, clusters in ops:
        prob = make()
        A = prob.bc_system().get_block(0, 0)
        mesh = prob.domains[0].mesh
        db, split = linear.point_cluster_operators(
            A, mesh.points, clusters, A.shape[0] // mesh.n_points)
        Ac = split.Ac
        del prob, A
        if "B1" in want:
            b1_turns(where, db.ghost_plan[0], db.P * db.R)
            # the padded A(x): B1, then B2; in a loop B1 follows B2
            fn, fops = split.operator()
            xa = torch.randn(db.P * db.R, generator=g, device=dev)
            turns("A(x) apply", where, lambda: fn(fops, xa))
        if "B2" in want:
            b2_turns(where, Ac)
        del Ac, split
        torch.cuda.empty_cache()
        P, R, W = db.P, db.R, db.R + db.G
        gemv = [torch.float32] if "B3" in want else []
        if "B4" in want and where == "main path":
            gemv.insert(0, torch.bfloat16)
        for dt in gemv:
            gemv_turns(torch.randn(P, R, W, generator=g, device=dev).to(dt),
                       torch.randn(P, W, generator=g, device=dev))
            torch.cuda.empty_cache()
        del db

    # -- the bench chain: B4 on its bf16 level-1 inverse, M(A(x)) ------------
    if "B4" in want:
        bc = cs._bench_chain(torch, np, size.n_bench, size.bench_clusters,
                             dev)
        inv = bc.prec.level1.inv
        gemv_turns(inv, torch.randn(inv.shape[0], inv.shape[2], generator=g,
                                    device=dev))
        xp = torch.ones(bc.db.P * bc.db.R, device=dev)
        turns("M(A(x))", f"bench chain n={size.n_bench}",
              lambda: bc.M_fn(bc.M_ops, bc.A_fn(bc.A_ops, xp)))
        del bc, inv, xp
        torch.cuda.empty_cache()

    # -- the P2 elasticity operator's split: B1's gathers, B5's residue -------
    if want & {"B1", "B5"}:
        from feddlib_tpu_torch.la.dia import auto_spmv

        prob = cs._linelas(torch, Domain.structured(
            3, size.n_elas, device=dev).p2_domain(), {}, dev)
        A = prob.bc_system().get_block(0, 0)
        F = auto_spmv(A, dtype=torch.float32, dofs_per_node=3)
        del prob, A
        if "B1" in want:
            where = f"P2 elasticity split n={size.n_elas}"
            b1_turns(where + ", entry gather", F.gin.idx, F.gin.n_in)
            b1_turns(where + ", exit gather", F.gout.idx, F.gout.n_in)
            # the split apply: B1, block-DIA + B5 and their sum, B1
            fn, fops = F.operator()
            x5 = torch.randn(F.shape[0], generator=g, device=dev)
            turns("split apply", where, lambda: fn(fops, x5))
        if "B5" in want:
            b5_turns(dev, F.sell, size.n_elas, g, turns, record, rel)
        del F

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"card": card, "rows": len(rows)}))
    return 0


def b5_turns(dev, bs, n_elas, g, turns, record, rel):
    """B5 on the residue `bs` of phase 5's operator: the sliced layout
    against the planes, whichever a build reads, with the CSR yardstick and
    the three bounds of chip_smoke.py."""
    lay, pl, d = bs.layout, bs.plan, bs.d
    nn = bs.shape[0] // d
    nx2 = (nn + 127) // 128
    x2d = torch.randn(d * nx2, 128, generator=g, device=dev)
    xp = x2d.reshape(d, -1)
    n_planes = bs.vals.shape[0] * 8 * (128 // lay.E)
    y0 = sl.block_sell_slices_plain(bs.hvals, pl.hcols, pl.slice_ptr,
                                    pl.row_of, xp, nn)

    def sliced(hv, hc, sp, ro):
        return sl.block_sell_slices(hv, hc, sp, ro, xp, nn)

    def make(lib, cold=False):
        if hasattr(lib, "fedd_block_sell_slices_f32"):
            fn, args = sliced, (bs.hvals, pl.hcols, pl.slice_ptr, pl.row_of)
        else:
            def fn(v, p, b):
                y = torch.empty((d, n_planes), device=dev)
                _cuda.check(lib.fedd_block_sell_spmv_f32(
                    v.data_ptr(), p.data_ptr(), b.data_ptr(),
                    x2d.data_ptr(), y.data_ptr(), v.shape[0], b.shape[1],
                    lay.E, d, nx2, _cuda.stream_of(v)), "planes B5")
                return y[:, :nn]
            args = (bs.vals, lay.pidx, lay.bids)
        if cold:
            return cs._cold_calls(fn, *args)
        return lambda: fn(*args)

    stored = int((bs.vals != 0).sum())
    shape = (f"P2 elasticity residue n={n_elas}: node_rows={nn} E={lay.E} "
             f"slices={pl.slice_ptr.numel() - 1} sigma={sl.SORT_WINDOW} "
             f"slots_per_occupied={pl.slots_per_occupied:.4f} "
             f"stored_nonzeros={stored}")
    turns("B5", shape, make, lambda y: rel(y, y0), per_build=True)
    turns("B5 L2 cold", shape, lambda lib: make(lib, cold=True),
          lambda y: rel(y, y0), per_build=True)
    xcol = x2d.reshape(-1)
    csr = cs._block_sell_to_torch_csr(torch, bs)
    record("torch CSR", shape, "nonzero",
           cs._device_ms(torch, lambda: csr @ xcol))
    record("torch CSR L2 cold", shape, "nonzero",
           cs._device_ms(torch, cs._cold_calls(lambda c: c @ xcol, csr)))
    xy = 4 * d * nn * 2
    for kind, n_bytes in (
            ("planes", 4 * bs.vals.numel() + 2 * lay.pidx.numel()
             + 4 * lay.bids.numel() + 4 * x2d.numel() + 4 * d * nn),
            ("layout", 4 * bs.hvals.numel() + pl.nbytes() + xy),
            ("any format", 4 * stored + 4 * pl.n_occupied + xy)):
        record("bound", shape, kind,
               cs._bound(n_bytes, 2 * stored, cs.PEAK_F32_S)[0])


if __name__ == "__main__":
    sys.exit(main())
