#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feddlib_tpu_torch) on one NVIDIA
Hopper card.  Run from the repository root:  python3 chip_smoke.py

Phases (each prints its seconds; any failed check raises and the script
exits non-zero):
  1. build the CUDA kernels of csrc/ with nvcc for sm_90a;
  2. main path: Laplace on Domain.structured(3, 64) (P1, 274,625 dofs),
     'Use Mixed Precision' + 'TwoLevel' with 512 clusters, solved to 1e-8
     through Problem.solve; the f64 residual is recomputed on the host with
     scipy, the kernel launch counters must show B1, B2 and B3; a small
     solve on the card must match the same solve on the CPU;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B4 at phase 4's), timed beside a one-call PyTorch
     yardstick and the card's bound for the same work;
  4. the bench-chain configuration at Domain.structured(3, 40) (68,921
     dofs): additive two-level Schwarz with bf16 level-1 and coarse stores,
     the M(A(x)) apply time, and the refinement to 1e-8 (B4 must launch).

Prints one `{"kernels": [...]}` JSON line, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.  Exits non-zero without
a result when no CUDA device is visible or the package is missing.
"""

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, f32 on the CUDA cores,
# dense bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12


def _phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _device_ms(torch, fn, samples=25, calls=20):
    """Median device time of one call: each sample queues `calls` calls
    behind a spin kernel, so the host's launch overhead is hidden."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        torch.cuda._sleep(50_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return statistics.median(out)


def _bound(n_bytes, n_ops, peak_ops):
    t_b, t_o = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def _laplace(torch, n, clusters, device):
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    pl = ParameterList("P", {"Use Mixed Precision": True, "TwoLevel": True,
                             "Clusters": clusters,
                             "Convergence Tolerance": 1e-8})
    prob = Laplace(Domain.structured(3, n, device=device), parameter_list=pl,
                   device=device)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def _sell_to_torch_csr(torch, sm):
    """The SELL planes back to a torch CSR tensor (the B2 yardstick)."""
    E = sm.E
    nch = sm.vals.shape[0]
    vals = sm.vals.reshape(-1)
    p = sm.pidx.reshape(nch, -1).long()
    cols = (torch.gather(sm.bids.long(), 1, p >> 7) * 128
            + (p & 127)).reshape(-1)
    rows = torch.arange(vals.numel(), device=vals.device) // E
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if sm.spill_rows is not None:
        rows = torch.cat([rows, sm.spill_rows])
        cols = torch.cat([cols, sm.spill_cols])
        vals = torch.cat([vals, sm.spill_vals])
    nx = (sm.shape[1] + 127) // 128 * 128
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (sm.shape[0], nx)).coalesce()
    return coo.to_sparse_csr()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=64,
                    help="cells per side of the main-path cube")
    ap.add_argument("--clusters", type=int, default=512)
    ap.add_argument("--n-bench", type=int, default=40,
                    help="cells per side of the bench-chain cube")
    ap.add_argument("--bench-clusters", type=int, default=512)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.la import dense_kernels as dk
    from feddlib_tpu_torch.la import permute as pm
    from feddlib_tpu_torch.la import sell as sl

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else name
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.lib()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())
    print(f"kernels built: {lib_path}")
    _phase("1 build", t0)

    # -- phase 2: main path ---------------------------------------------------
    t0 = time.perf_counter()
    _cuda.reset_launch_counts()
    prob = _laplace(torch, args.n, args.clusters, dev)
    t_setup = time.perf_counter()
    iters = prob.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t_setup
    counts2 = dict(_cuda.launch_counts)
    u = prob.solution[0]
    _check(u.dtype == torch.float64 and u.shape[0] == (args.n + 1) ** 3,
           "solution dtype/shape")
    _check(bool(torch.isfinite(u).all()), "finite solution")
    A_sp = prob.bc_system().get_block(0, 0).to_scipy()
    b_np = prob.rhs[0].cpu().numpy()
    rel_host = float(np.linalg.norm(b_np - A_sp @ u.cpu().numpy())
                     / np.linalg.norm(b_np))
    cache = prob._mixed_cache
    db, split, prec = cache["db32"], cache["sell"], cache["prec"]
    # the same solve again with the built preconditioner: the refinement
    # and inner GMRES time alone
    t_ir = time.perf_counter()
    iters_again = prob.solve()
    torch.cuda.synchronize()
    t_ir = time.perf_counter() - t_ir
    _check(abs(iters_again - iters) <= 2, "repeated solve iterations")
    print(f"main path: n_dofs={A_sp.shape[0]} nnz={A_sp.nnz} P={db.P} "
          f"R={db.R} G={db.G} W={db.R + db.G} E={split.Ac.E} "
          f"K={split.Ac.K} coarse_dim={prec.n_coarse}")
    print(f"main path: ir_passes={prob.last_passes} inner_iters={iters} "
          f"relres={prob.last_relres:.3e} host_f64_relres={rel_host:.3e} "
          f"setup_s={t_setup - t0:.3f} solve_s={t_solve:.3f} "
          f"ir_s={t_ir:.3f} "
          f"prec_timings={ {k: round(v, 3) for k, v in prec.timings.items()} }")
    print(f"main path launches: {counts2} "
          f"(per inner iteration: "
          f"{ {k: round(v / max(iters, 1), 2) for k, v in counts2.items()} })",
          flush=True)
    _check(rel_host <= 1e-8, f"host f64 residual {rel_host} > 1e-8")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(counts2[k] > 0, f"main path launched no {k}")
    # the same small solve on the card and on the CPU (plain versions)
    small = {}
    for d in ("cuda", "cpu"):
        p = _laplace(torch, 10, 8, d)
        small[d] = (p.solve(), p.last_passes, p.solution[0].cpu().numpy(),
                    p.last_relres)
    dsmall = float(np.abs(small["cuda"][2] - small["cpu"][2]).max())
    print(f"small solve cuda vs cpu: iters {small['cuda'][0]} vs "
          f"{small['cpu'][0]}, passes {small['cuda'][1]} vs "
          f"{small['cpu'][1]}, max|du|={dsmall:.3e}")
    _check(small["cuda"][3] <= 1e-8 and small["cpu"][3] <= 1e-8,
           "small solves reach 1e-8")
    _check(small["cuda"][1] == small["cpu"][1], "small solve passes")
    _check(abs(small["cuda"][0] - small["cpu"][0]) <= 2, "small solve iters")
    _check(dsmall < 1e-7, "small solve cuda vs cpu")
    _phase("2 main path", t0)

    # -- phase 3: kernels against their plain versions -----------------------
    t0 = time.perf_counter()
    kernels = []
    g = torch.Generator(device=dev).manual_seed(0)
    M = db.P * db.R

    def entry(name, src, replaces, launches, err, ms, plain_ms, bound,
              lib_ms):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "library_ms": lib_ms})
        print(f"  {name}: ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} bound_ms={bound[0]:.5f} "
              f"({bound[1]}) max_abs_err={err:.3e}", flush=True)

    # B1: the cluster ghost fetch of the main path
    idx = db.ghost_plan[0]
    x = torch.randn(M, generator=g, device=dev)
    y_k = pm.permute_gather(x, idx)
    y_p = pm.permute_gather_plain(x, idx)
    torch.cuda.synchronize()
    _check(torch.equal(y_k, y_p), "B1 bit-exact")
    x_ext = torch.cat([x, x.new_zeros(1)])
    idx_lib = torch.where(idx < 0, M, idx).long()
    _check(torch.equal(x_ext[idx_lib], y_p), "B1 yardstick")
    print(f"B1 shapes: n_in={M} n_out={idx.numel()}")
    entry("B1 permute_gather", "feddlib_tpu_torch/csrc/permute.cu",
          "feddlib_tpu/la/permute.py:206", counts2["permute_gather"], 0.0,
          _device_ms(torch, lambda: pm.permute_gather(x, idx)),
          _device_ms(torch, lambda: pm.permute_gather_plain(x, idx)),
          _bound(4 * M + 8 * idx.numel(), 0, PEAK_F32_S),
          _device_ms(torch, lambda: x_ext[idx_lib]))

    # B2: the padded SELL operator A of the main path
    Ac = split.Ac
    xfull = torch.cat([x, pm.permute_gather(x, idx)])
    nx2 = (Ac.shape[1] + 127) // 128
    x2d = torch.zeros(nx2 * 128, device=dev)
    x2d[: Ac.shape[1]] = xfull
    x2d = x2d.reshape(nx2, 128)
    y_k = sl.sell_spmv(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
    y_p = sl.sell_spmv_plain(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
    err = float((y_k - y_p).abs().max())
    _check(err <= 1e-6 * float(y_p.abs().max()), f"B2 error {err}")
    csr = _sell_to_torch_csr(torch, Ac)
    xcol = x2d.reshape(-1)
    y_lib = csr @ xcol
    n_rows = Ac.shape[0]
    _check(float((y_lib[:n_rows] - y_p[:n_rows]).abs().max())
           <= 1e-5 * float(y_p.abs().max()), "B2 yardstick")
    slots = Ac.vals.numel()
    nnz_sell = int((Ac.vals != 0).sum())
    print(f"B2 shapes: nchunks={Ac.vals.shape[0]} E={Ac.E} K={Ac.K} "
          f"nx2={nx2} rows={n_rows} nnz={Ac.nnz} stored_nonzeros="
          f"{nnz_sell} slots={slots} spill="
          f"{0 if Ac.spill_rows is None else Ac.spill_rows.numel()}")
    entry("B2 sell_spmv", "feddlib_tpu_torch/csrc/sell.cu",
          "feddlib_tpu/la/sell.py:354", counts2["sell_spmv"], err,
          _device_ms(torch, lambda: sl.sell_spmv(Ac.vals, Ac.pidx, Ac.bids,
                                                  x2d, Ac.E)),
          _device_ms(torch, lambda: sl.sell_spmv_plain(
              Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)),
          _bound(6 * slots + 4 * Ac.bids.numel() + 4 * x2d.numel()
                 + 4 * (slots // Ac.E), 2 * nnz_sell, PEAK_F32_S),
          _device_ms(torch, lambda: csr @ xcol))
    del csr

    # B3: the f32 level-1 inverse of the main path
    inv = prec.level1.inv
    P, R, W = inv.shape
    xs = torch.randn(P, W, generator=g, device=dev)
    y_k = dk.dense_block_mv(inv, xs)
    y_p = dk.dense_block_mv_plain(inv, xs)
    err = float((y_k - y_p).abs().max())
    _check(err <= 1e-5 * float(y_p.abs().max()), f"B3 error {err}")
    print(f"B3 shapes: P={P} R={R} W={W} bytes={inv.numel() * 4}")
    entry("B3 dense_gemv_f32", "feddlib_tpu_torch/csrc/dense_gemv.cu",
          "feddlib_tpu/la/pallas_kernels.py:26", counts2["dense_gemv_f32"],
          err, _device_ms(torch, lambda: dk.dense_block_mv(inv, xs)),
          _device_ms(torch, lambda: dk.dense_block_mv_plain(inv, xs),
                     samples=20, calls=2),
          _bound(4 * P * R * W + 4 * P * W + 4 * P * R, 2 * P * R * W,
                 PEAK_F32_S),
          _device_ms(torch, lambda: torch.bmm(inv, xs.unsqueeze(-1))))
    _phase("3 kernels (main-path shapes)", t0)

    # free phase 2 before phase 4 builds its own operators
    del prob, cache, db, split, prec, inv, xs, y_k, y_p, x, x_ext, idx
    del idx_lib, xfull, x2d, xcol, y_lib, A_sp, u
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 4: bench-chain configuration -----------------------------------
    t0 = time.perf_counter()
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.fe.host_assembly import host_poisson_dirichlet
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.la.dense_blocks import DenseBlockSpMV
    from feddlib_tpu_torch.la.sell import PaddedSplitSpMV
    from feddlib_tpu_torch.mesh.partition import (MeshPartition,
                                                   partition_points)
    from feddlib_tpu_torch.precond.cluster_coarse import \
        PaddedTwoLevelSchwarz
    from feddlib_tpu_torch.solvers.krylov import solve
    from feddlib_tpu_torch.solvers.refinement import iterative_refinement

    dom = Domain.structured(3, args.n_bench, device=dev)
    Kb_sp, bb_np = host_poisson_dirichlet(dom)
    Kb = CsrMatrix.from_scipy(Kb_sp, device=dev)
    bb = torch.as_tensor(bb_np, device=dev)
    part = MeshPartition(dom.mesh, args.bench_clusters)
    cluster = partition_points(dom.mesh.points, args.bench_clusters)
    db = DenseBlockSpMV.from_csr(Kb, cluster, dtype=torch.float32)
    Ap = PaddedSplitSpMV(Kb, db, dtype=torch.float32)
    A_fn, A_ops = Ap.operator()
    mask = np.asarray(dom.mesh.point_flags) == 1
    prec = PaddedTwoLevelSchwarz(Kb, part, db, dirichlet_mask=mask,
                                 level_combination="Additive",
                                 l1_store_dtype=torch.bfloat16,
                                 coarse_store_dtype=torch.bfloat16,
                                 A_padded_op=(A_fn, A_ops))
    M_fn, M_ops = prec.padded_operator()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    xp = torch.ones(db.P * db.R, device=dev)
    ma_ms = _device_ms(torch, lambda: M_fn(M_ops, A_fn(A_ops, xp)))
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(50):
        xp = M_fn(M_ops, A_fn(A_ops, xp))
        xp = xp / torch.linalg.norm(xp)
    torch.cuda.synchronize()
    ma_wall_ms = (time.perf_counter() - tw) / 50 * 1e3

    def inner(r32):
        res = solve("gmres", A_fn, A_ops, db.to_padded(r32), M_fn=M_fn,
                    M_ops=M_ops, tol=1e-6, maxiter=150, restart=80)
        res.x = db.from_padded(res.x)
        return res

    _cuda.reset_launch_counts()
    t_ir = time.perf_counter()
    res = iterative_refinement(Kb.matvec, inner, bb, tol=1e-8)
    torch.cuda.synchronize()
    t_ir = time.perf_counter() - t_ir
    counts4 = dict(_cuda.launch_counts)
    rel4 = float(np.linalg.norm(bb_np - Kb_sp @ res.x.cpu().numpy())
                 / np.linalg.norm(bb_np))
    print(f"bench chain: n_dofs={Kb.shape[0]} nnz={Kb.nnz} P={db.P} "
          f"R={db.R} W={db.R + db.G} E={Ap.Ac.E} K={Ap.Ac.K} "
          f"coarse_dim={prec.n_coarse} setup_s={t_setup:.3f}")
    print(f"bench chain: ma_apply_ms={ma_ms:.5f} (device) "
          f"ma_apply_wall_ms={ma_wall_ms:.5f} (host clock, 50 applies)")
    print(f"bench chain: ir_passes={res.passes} inner_iters={res.iters} "
          f"relres={res.relres:.3e} host_f64_relres={rel4:.3e} "
          f"ir_s={t_ir:.3f} (TPU anchor, BENCH_r05.json: 4 passes, 66 "
          f"inner iterations)")
    print(f"bench chain launches: {counts4}", flush=True)
    _check(res.converged and rel4 <= 1e-8, f"bench chain relres {rel4}")
    _check(counts4["dense_gemv_bf16"] > 0, "bench chain launched no B4")

    # B4 against its plain version on this phase's bf16 level-1 inverse
    inv = prec.level1.inv
    P, R, W = inv.shape
    xs = torch.randn(P, W, generator=g, device=dev)
    y_k = dk.dense_block_mv_lowp(inv, xs)
    y_p = dk.dense_block_mv_lowp_plain(inv, xs)
    err = float((y_k - y_p).abs().max())
    _check(err <= 1e-5 * float(y_p.abs().max()), f"B4 error {err}")
    xs_bf = xs.to(torch.bfloat16).unsqueeze(-1)
    print(f"B4 shapes: P={P} R={R} W={W} bytes={inv.numel() * 2}")
    entry("B4 dense_gemv_bf16", "feddlib_tpu_torch/csrc/dense_gemv.cu",
          "feddlib_tpu/la/pallas_kernels.py:48", counts4["dense_gemv_bf16"],
          err, _device_ms(torch, lambda: dk.dense_block_mv_lowp(inv, xs)),
          _device_ms(torch, lambda: dk.dense_block_mv_lowp_plain(inv, xs)),
          _bound(2 * P * R * W + 4 * P * W + 4 * P * R, 2 * P * R * W,
                 PEAK_BF16_S),
          _device_ms(torch, lambda: torch.bmm(inv, xs_bf)))
    torch.cuda.synchronize()
    _phase("4 bench chain", t0)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
