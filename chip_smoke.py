#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (feddlib_tpu_torch) on one NVIDIA
Hopper card.  Run from the repository root:  python3 chip_smoke.py

Phases (each prints its seconds; any failed check raises and the script
exits non-zero):
  1. build the CUDA kernels of csrc/ with nvcc for sm_90a, and beside them
     the native host library (feddlib_tpu_torch/native, g++);
  2. main path: Laplace on Domain.structured(3, 64) (P1, 274,625 dofs),
     'Use Mixed Precision' + 'TwoLevel' with 512 clusters, solved to 1e-8
     through Problem.solve; the f64 residual is recomputed on the host with
     scipy, the kernel launch counters must show B1, B2 and B3; two more
     solves capture and then replay the GMRES Arnoldi steps as CUDA graphs,
     each giving the first solve's x bit for bit, the replay's profiler
     trace naming B1, B2 and B3; a small solve on the card must match the
     same solve on the CPU;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (B4 at phase 4's, and at the main path's level-1
     inverse cast to bf16, 0.59 GB, beyond the L2), timed beside a one-call
     PyTorch yardstick and the card's bound for the same work; the SELL
     kernels (B2, B5) beside two CSR calls, one over the nonzero values and
     one over every stored entry; B1, B2 and their library calls also with
     their inputs out of L2 (cycled copies), as the solve finds them (B1 at
     phases 5 and 6 too); the time of an empty launch, the floor of every
     time taken this way, is printed as launch_floor_ms;
  4. the bench-chain configuration at Domain.structured(3, 40) (68,921
     dofs): additive two-level Schwarz with bf16 level-1 and coarse stores,
     the M(A(x)) apply time, and the refinement to 1e-8 (B4 must launch);
  5. elasticity operator: LinElas on Domain.structured(3, 32).p2_domain()
     (P2, 823,875 dofs, 69 M nonzeros, one face clamped), assembled through fe/ops.py and
     the seconds of its symbolic phase (the native from_coo) printed,
     laid out by auto_spmv(K, float32, dofs_per_node=3) as the RCM split
     with a block-SELL residue; one apply against the host f64 product,
     with_data, a fixed number of Jacobi-preconditioned GMRES iterations
     over the format's (fn, operands) (B1 and B5 must launch), and B1 and
     B5 against their plain versions and library calls at these shapes
     (B5 on its sliced, length-sorted layout, which is also held against
     the JAX-identical planes it was gathered from);
  6. elasticity solve: LinElas on Domain.structured(3, 40) (P1, 206,763
     dofs), one face clamped, body load, 'Use Mixed Precision' + 'TwoLevel'
     with the rigid-body null space and 128 clusters, to 1e-8 through
     Problem.solve (B1, B2 and B3 must launch, and each is held against
     its plain version at this solve's shapes); the same operator through
     auto_spmv must come out as block-DIA; a small Jacobi solve takes the
     f64 Krylov path with the block-DIA apply;
  7. the f64 default path: Laplace on Domain.structured(3, 48) (cut from
     64 for the time limit; --n-schwarz) through Problem.solve with the
     default 'Preconditioner Type' ('SchwarzTwoLevel':
     f64 overlapping Schwarz with dense [P, S, S] subdomain inverses plus
     the GDSW coarse level) on 512 subdomains, to 1e-8; the f64 residual on
     the host, the setup seconds, one M(A(x)) apply (device and wall), the
     level-1 and coarse applies beside their byte bounds; then the same
     system with the sparse subdomain solves ('Subdomain Solver':
     'sparse': the batched sparse LU and its wavefront sweeps) as level 1
     under the same coarse level, within 2 iterations of the dense solve;
     a small default solve on the card against the same on the CPU;
  8. the 3D lid-driven cavity: NavierStokes on the P2/P1 pair of
     Domain.structured(3, 12) (49,072 dofs), Newton to 1e-8 with 'Use
     Mixed Precision', 'SchwarzOneLevel' and 64 dof-map clusters (the
     balance=True branch of the mixed solve), each step's seconds split
     into assembly / merge / format and factor setup / solve; the f64
     residual of the last linear solve on the host; B1, B2 and B3 must
     launch, and each is held against its plain version at this solve's
     shapes; the golden small cavity (tests/test_goldens.py:71) through
     the f64 two-level path on the card;
  9. an unsteady hyperelastic block: NonLinElasticity (Neo-Hooke) on
     Domain.structured(3, 32) (P1, 107,811 dofs), the x = 0 face clamped, a
     body load ramped in time, Newton inside DAESolverInTime's BDF2 over 3
     steps with 'Use Mixed Precision' + 'TwoLevel', the rigid-body null
     space and 64 clusters; Newton must converge in every step, each
     step's last linear solve reach 1e-8 in f64 on the host, B1, B2 and B3
     launch (each held against its plain version at this solve's shapes);
     per step the Newton count, the GMRES iterations and the seconds of
     tangent / residuals / solve (the program's spans), and the kernel
     launches (B6 every residual and tangent, no torch.func chunk);
     B6, the Neo-Hooke P1 element kernel, over all 196,608 elements with
     and without the tangent, beside its byte bound, its plain version and
     the torch.func path, against the plain version on the card and on the
     CPU and against torch.func; then LinElas on
     Domain.structured(3, 8) through 10 Newmark steps in f64, checkpointed
     at step 5 and resumed in a fresh DAESolverInTime and problem: the
     resumed run must equal the uninterrupted one bit for bit;
 10. element assembly on the card: scalar P1 Laplace and mass on
     Domain.structured(3, 64) and P2 Laplace on Domain.structured(3,
     32).p2_domain(), each through the element-last fast path and the
     chunked path (agreeing within 1e-13 of max |data|; the element kernel
     and the scatter timed apart); the P1 Laplace scatter as B2 over the
     0/1 assembly plan (16 splits, f32), held against its plain version,
     the f64 assembly and a torch CSR yardstick; Q2 hex vector Laplace and
     P1-disc divergence on Domain.structured_hex(3, 24, "Q2"), card
     against CPU;
 11. serial fluid-structure interaction on the two-box setup of
     tests/test_fsi.py:24 (a lid-driven fluid box over a clamped elastic
     slab; fluid P2/P1, solid P2, the interface flagged 9 on both meshes):
     11a the 3D GE loop, (12, 12, 6) cells a box (51,664 dofs over u, p, d
     and λ), 2 time steps of Newton with 'Use Mixed Precision',
     'SchwarzOneLevel', 64 dof-map clusters and GMRES(1000); the level-1
     shape printed from the host before the card allocates it; every
     step's geometry GMRES, Newton and inner GMRES counts, host f64 relres
     of its last solve (≤ 1e-8) and seconds by part; B1, B2 and B3 must
     launch on the four-field system and are held against their plain
     versions there;
     11b a 2D GE step with FaCSI (the users' default preconditioner) on 64
     cells a box, 32 subdomains, after the small case of tests/test_fsi.py
     on the card against the CPU; 11c a 2D GI step (five fields, the shape
     derivatives of fe/shape_derivatives.py) with the f64 one-level
     Schwarz on 16 subdomains, the card's D_ug, D_pg against the CPU's;
 12. the distributed solve, its shards stacked on the card: 12a phase 7's
     system (Domain.structured(3, 48)) through Problem.solve with 'Use
     Distributed Solve' over 512 shards ('Devices'; --n-dist,
     --dist-devices) and 'SchwarzTwoLevel' (distributed GDSW, overlap 1,
     Restricted, dense coarse), f64 GMRES to 1e-8: the host estimate of
     level 1 first, the setup seconds by part, the halo rounds, the shapes
     and bytes on the card, the host f64 residual, the count against phase
     7's (±1) and x against phase 7's solution (1e-6 of max|x|), a second
     solve bitwise equal from the cached shards, one A and one M(A(x))
     apply (device and wall ms, launches from a profiler trace); 12b
     Domain.structured(2, 16) on 8 shards under Jacobi, one-level Schwarz
     (overlap 2, Averaging) and two-level GDSW, and a P2/P1 Stokes cavity
     on 4 shards through the block GDSW, each on the card against the CPU
     (equal counts, x within 1e-9 of max|x|).  Phase 12 launches no Hopper
     kernel: the JAX package computes all of it in XLA;
 13. the device-resident pipeline (parallel/pipeline.py), shards stacked
     on the card: 13a phase 12a's system through Problem.solve with 'Use
     Device Pipeline' (the same 512 shards and two-level GDSW from the
     pipeline's block specs): finalize seconds by part, L / S / K / N_o /
     E_max, the exchange rounds and the elements they move, the bytes on
     the card, the host f64 residual, the count against phase 12a's (±1),
     x within 1e-6 of max|x| and the collected matrix within 1e-12 of
     max|a| of phase 12a's, two assemblies bitwise equal, a second solve
     cached and bitwise equal, one assembly's device and wall ms and
     launches; 13b Newton on phase 8's cavity (--n-pipe-ns, 64 shards,
     block GDSW) with the pipeline against the split shards: equal Newton
     and GMRES counts, solutions within 1e-8, one solution upload
     (n_distributes = 1 + Newton), after the host estimate of level 1;
     13c two GE steps of phase 11b's two-box at 32 cells a box
     (--n-pipe-fsi; cut from phase 11b's 64, whose solid FaCSI factors
     took 29 s a Newton step on the host) with 'Use
     Distributed Solve' (32 shards, 8 solid; distributed FaCSI) against
     the serial FaCSI loop (rtol 1e-6, atol 1e-9; one pipeline build);
     13d one GI step of phase 11c's (16 shards, 4 solid) against the
     serial step; 13e the small pipeline cases of the CPU tests (Laplace,
     the device-RHS heat loop, TPM consolidation, hyperelastic Newton) on
     the card against the CPU.  Phase 13 launches no Hopper kernel either;
 14. shards on several processes and AMR: 14a phase 13a's system through
     Problem.solve on two ranks of the gloo backend, both on the one card
     (256 shards a rank, parallel/multihost.py's launcher): each rank's
     setup seconds by part, A / M(A(x)) / assembly wall and busy ms,
     launches and the bytes and seconds of their cross-rank transfers;
     the count, x (1e-12) and the gathered matrix (bitwise) against 13a's;
     14b the small cases of 12b and 13e on one NCCL rank, bitwise the
     stacked runs, and what NCCL says to two ranks on one card; 14c
     adaptive_solve_cycles on the unit square from 128^2 P1 cells
     (--n-amr; the Gaussian peak of tests/test_amr.py, Dörfler 0.6, 3
     cycles, solves to 1e-12) in three modes: 'Use Mixed Precision' +
     'TwoLevel' (B1-B3 launch every cycle and are held against their
     plain versions at the last cycle's shapes), 'Use Distributed Solve'
     + 'Use Device Pipeline' on 16 shards, and that with 'Use Distributed
     AMR'; per cycle the counts, eta, seconds by part and launches; the
     modes' meshes compared up to the problem's symmetries, eta within
     1e-8 on every shared mesh;
 15. the FSI loops on ranks, the drivers and the entry points: 15a phase
     13c's GE loop (32 shards, 16 a rank) and 13d's GI step (16 shards, 8
     a rank) on two gloo ranks of the one card: Newton and GMRES counts
     equal to 13c / 13d's and every field within 1e-10 of theirs, each
     rank's setup seconds, one assembly's and one FaCSI apply's wall and
     busy ms and cross-rank bytes; 15b every driver of
     feddlib_tpu_torch/drivers/ through main([...]) on the card at the
     sizes of tests/test_drivers.py (navier_stokes on a 2.2 x 0.41
     channel: its DFG mesh is not in the repository), the 3D elasticity
     driver at --n-driver-elas cells, with the goldens of those tests
     (navier_stokes: the JAX driver's counts and forces), each driver's
     seconds and timer report; 15c graft_entry.entry()'s step on the card
     against the CPU (1e-12) and dryrun_multichip(4) on stacked shards on
     the card and on the CPU: counts equal, the FSI tip within 1e-10.
     Phase 2 also prints the card's busy share of its repeated solve,
     reduced by the benchmark's profiler trace (benchmark/tracing.py);
 16. the native host library on the card machine's host, each function
     against its numpy version, bitwise, both timed: (a)
     SparsityPattern.from_coo on phase 2's COO (Domain.structured(3, 64),
     P1, 25.2 M entries), (b) read_mesh of MEDIT files written at run time
     (a cube of --n-medit cells with boundary triangles, and
     scenarios.write_channel_mesh), P1 and P2, (c) rcb of phase 2's
     274,625 points into its 512 clusters; one {"host_native": ...} line.

Every set-up and per-step split of seconds is read from the program's own
spans and counters (feddlib_tpu_torch/utils/timers.py, through `_measured`),
every busy share from the benchmark's profiler reduction
(benchmark/tracing.py), and B3's bound from the benchmark's unpadded byte
count (benchmark/roofline.py).  Prints one `{"kernels": [...]}` JSON line,
the card's name and power limit, and as the last line {"ok": true,
"device": {...}}.  Exits non-zero without
a result when no CUDA device is visible or the package is missing.
"""

import argparse
import functools
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
PEAK_F64_S = 67e12  # f64 on the tensor cores (34 TFLOP/s on the CUDA cores)
PEAK_BF16_S = 989e12
L2_BYTES = 50 * 2**20


def _phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _device_ms(torch, fn, samples=25, calls=20):
    """Median device time of one call: each sample queues `calls` calls
    behind a spin kernel, so the host's launch overhead is hidden.  `fn`
    may be a list of calls (from _cold_calls), taken in turn."""
    fns = fn if isinstance(fn, list) else [fn]
    for i in range(max(3, len(fns))):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    out, k = [], 0
    for _ in range(samples):
        torch.cuda._sleep(50_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fns[k % len(fns)]()
            k += 1
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / calls)
    return statistics.median(out)


def _nbytes(t):
    parts = ((t.crow_indices(), t.col_indices(), t.values())
             if t.is_sparse_csr else (t,))
    return sum(p.numel() * p.element_size() for p in parts)


def _cold_calls(fn, *tensors):
    """Calls fn(*copies) over enough copies of `tensors` that the others
    move 3x the L2 between two uses of one copy: taken in turn by
    _device_ms, they time fn with these inputs out of L2, as a solve finds
    them (B3's level-1 stream evicts them between two applies)."""
    n_bytes = sum(_nbytes(t) for t in tensors)
    n = -(-3 * L2_BYTES // n_bytes) + 1
    return [functools.partial(fn, *(t.clone() for t in tensors))
            for _ in range(max(n, 3))]


def _bound(n_bytes, n_ops, peak_ops):
    t_b, t_o = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def _check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


class _Registry:
    """A subscriber of the program's registry
    (feddlib_tpu_torch/utils/timers.py) while its `with` block runs: the
    spans that closed, in the order they closed, and the counters'
    increments."""

    def __init__(self):
        self.spans, self.counts = [], {}

    def __enter__(self):
        from feddlib_tpu_torch.utils import timers

        timers.subscribe(self.file)
        return self

    def __exit__(self, *exc):
        from feddlib_tpu_torch.utils import timers

        timers.unsubscribe(self.file)

    def file(self, rec):
        if hasattr(rec, "end_ns"):
            self.spans.append(rec)
        else:
            self.counts[rec.name] = self.counts.get(rec.name, 0) + rec.n

    def each(self, name, lo=0, hi=None):
        """Seconds of each span `name` that opened at `lo` or later and
        closed by `hi` (time.perf_counter_ns() readings, the spans' clock)."""
        return [sp.seconds for sp in self.spans if sp.name == name
                and sp.start_ns >= lo and (hi is None or sp.end_ns <= hi)]

    def s(self, *names, lo=0, hi=None):
        """Seconds of the spans of these names, summed."""
        return sum(sum(self.each(n, lo, hi)) for n in names)

    def per(self, name, outer):
        """For each span `outer`, in order, the seconds of the spans `name`
        inside it, summed."""
        return [self.s(name, lo=o.start_ns, hi=o.end_ns)
                for o in self.spans if o.name == outer]

    def parts(self, *names):
        """The seconds of each name as "part=seconds ...", a name's part
        being what follows its layer ("prec.gdsw" prints "gdsw=...")."""
        return " ".join(f"{n.split('.', 1)[1]}={self.s(n):.3f}"
                        for n in names)


def _measured(fn, *a, **k):
    """(fn(*a, **k), the _Registry of the call): the seconds of the
    program's own spans and its counters' increments during the call."""
    with _Registry() as reg:
        return fn(*a, **k), reg


def _traced(torch, dev, fn):
    """(fn's result, benchmark.tracing.Trace) of one call of fn under the
    profiler, after one call outside it: the card's busy seconds, the
    window's and each kernel's seconds and launches (copies included)."""
    from benchmark.tracing import Trace

    fn()
    tr = Trace(dev)
    tr.start()
    out = fn()
    tr.stop()
    return out, tr


def _launches(torch, dev, fn):
    """(launches, busy ms) of one call of fn on the card, from `_traced`;
    (None, None) where the trace shows no device events."""
    _, tr = _traced(torch, dev, fn)
    n = sum(v[1] for v in tr.kernels.values())
    return (n, tr.busy_s * 1e3) if n else (None, None)


def _b3_bound(db):
    """B3's least ms for one launch on the layout `db`, counted from its
    unpadded cluster blocks (`benchmark/roofline.py`, as `b3_roofline.*`
    counts them), and what bounds it."""
    from benchmark import roofline as rf

    rows, cols = rf.unpadded_blocks(db.old_of_pad.cpu().numpy(),
                                    db.ghost_idx.cpu().numpy(), db.n, db.R)
    by = ("bytes" if rf.b3_bytes(rows, cols) / rf.PEAK_BYTES_S
          >= rf.b3_flops(rows, cols) / rf.PEAK_F32_S else "operations")
    return rf.b3_least_s(rows, cols) * 1e3, by


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


def _linelas(torch, dom, params, device):
    """LinElas on `dom` with the x = 0 face clamped (flag 2) and a body
    load in the last direction."""
    from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary
    from feddlib_tpu_torch.problems.linelas import LinElas
    from feddlib_tpu_torch.utils.config import ParameterList

    dim = dom.dim
    flag_boxed_boundary(dom.mesh, [0.0] * dim, [1.0] * dim, {"x0": 2})
    prob = LinElas(dom, parameter_list=ParameterList("P", params),
                   device=device)
    prob.assemble()
    prob.assemble_source(lambda x: [0.0] * (dim - 1) + [-0.1])
    prob.add_bc(lambda x, t: 0.0, 2, 0)
    prob.set_boundaries_rhs()
    return prob


def _bench_chain(torch, np, n, clusters, device):
    """Phase 4's configuration: the Dirichlet Poisson system of
    Domain.structured(3, n) assembled on the host, the solve's padded
    operators on `clusters` point clusters, and the additive two-level
    Schwarz with bf16 level-1 and coarse stores."""
    from types import SimpleNamespace

    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.fe.host_assembly import host_poisson_dirichlet
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.cluster_coarse import \
        PaddedTwoLevelSchwarz
    from feddlib_tpu_torch.solvers.linear import point_cluster_operators

    dom = Domain.structured(3, n, device=device)
    K_sp, b_np = host_poisson_dirichlet(dom)
    K = CsrMatrix.from_scipy(K_sp, device=device)
    db, Ap = point_cluster_operators(K, dom.mesh.points, clusters, 1)
    A_fn, A_ops = Ap.operator()
    prec = PaddedTwoLevelSchwarz(
        K, MeshPartition(dom.mesh, clusters), db,
        dirichlet_mask=np.asarray(dom.mesh.point_flags) == 1,
        level_combination="Additive", l1_store_dtype=torch.bfloat16,
        coarse_store_dtype=torch.bfloat16, A_padded_op=(A_fn, A_ops))
    M_fn, M_ops = prec.padded_operator()
    return SimpleNamespace(K_sp=K_sp, b_np=b_np, K=K, db=db, Ap=Ap,
                           prec=prec, A_fn=A_fn, A_ops=A_ops, M_fn=M_fn,
                           M_ops=M_ops)


def _host_relres(np, A_sp, b, x):
    """||b - A x|| / ||b|| in f64 on the host."""
    b, x = b.double().cpu().numpy(), x.double().cpu().numpy()
    return float(np.linalg.norm(b - A_sp @ x) / np.linalg.norm(b))


def _block_sell_to_torch_csr(torch, bs, stored=False):
    """The block-SELL planes back to one torch CSR tensor on the planar
    spaces the kernel works in (the B5 yardstick): row ci*nn + r, column
    cj*nx2*128 + node column.  It keeps the nonzero values, or with
    `stored` every entry the matrix stores (zeros included: the kernel's
    work without the padding)."""
    lay, d = bs.layout, bs.d
    nch, E = bs.vals.shape[0], lay.E
    n_rows = bs.shape[0] // d
    nx = (n_rows + 127) // 128 * 128
    p = lay.pidx.reshape(nch, -1).long()
    ncol = (torch.gather(lay.bids.long(), 1, p >> 7) * 128
            + (p & 127)).reshape(-1)
    nrow = torch.arange(ncol.numel(), device=ncol.device) // E
    # dof_slots index the plane-major [d*d, nch*1024] order
    in_use = torch.zeros(d * d * nch * 1024, dtype=torch.bool,
                         device=ncol.device)
    in_use[bs.dof_slots[bs.dof_slots >= 0]] = True
    in_use = in_use.reshape(d * d, -1)
    rows, cols, vals = [], [], []
    for ci in range(d):
        for cj in range(d):
            v = bs.vals[:, ci * d + cj].reshape(-1)
            keep = (in_use[ci * d + cj] if stored else v != 0) & (
                nrow < n_rows)
            rows.append(ci * n_rows + nrow[keep])
            cols.append(cj * nx + ncol[keep])
            vals.append(v[keep])
    coo = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (d * n_rows, d * nx)).coalesce()
    return coo.to_sparse_csr()


def _sell_to_torch_csr(torch, sm, stored=False):
    """The SELL planes back to a torch CSR tensor (the B2 yardstick): the
    nonzero values, or with `stored` every entry the planes store (zeros
    included: the kernel's work without the padding).  Spill entries are
    left out: `sell_op` adds them outside the kernel."""
    E = sm.E
    nch = sm.vals.shape[0]
    vals = sm.vals.reshape(-1)
    p = sm.pidx.reshape(nch, -1).long()
    cols = (torch.gather(sm.bids.long(), 1, p >> 7) * 128
            + (p & 127)).reshape(-1)
    rows = torch.arange(vals.numel(), device=vals.device) // E
    if stored:
        keep = torch.zeros(vals.numel(), dtype=torch.bool,
                           device=vals.device)
        slots = sm.data_slots[sm.data_slots >= 0]
        keep[torch.as_tensor(slots, device=vals.device)] = True
    else:
        keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    nx = (sm.shape[1] + 127) // 128 * 128
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (sm.shape[0], nx)).coalesce()
    return coo.to_sparse_csr()


def _default_laplace(torch, n, params, device):
    """Laplace on Domain.structured(3, n) with the repo's Dirichlet Poisson
    data and the default preconditioner unless `params` names another."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    prob = Laplace(Domain.structured(3, n, device=device),
                   parameter_list=ParameterList("P", dict(params)),
                   device=device)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def _phase7(torch, np, args, dev):
    """The f64 default path (see the module docstring)."""
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.gdsw import TwoLevelSchwarz
    from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner
    from feddlib_tpu_torch.solvers.krylov import solve
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    t0 = time.perf_counter()
    params = {"Subdomains": args.schwarz_parts,
              "Convergence Tolerance": 1e-8}
    prob = _default_laplace(torch, args.n_schwarz, params, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    _cuda.reset_launch_counts()
    iters, reg = _measured(prob.solve)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t_setup
    u = prob.solution[0]
    A = prob.bc_system().get_block(0, 0)
    A_sp = A.to_scipy()
    rel = _host_relres(np, A_sp, prob.rhs[0], u)
    prec = prob.preconditioner.prec
    _check(prob.parameter_list.get("Preconditioner Type",
                                   "SchwarzTwoLevel") == "SchwarzTwoLevel"
           and isinstance(prec, TwoLevelSchwarz), "default preconditioner")
    l1 = prec.level1
    _check(l1.solver == "dense" and l1.inv.dtype == torch.float64
           and l1.inv.device.type == "cuda", "f64 dense level 1 on the card")
    _check(u.dtype == torch.float64 and bool(torch.isfinite(u).all()),
           "f64 finite solution")
    print(f"f64 default path: n_dofs={A.shape[0]} nnz={A.nnz} "
          f"P={l1.n_parts} S={l1.S} level1_bytes={l1.inv.numel() * 8} "
          f"coarse_dim={prec.coarse.n_coarse}")
    print(f"f64 default path: gmres_iters={iters} relres="
          f"{prob.last_relres:.3e} host_f64_relres={rel:.3e} "
          f"assembly_s={t_setup - t0:.3f} solve_s={t_solve:.3f} (setup "
          f"inside: {reg.s('prec.level1'):.3f} level 1 = "
          f"{reg.s('prec.overlap'):.3f} overlap + "
          f"{reg.s('prec.factor'):.3f} host inverses and upload, "
          f"{reg.s('prec.gdsw'):.3f} GDSW) launches="
          f"{dict(_cuda.launch_counts)}", flush=True)
    _check(rel <= 1e-8, f"f64 default path host residual {rel} > 1e-8")
    # phase 12 holds the distributed solve of this system against it
    ref = {"x": u.cpu().numpy(), "iters": iters, "relres": rel,
           "n": args.n_schwarz, "parts": args.schwarz_parts}

    # one M(A(x)) apply of the solve's operators, and its two levels
    A_fn, A_ops = (LinearSolver()._auto_format_operator(
        A, prob, prob.parameter_list) or A.operator())
    M_fn, M_ops = prec.operator()
    x = torch.randn(A.shape[0], dtype=torch.float64, device=dev)
    ma_ms = _device_ms(torch, lambda: M_fn(M_ops, A_fn(A_ops, x)),
                       samples=10, calls=5)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    y = x
    for _ in range(20):
        y = M_fn(M_ops, A_fn(A_ops, y))
        y = y / torch.linalg.norm(y)
    torch.cuda.synchronize()
    ma_wall = (time.perf_counter() - tw) / 20 * 1e3
    l1_fn, l1_ops = l1.operator()
    P, S = l1.n_parts, l1.S
    l1_ms = _device_ms(torch, lambda: l1_fn(l1_ops, x), samples=10, calls=5)
    ov = torch.randn(P, S, dtype=torch.float64, device=dev)
    gemv_ms = _device_ms(torch, lambda: torch.einsum("pij,pj->pi", l1.inv,
                                                     ov), samples=10, calls=5)
    A0i = prec.coarse.A0_inv
    rc = torch.randn(A0i.shape[0], dtype=torch.float64, device=dev)
    a0_ms = _device_ms(torch, lambda: A0i @ rc)
    gemv_bound = _bound(8 * P * S * S + 16 * P * S, 2 * P * S * S,
                        PEAK_F64_S)
    a0_bound = _bound(8 * A0i.numel() + 16 * rc.numel(), 2 * A0i.numel(),
                      PEAK_F64_S)
    print(f"f64 default path: ma_apply_ms={ma_ms:.5f} (device) "
          f"ma_apply_wall_ms={ma_wall:.5f} (host clock, 20 applies) "
          f"level1_apply_ms={l1_ms:.5f} batched_gemv_ms={gemv_ms:.5f} "
          f"(einsum over [{P}, {S}, {S}] f64, bound {gemv_bound[0]:.5f} "
          f"{gemv_bound[1]}) coarse_A0inv_ms={a0_ms:.5f} ([{A0i.shape[0]}]^2 "
          f"f64, bound {a0_bound[0]:.5f} {a0_bound[1]})", flush=True)
    del l1, l1_ops, M_ops, M_fn, l1_fn, A0i, ov, y
    prec.level1, prec._op = None, None
    prob.preconditioner._op = None
    gc.collect()
    torch.cuda.empty_cache()

    # the same system with the batched sparse LU subdomain solves: level 1
    # rebuilt on the same dof map, the GDSW coarse level kept, and the
    # f64 GMRES of LinearSolver.solve_system (tol 1e-8, restart 100)
    part = MeshPartition(prob.domains[0].mesh, args.schwarz_parts)
    t_s = time.perf_counter()
    prec.level1, reg = _measured(
        SchwarzPreconditioner, A, prob.preconditioner._merged_dof_map(part),
        solver="sparse")
    M_fn, M_ops = prec.operator()
    torch.cuda.synchronize()
    t_s2 = time.perf_counter()
    res = solve("gmres", A_fn, A_ops, prob.rhs[0], M_fn=M_fn, M_ops=M_ops,
                tol=1e-8, maxiter=1000, restart=100)
    torch.cuda.synchronize()
    t_solve_s = time.perf_counter() - t_s2
    iters_s = res.iters
    rel_s = _host_relres(np, A_sp, prob.rhs[0], res.x)
    slu = prec.level1.slu
    _check(slu is not None and prec.level1.inv is None, "sparse level 1")
    r_pad = torch.randn(slu.P, slu.S, dtype=torch.float64, device=dev)
    slu_ms = _device_ms(torch, lambda: slu.solve(r_pad), samples=5, calls=2)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(5):
        slu.solve(r_pad)
    torch.cuda.synchronize()
    slu_wall = (time.perf_counter() - tw) / 5 * 1e3
    print(f"f64 sparse level 1: T_L={slu.T_L} R_L={slu.R_L} T_U={slu.T_U} "
          f"R_U={slu.R_U} K_L={slu.K_L} K_U={slu.K_U} "
          f"nnz_factors={slu.nnz_factors} plane_bytes={slu.nbytes()} "
          f"gmres_iters={iters_s} (dense {iters}) host_f64_relres="
          f"{rel_s:.3e} setup_s={t_s2 - t_s:.3f} (of which "
          f"{reg.s('prec.factor'):.3f} sparse LU and level "
          f"planes) gmres_s={t_solve_s:.3f} "
          f"sparse_lu_apply_ms={slu_ms:.5f} (device) "
          f"sparse_lu_apply_wall_ms={slu_wall:.5f} (host clock) against "
          f"batched_gemv_ms={gemv_ms:.5f}", flush=True)
    _check(rel_s <= 1e-8, f"sparse solve host residual {rel_s} > 1e-8")
    _check(abs(iters_s - iters) <= 2, "sparse vs dense iterations")
    del prob, prec, slu, r_pad, M_fn, M_ops, A_fn, A_ops, res
    # the small default solve on the card and on the CPU
    small = {}
    for d in ("cuda", "cpu"):
        p = _default_laplace(torch, 8, {"Subdomains": 8}, d)
        small[d] = (p.solve(), p.solution[0].cpu().numpy(), p.last_relres)
    dsmall = float(np.abs(small["cuda"][1] - small["cpu"][1]).max())
    print(f"small default solve cuda vs cpu: iters {small['cuda'][0]} vs "
          f"{small['cpu'][0]}, max|du|={dsmall:.3e}")
    _check(small["cuda"][2] <= 1e-8 and small["cpu"][2] <= 1e-8
           and small["cuda"][0] == small["cpu"][0] and dsmall < 1e-10,
           "small default solve cuda vs cpu")
    _phase("7 f64 default path", t0)
    return ref


def _cavity(torch, n, params, device):
    """The 3D lid-driven cavity: NavierStokes on the P2/P1 pair of
    Domain.structured(3, n), the lid (u = e_0 on x_2 = 1) and no-slip walls
    on flag 1, the physics of tests/test_goldens.py:71."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.navier_stokes import NavierStokes
    from feddlib_tpu_torch.utils.config import ParameterList

    dom_p = Domain.structured(3, n, device=device)
    prob = NavierStokes(dom_p.p2_domain(), dom_p, parameter_list=ParameterList(
        "P", dict({"Viscosity": 0.1, "Density": 1.0, "relNonLinTol": 1e-8,
                   "MaxNonLinIts": 12}, **params)), device=device)
    prob.assemble()

    def lid(x, t):
        on = torch.isclose(x[2], torch.tensor(1.0, dtype=x.dtype,
                                              device=x.device))
        return torch.stack([on.double(), 0.0 * x[0], 0.0 * x[0]])

    prob.add_bc(lid, 1, 0)
    return prob


def _phase8(torch, np, args, dev, hold_b123):
    """The 3D cavity with Newton and mixed precision (see the module
    docstring)."""
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    t0 = time.perf_counter()
    prob = _cavity(torch, args.n_ns, {
        "Use Mixed Precision": True,
        "Preconditioner Type": "SchwarzOneLevel",
        "Clusters": args.ns_clusters, "Convergence Tolerance": 1e-8}, dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    # each Newton step's seconds from the program's spans: the assembly,
    # the merge (its pattern built at the first step and shared by the
    # later merges) and the three parts rebuilt every step (the mixed
    # solve keeps the one-level layout of a multi-field system for one
    # merged matrix): the dof-map clusters and the padded SELL layout
    # (`mixed.partition`, `mixed.layout`, rebalancing included), the
    # level-1 factor (`prec.level1`), and the refinement (the solve
    # proper)
    last = {}
    solve_system = prob.linear_solver.solve_system

    def solve_and_keep(problem, b):
        x, its = solve_system(problem, b)
        last.update(b=b, x=x)
        return x, its

    prob.linear_solver.solve_system = solve_and_keep
    _cuda.reset_launch_counts()
    solver = NonLinearSolver("Newton")
    t1 = time.perf_counter()
    its, reg = _measured(solver.solve, prob)
    torch.cuda.synchronize()
    t_newton = time.perf_counter() - t1
    counts = dict(_cuda.launch_counts)
    A_sp = prob.bc_system().merge().to_scipy()
    rel = _host_relres(np, A_sp, last["b"].concat(), last["x"].concat())
    cache = prob._mixed_cache
    db, split, prec = cache["db32"], cache["sell"], cache["prec"]
    u = prob.solution[0]
    sizes = prob.block_sizes()
    print(f"cavity: n_dofs={sum(sizes)} (u {sizes[0]}, p {sizes[1]}) "
          f"nnz={A_sp.nnz} P={db.P} R={db.R} G={db.G} W={db.R + db.G} "
          f"E={split.Ac.E} K={split.Ac.K} prec={type(prec).__name__}")
    print(f"cavity: newton_its={its} final_criterion="
          f"{solver.final_criterion:.3e} gmres_per_step={solver.linear_iters}"
          f" last_linear_host_f64_relres={rel:.3e} assembly_s={t_asm:.3f} "
          f"newton_s={t_newton:.3f}")
    spent = {k: reg.per(n, "newton.linear_solve") for k, n in (
        ("merge", "block.merge"), ("partition", "mixed.partition"),
        ("layout", "mixed.layout"), ("factor", "prec.level1"),
        ("solve", "refinement.pass"))}
    spent["setup_other"] = [
        t - sum(v[i] for v in spent.values()) for i, t in
        enumerate(reg.each("newton.linear_solve"))]
    spent["tangent"] = reg.each("newton.tangent")
    spent["residuals"] = reg.per("newton.residual", "newton.solve")
    for k, v in spent.items():
        print(f"cavity seconds per step, {k}: "
              f"{[round(x, 3) for x in v]}", flush=True)
    print(f"cavity launches: {counts} (per GMRES iteration: "
          f"{ {k: round(v / max(sum(solver.linear_iters), 1), 2) for k, v in counts.items()} })",
          flush=True)
    _check(solver.final_criterion <= 1e-8 and its < 12,
           f"Newton did not converge: {solver.final_criterion}")
    _check(u.dtype == torch.float64 and bool(torch.isfinite(u).all()),
           "cavity finite f64 velocity")
    _check(rel <= 1e-8, f"cavity last linear solve host residual {rel}")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(counts[k] > 0, f"cavity launched no {k}")
    hold_b123(" (cavity)", db, split, prec, counts)
    del prob, cache, db, split, prec, u, A_sp, last
    gc.collect()
    torch.cuda.empty_cache()

    # the golden small cavity through the f64 two-level path on the card
    prob = _cavity(torch, 3, {"Preconditioner Type": "SchwarzTwoLevel",
                              "Subdomains": 4, "Convergence Tolerance": 1e-9,
                              "Maximum Iterations": 2000}, dev)
    solver = NonLinearSolver("Newton")
    its = solver.solve(prob)
    uu = prob.solution[0].cpu().numpy().reshape(-1, 3)
    ke = 0.5 * float((uu ** 2).sum()) / len(uu)
    print(f"golden cavity: newton_its={its} gmres_per_step="
          f"{solver.linear_iters} kinetic_energy={ke!r} (goldens 3, "
          f"[22, 23, 22], 0.07462684304806966)")
    _check(its == 3 and all(abs(a - b) <= 2 for a, b in
                            zip(solver.linear_iters, [22, 23, 22]))
           and np.isclose(ke, 0.07462684304806966, rtol=1e-6),
           "golden cavity")
    _phase("8 cavity", t0)


def _hyper(torch, n, params, device, load=-0.3):
    """Phase 9's block: NonLinElasticity (Neo-Hooke, E = 1, ν = 0.3) on
    Domain.structured(3, n) with the x = 0 face clamped (flag 2) and its
    body load in the last direction (`load` per unit volume, ramped in time
    by the caller)."""
    from feddlib_tpu_torch.fe import ops
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary
    from feddlib_tpu_torch.problems import NonLinElasticity
    from feddlib_tpu_torch.utils.config import ParameterList

    dom = Domain.structured(3, n, device=device)
    flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
    prob = NonLinElasticity(dom, parameter_list=ParameterList("P", dict(
        {"Material Model": "Neo-Hooke", "E": 1.0, "Poisson Ratio": 0.3},
        **params)), device=device)
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 2, 0)
    f = ops.assemble_rhs(dom, lambda x: [0.0, 0.0, load], 3)
    return prob, f


def _min_jacobian(torch, dom, d):
    """Least det(I + ∇d) over the elements (P1: one value an element)."""
    from feddlib_tpu_torch.fe.assembly import small_det

    vc = dom.vert_coords()
    de = d.reshape(-1, 3)[torch.as_tensor(dom.elem_nodes()[:, :4],
                                          device=d.device)]
    x = vc + de
    B = (vc[:, 1:] - vc[:, :1]).transpose(1, 2)
    Bx = (x[:, 1:] - x[:, :1]).transpose(1, 2)
    return float((small_det(Bx) / small_det(B)).min())


def _b6(torch, th, dom, d, params):
    """B6 (csrc/hyperelastic.cu) over every element of `dom` at the
    displacement d: device ms with and without the tangent, beside the
    byte bound (vertex coordinates and displacements read once, R and K
    written once), the plain version and the port's previous path,
    torch.func over all elements in its chunks; the kernel against the plain
    version on the card and on the CPU, and against torch.func, within
    1e-12 of max |value|; the tangent symmetric and two calls bitwise
    equal."""
    vc = dom.vert_coords()
    de = d.reshape(-1, 3)[dom.device_dofs(1, d.device)]
    mu, lam = params
    E = vc.shape[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    R, K = th.neo_hooke_p1(vc, de, mu, lam)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    ms = _device_ms(torch, lambda: th.neo_hooke_p1(vc, de, mu, lam))
    r_ms = _device_ms(torch, lambda: th.neo_hooke_p1(vc, de, mu, lam,
                                                     tangent=False))
    plain_ms = _device_ms(torch, lambda: th.neo_hooke_p1_plain(
        vc, de, mu, lam), samples=5, calls=2)
    r_plain_ms = _device_ms(torch, lambda: th.neo_hooke_p1_plain(
        vc, de, mu, lam, tangent=False), samples=5, calls=2)

    def autodiff(tangent=True):
        return th.autodiff_residual_tangent(vc, de, 3, "P1", "Neo-Hooke",
                                            params, tangent)

    ad_ms = _device_ms(torch, autodiff, samples=3, calls=1)
    r_ad_ms = _device_ms(torch, lambda: autodiff(False), samples=3, calls=1)
    Ra, Ka = autodiff()
    Rp, Kp = th.neo_hooke_p1_plain(vc, de, mu, lam)
    Rc, Kc = th.neo_hooke_p1_plain(vc.cpu(), de.cpu(), mu, lam)
    R2, K2 = th.neo_hooke_p1(vc, de, mu, lam)
    R1, _ = th.neo_hooke_p1(vc, de, mu, lam, tangent=False)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    errs = {"plain": max(rel(R, Rp), rel(K, Kp)),
            "cpu": max(rel(R.cpu(), Rc), rel(K.cpu(), Kc)),
            "torch_func": max(rel(R, Ra), rel(K, Ka)),
            "symmetry": rel(K, K.transpose(1, 2))}
    bitwise = (torch.equal(R, R2) and torch.equal(K, K2)
               and torch.equal(R, R1))
    n_in, n_r, n_k = 2 * E * 12 * 8, E * 12 * 8, E * 144 * 8
    bound = (1e3 * (n_in + n_r + n_k) / PEAK_BYTES_S, "bytes")
    r_bound = 1e3 * (n_in + n_r) / PEAK_BYTES_S
    print(f"B6 neo_hooke_p1: elements={E} ms={ms:.5f} bound_ms="
          f"{bound[0]:.5f} (bytes, {n_in + n_r + n_k} B) roofline="
          f"{100 * bound[0] / ms:.1f}% residual_only_ms={r_ms:.5f} "
          f"bound_ms={r_bound:.5f} roofline={100 * r_bound / r_ms:.1f}% "
          f"plain_ms={plain_ms:.5f} residual_only {r_plain_ms:.5f} "
          f"torch_func_ms={ad_ms:.3f} residual_only {r_ad_ms:.3f} "
          f"peak_bytes={peak} rel_err={errs} bitwise_repeat={bitwise}",
          flush=True)
    _check(errs["plain"] <= 1e-12 and errs["cpu"] <= 1e-12
           and errs["torch_func"] <= 1e-12, f"B6 against its plain "
           f"version and torch.func {errs}")
    _check(errs["symmetry"] <= 1e-14, f"B6 tangent symmetry {errs}")
    _check(bitwise, "B6 repeated and residual-only calls bitwise equal")
    return {"ms": ms, "plain_ms": plain_ms, "bound": bound,
            "rel_err": max(errs["plain"], errs["cpu"]),
            "residual_only": {"ms": r_ms, "plain_ms": r_plain_ms,
                              "bound_ms": r_bound},
            "previous_path_ms": {"torch_func": ad_ms,
                                 "torch_func_residual_only": r_ad_ms}}


def _phase9(torch, np, args, dev, hold_b123, entry=None):
    """The unsteady hyperelastic block, B6 and the checkpointed Newmark run
    (see the module docstring).  `hold_b123` None skips the B1-B3 checks at
    the block's shapes, `entry` None B6's kernel entry (`--only 9`)."""
    import warnings

    from feddlib_tpu_torch.fe import hyperelastic as th
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver
    from feddlib_tpu_torch.solvers.timestepping import (DAESolverInTime,
                                                        TimeProblem)
    from feddlib_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob, f = _hyper(torch, args.n_hyper, {
        "Use Mixed Precision": True, "TwoLevel": True,
        "Null Space Type": "elasticity", "Clusters": args.hyper_clusters,
        "Convergence Tolerance": 1e-8}, dev)
    dom = prob.domains[0]
    tp = TimeProblem(prob)
    t_end = 3.0
    drv = DAESolverInTime(tp, 1.0, t_end,
                          rhs_func=lambda t: BlockVector([f * (t / t_end)]))
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    # each step's seconds from the program's spans: its Newton solve, the
    # tangent reassemblies, the residuals and the mixed solves (the
    # with_data refresh and the refinement)
    steps, last = [], {}
    solve_system = prob.linear_solver.solve_system

    def solve_and_keep(problem, b):
        x, its = solve_system(problem, b)
        last.update(b=b, x=x)
        return x, its

    newton_solve = NonLinearSolver.solve

    def newton_and_record(self, problem, t=0.0):
        its, reg = _measured(newton_solve, self, problem, t)
        st = {"t": t, "newton": its, "gmres": list(self.linear_iters),
              "criterion": self.final_criterion,
              **{k: reg.s(n) for k, n in (
                  ("seconds", "newton.solve"), ("tangent", "newton.tangent"),
                  ("residual", "newton.residual"),
                  ("solve", "solve.mixed"))}}
        # the host check rebuilds the step's system: not in its seconds
        A_sp = problem.bc_system().get_block(0, 0).to_scipy()
        st["host_relres"] = _host_relres(np, A_sp, last["b"].concat(),
                                         last["x"].concat())
        steps.append(st)
        return its

    NonLinearSolver.solve = newton_and_record
    prob.linear_solver.solve_system = solve_and_keep
    _cuda.reset_launch_counts()
    timers.reset_counters("hyper.autodiff_chunks", "newton.iterations",
                          "newton.backtracks")
    t1 = time.perf_counter()
    try:
        _, loop = _measured(drv.advance_nonlinear_bdf, order=2)
    finally:
        NonLinearSolver.solve = newton_solve
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t1
    counts = dict(_cuda.launch_counts)
    d = prob.solution[0]
    cache = prob._mixed_cache
    db, split, prec = cache["db32"], cache["sell"], cache["prec"]
    min_j = _min_jacobian(torch, dom, d)
    print(f"hyperelastic: n_dofs={d.shape[0]} n_elements={dom.n_elements} "
          f"P={db.P} R={db.R} G={db.G} W={db.R + db.G} E={split.Ac.E} "
          f"K={split.Ac.K} coarse_dim={prec.n_coarse} "
          f"assembly_s={t_asm:.3f} bdf2_loop_s={t_loop:.3f} "
          "setup_once: " + loop.parts("mixed.partition", "mixed.layout",
                                      "prec.level1", "prec.gdsw",
                                      "prec.coarse_layout")
          + f" padded_operator_builds={len(loop.each('mixed.layout'))} "
          f"min_det_F={min_j:.4f} "
          f"max_abs_d={float(d.abs().max()):.4f}")
    for i, st in enumerate(steps):
        print(f"hyperelastic step {i + 1}: t={st['t']} newton_its="
              f"{st['newton']} gmres_per_newton_step={st['gmres']} "
              f"criterion={st['criterion']:.3e} last_linear_host_f64_relres="
              f"{st['host_relres']:.3e} step_s={st['seconds']:.3f} "
              f"(tangent {st['tangent']:.3f}, residuals "
              f"{st['residual']:.3f}, solve {st['solve']:.3f})", flush=True)
    print(f"hyperelastic launches: {counts}", flush=True)
    _check(len(steps) == 3 and steps[0]["newton"] >= 3,
           f"Newton counts {[s['newton'] for s in steps]}")
    for st in steps:
        _check(st["criterion"] <= 1e-6 and st["newton"] < 10,
               f"Newton did not converge at t={st['t']}")
        _check(st["host_relres"] <= 1e-8,
               f"host relres {st['host_relres']} at t={st['t']}")
    _check(d.dtype == torch.float64 and bool(torch.isfinite(d).all())
           and min_j > 0, "finite displacement, no inverted element")
    _check(float(d.reshape(-1, 3)[:, 2].min()) < 0, "body sags under load")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(counts[k] > 0, f"hyperelastic block launched no {k}")
    # one B6 launch a residual (1 + Newton iterations + backtracks a step)
    # and a tangent (one a Newton iteration), no torch.func chunk
    reg = timers.counters()
    newton = sum(st["newton"] for st in steps)
    evals = len(steps) + 2 * newton + reg.get("newton.backtracks", 0)
    print(f"hyperelastic evaluations: B6 launches {counts['neo_hooke_p1']} "
          f"(residuals and tangents {evals}), torch.func chunks "
          f"{reg.get('hyper.autodiff_chunks', 0)}", flush=True)
    _check(counts["neo_hooke_p1"] == evals
           and reg.get("hyper.autodiff_chunks", 0) == 0,
           "every element evaluation one B6 launch")
    if hold_b123 is not None:
        hold_b123(" (hyperelastic)", db, split, prec, counts)
    b6 = _b6(torch, th, dom, d, prob.params)
    if entry is not None:
        entry("B6 neo_hooke_p1", "feddlib_tpu_torch/csrc/hyperelastic.cu",
              "none (jax.grad / jax.hessian, "
              "feddlib_tpu/fe/hyperelastic.py:103)", counts["neo_hooke_p1"],
              b6["rel_err"], b6["ms"], b6["plain_ms"], b6["bound"], None,
              err_kind="rel", residual_only=b6["residual_only"],
              previous_path_ms=b6["previous_path_ms"])
    del prob, tp, drv, cache, db, split, prec, d
    gc.collect()
    torch.cuda.empty_cache()

    # Newmark, f64 Jacobi: checkpoint at step 5, resume in a fresh
    # DAESolverInTime and problem; the resumed run must equal the uninterrupted one bit for
    # bit (nondeterministic ops are reported as warnings)
    def newmark(t_end, **kw):
        p = _linelas(torch, Domain.structured(3, args.n_newmark, device=dev),
                     {"Preconditioner Type": "Jacobi",
                      "Convergence Tolerance": 1e-10}, dev)
        p.init_vectors()
        load = p.rhs[0].clone()
        d = DAESolverInTime(TimeProblem(p), 0.05, t_end,
                            rhs_func=lambda t: BlockVector([load * t]),
                            **kw)
        d.advance_linear_newmark()
        return p.solution[0]

    import tempfile

    from feddlib_tpu_torch.fe.domain import Domain

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            ck = os.path.join(tmp, "newmark.npz")
            full = newmark(0.5)
            newmark(0.25, checkpoint_path=ck)
            resumed = newmark(0.5, resume_from=ck)
            again = newmark(0.5)
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).splitlines()[0] for w in caught
                     if "deterministic" in str(w.message)})
    diff = float((full - resumed).abs().max())
    print(f"newmark checkpoint: n_dofs={full.shape[0]} steps=10 (resumed "
          f"after 5) bitwise_equal={torch.equal(full, resumed)} "
          f"max_abs_diff={diff:.3e} repeat_bitwise_equal="
          f"{torch.equal(full, again)} max|d|={float(full.abs().max()):.4e}"
          f" nondeterministic_ops={nondet}", flush=True)
    _check(torch.equal(full, resumed), "resumed Newmark run bit for bit")
    _check(torch.equal(full, again), "repeated Newmark run bit for bit")
    _check(float(full.abs().max()) > 0, "Newmark run moves")
    _phase("9 unsteady hyperelasticity", t0)


def _sell_assemble_plain(torch, sl, plans, flat):
    """fe/fast_assembly.py sell_assemble with each split through the plain
    SELL version (B2's comparison): the sum over the splits of
    P_h @ (split h of the raw values, element-major)."""
    S, H = plans.S, plans.H
    f2 = flat.reshape(S, plans.n_elements)
    out = None
    for h, sm in enumerate(plans.mats):
        x = f2[:, h::H].T.reshape(-1)
        nx2 = (sm.shape[1] + 127) // 128
        x2d = torch.zeros(nx2 * 128, dtype=sm.vals.dtype, device=x.device)
        x2d[: sm.shape[1]] = x
        y = sl.sell_spmv_plain(sm.vals, sm.pidx, sm.bids,
                               x2d.reshape(nx2, 128), sm.E)[: sm.shape[0]]
        if sm.spill_rows is not None:
            y = y.index_add(0, sm.spill_rows, sm.spill_vals * x2d[sm.spill_cols])
        out = y if out is None else out + y
    return out


def _plan_csr(torch, np, pattern, plans, dev):
    """The 0/1 plan matrices P_h of sell_assembly_plans as torch CSR tensors
    (the yardstick of B2 on the assembly)."""
    import scipy.sparse as sps

    S, H, nE = plans.S, plans.H, plans.n_elements
    out = []
    for h in range(H):
        sel = np.arange(h, nE, H)
        w = len(sel)
        raw = np.arange(S)[:, None] * nE + sel[None, :]
        cols = np.arange(w)[None, :] * S + np.arange(S)[:, None]
        P = sps.csr_matrix((np.ones(S * w, np.float32),
                            (pattern.coo_slots[raw.ravel()], cols.ravel())),
                           shape=(pattern.nnz, w * S))
        out.append(torch.sparse_csr_tensor(
            torch.as_tensor(P.indptr, dtype=torch.int64, device=dev),
            torch.as_tensor(P.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(P.data, device=dev), size=P.shape))
    return out


def _phase10(torch, np, args, dev, entry):
    """Element assembly on the card (see the module docstring)."""
    from feddlib_tpu_torch.fe import assembly as asm
    from feddlib_tpu_torch.fe import fast_assembly as fa
    from feddlib_tpu_torch.fe import ops
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.la import sell as sl
    from feddlib_tpu_torch.la.csr import CsrMatrix

    t0 = time.perf_counter()

    def wall_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    def both_ways(dom, op, variants=False):
        """op ("laplace" | "mass") through assemble_fast (the card's
        default) and through the chunked path; their CSR data agree within
        1e-13 of max |data|; element kernel and scatter timed apart."""
        dim, fe, E = dom.dim, dom.fe_type, dom.n_elements
        assemble = {"laplace": ops.assemble_laplace,
                    "mass": ops.assemble_mass}[op]
        th = time.perf_counter()
        K_f = assemble(dom)
        os.environ["FEDD_FAST_ASSEMBLY"] = "0"
        try:
            K_c = assemble(dom)
        finally:
            os.environ.pop("FEDD_FAST_ASSEMBLY", None)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - th
        _check(np.array_equal(K_f.pattern.indptr, K_c.pattern.indptr)
               and np.array_equal(K_f.pattern.indices, K_c.pattern.indices),
               f"{op} {fe}: fast and chunked CSR structure")
        err = float((K_f.data - K_c.data).abs().max()
                    / K_c.data.abs().max())
        vcT, vc = dom.vert_coords_T(), dom.vert_coords()
        kern = fa._KERNELS[op]
        ck = {"laplace": asm.elem_laplace, "mass": asm.elem_mass}[op]
        pat_f, pat_c = fa.pattern_abe(dom, 1), ops._square_pattern(dom, 1)

        def chunked_kernel():
            return torch.cat([ck(vc[s:s + ops._CHUNK], dim, fe).reshape(-1)
                              for s in range(0, E, ops._CHUNK)])

        def scatter(pat, flat):
            m = CsrMatrix(pat, device=dev)
            m.assemble(flat)
            return m.data

        flat_f = kern(vcT, dim, fe)
        flat_c = chunked_kernel()
        t = {"fast_kernel": lambda: kern(vcT, dim, fe),
             "fast_scatter": lambda: scatter(pat_f, flat_f),
             "fast_total": lambda: fa.assemble_fast(dom, op),
             "chunked_kernel": chunked_kernel,
             "chunked_scatter": lambda: scatter(pat_c, flat_c),
             "chunked_total": lambda: ops._assemble_chunked(
                 dom, pat_c, lambda v: ck(v, dim, fe))}
        if variants:
            # the choice of the card's scatter: the f64 scatter-set taken
            # (fast_scatter), the JAX package's three f32 parts
            # (assemble_csr_data_tri) and the former index_add_ (atomics)
            kind, pos, Dp = pat_f._device_plan(dev)
            nnz = pat_f.nnz
            idx = torch.as_tensor(pat_f.coo_slots, device=dev)

            def tri():
                v1 = flat_f.float()
                r1 = flat_f - v1.double()
                v2 = r1.float()
                v3 = (r1 - v2.double()).float()
                total = torch.zeros(nnz, dtype=torch.float64, device=dev)
                for part in (v1, v2, v3):
                    buf = torch.zeros(nnz * Dp, device=dev)
                    buf[pos] = part
                    total += buf.reshape(nnz, Dp).double().sum(1)
                return total

            _check(kind == "set" and float((tri() - scatter(pat_f, flat_f))
                                           .abs().max()) <= 1e-13 * float(
                K_f.data.abs().max()), "tri-split scatter")
            t["tri_f32_scatter"] = tri
            t["index_add_scatter"] = lambda: torch.zeros(
                nnz, dtype=torch.float64, device=dev).index_add_(0, idx,
                                                                 flat_f)
        dev_ms = {k: _device_ms(torch, fn, samples=5, calls=3)
                  for k, fn in t.items()}
        host_ms = {k: wall_ms(fn) for k, fn in t.items()}
        print(f"assembly {op} {fe} E={E} n_raw={flat_f.numel()} "
              f"nnz={K_f.nnz} Dp={pat_f.duplication_plan()[1]} "
              f"fast_vs_chunked={err:.3e} first_call_s={first_s:.3f} (the "
              f"host patterns and plans inside) device_ms="
              f"{ {k: round(v, 4) for k, v in dev_ms.items()} } wall_ms="
              f"{ {k: round(v, 4) for k, v in host_ms.items()} }",
              flush=True)
        _check(err <= 1e-13, f"{op} {fe}: fast vs chunked {err}")
        return K_f

    dom = Domain.structured(3, args.n_asm, device=dev)
    K = both_ways(dom, "laplace", variants=True)
    both_ways(dom, "mass")
    dom2 = Domain.structured(3, args.n_asm_p2, device=dev).p2_domain()
    both_ways(dom2, "laplace")
    del dom2
    gc.collect()
    torch.cuda.empty_cache()

    # B2 as the scatter: the P1 Laplace plan in f32, the JAX split rule
    pat = fa.pattern_abe(dom, 1)
    th = time.perf_counter()
    plans = fa.sell_assembly_plans(pat, dom.n_elements, dtype=torch.float32,
                                   device=dev)
    torch.cuda.synchronize()
    plans_s = time.perf_counter() - th
    flat32 = fa.elem_laplace_flat_T(dom.vert_coords_T(), 3, "P1").float()
    _cuda.reset_launch_counts()
    y = fa.sell_assemble(plans, flat32)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts["sell_spmv"]
    y_p = _sell_assemble_plain(torch, sl, plans, flat32)
    err = float((y - y_p).abs().max())
    ref32 = K.data.float()
    rel = float((y - ref32).abs().max() / ref32.abs().max())
    mats = plans.mats
    slots = sum(m.vals.numel() for m in mats)
    nonzero = sum(int((m.vals != 0).sum()) for m in mats)
    spill = sum(0 if m.spill_rows is None else m.spill_rows.numel()
                for m in mats)
    x2d_n = sum((m.shape[1] + 127) // 128 * 128 for m in mats)
    print(f"B2 shapes (assembly plan): splits={plans.H} S={plans.S} "
          f"elements_per_split={mats[0].shape[1] // plans.S} "
          f"n_raw={flat32.numel()} nnz={pat.nnz} E={[m.E for m in mats][:1]}"
          f" K={[m.K for m in mats][:1]} nchunks={mats[0].vals.shape[0]} "
          f"slots={slots} nonzero={nonzero} spill={spill} "
          f"plans_build_s={plans_s:.3f} plane_bytes={6 * slots} "
          f"launches_per_assembly={launches} vs_plain={err:.3e} "
          f"vs_f64_assembly_rel={rel:.3e}", flush=True)
    _check(launches == plans.H, f"B2 launched {launches} times, not "
           f"{plans.H}")
    _check(err <= 1e-6 * float(y_p.abs().max()), f"B2 assembly error {err}")
    _check(rel <= 1e-5, f"SELL assembly vs f64 assembly {rel}")
    P_t = _plan_csr(torch, np, pat, plans, dev)

    def lib(flat):
        g2 = flat.reshape(plans.S, plans.n_elements)
        return sum(P_t[h] @ g2[:, h::plans.H].T.reshape(-1)
                   for h in range(plans.H))

    _check(float((lib(flat32) - y_p).abs().max())
           <= 1e-5 * float(y_p.abs().max()), "B2 assembly yardstick")
    b_bytes = (6 * slots + 4 * sum(m.bids.numel() for m in mats)
               + 4 * x2d_n + 4 * sum(m.vals.numel() // m.E for m in mats))
    free_bytes = 4 * flat32.numel() + 4 * pat.nnz
    cold = {"ms": _device_ms(torch, _cold_calls(
        lambda f: fa.sell_assemble(plans, f), flat32), samples=10, calls=3),
        "library_ms": _device_ms(torch, _cold_calls(lib, flat32),
                                 samples=10, calls=3)}
    entry("B2 sell_spmv (assembly plan)", "feddlib_tpu_torch/csrc/sell.cu",
          "feddlib_tpu/la/sell.py:354", launches, err,
          _device_ms(torch, lambda: fa.sell_assemble(plans, flat32),
                     samples=10, calls=3),
          _device_ms(torch, lambda: _sell_assemble_plain(torch, sl, plans,
                                                         flat32),
                     samples=3, calls=1),
          _bound(b_bytes, 2 * nonzero, PEAK_F32_S),
          _device_ms(torch, lambda: lib(flat32), samples=10, calls=3),
          l2_cold=cold,
          bounds={"planes_as_stored_ms": _bound(b_bytes, 0, PEAK_F32_S)[0],
                  "raw_values_in_csr_out_ms": _bound(free_bytes, 0,
                                                     PEAK_F32_S)[0]},
          wall_ms={"sell_assemble": wall_ms(
              lambda: fa.sell_assemble(plans, flat32)),
              "library": wall_ms(lambda: lib(flat32))})
    del plans, P_t, y, y_p, flat32, K, dom, pat
    gc.collect()
    torch.cuda.empty_cache()

    # Q2 hex: vector Laplace and the P1-disc divergence, card against CPU
    dh = Domain.structured_hex(3, args.n_hex, "Q2", device=dev)
    dc = Domain.structured_hex(3, args.n_hex, "Q2", device="cpu")
    dc._patterns = dh._patterns  # host patterns, built once
    th = time.perf_counter()
    A = ops.assemble_hex_laplace_vec(dh)
    B, BT = ops.assemble_divergence_p1disc(dh)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - th
    th = time.perf_counter()
    Ac = ops.assemble_hex_laplace_vec(dc)
    Bc, _ = ops.assemble_divergence_p1disc(dc)
    cpu_s = time.perf_counter() - th
    errs = [float((m.data.cpu() - c.data).abs().max() / c.data.abs().max())
            for m, c in ((A, Ac), (B, Bc))]
    print(f"hex Q2: elements={dh.n_elements} velocity_dofs={A.shape[0]} "
          f"A_nnz={A.nnz} B={B.shape} B_nnz={B.nnz} card_s={card_s:.3f} "
          f"(patterns inside) cpu_s={cpu_s:.3f} card_vs_cpu_rel={errs}",
          flush=True)
    _check(max(errs) <= 1e-12, f"hex card vs CPU {errs}")
    _check(BT.shape == (B.shape[1], B.shape[0]), "B transpose")
    _phase("10 element assembly", t0)


IFACE = 9  # the interface flag of the two-box FSI setup


def _fsi_two_box(torch, dim, n, params, device):
    """The two-box FSI of tests/test_fsi.py:24: a fluid box above a solid
    box of the unit square (cube), the interface x_{dim-1} = 0.5 flagged 9
    on both meshes, each build_structured_mesh(dim, (n, .., ⌈n/2⌉ in 3D));
    fluid P2/P1, solid P2, the lid u = 0.5 e_0 on the top and no-slip walls
    on flag 1, the solid clamped on flag 1; Viscosity 0.1, E 50, ν 0.3,
    dt 0.02.  Returns the assembled FSI problem."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh
    from feddlib_tpu_torch.problems.fsi import FSI
    from feddlib_tpu_torch.utils.config import ParameterList

    import numpy as np

    cells = (n, n) if dim == 2 else (n, n, (n + 1) // 2)
    lo_f, hi_s = [0.0] * dim, [1.0] * dim
    lo_f[-1] = hi_s[-1] = 0.5
    meshes = [build_structured_mesh(dim, cells, lower=lo_f,
                                    upper=[1.0] * dim),
              build_structured_mesh(dim, cells, lower=[0.0] * dim,
                                    upper=hi_s)]
    for mesh in meshes:
        mesh.point_flags[np.isclose(mesh.points[:, -1], 0.5)] = IFACE
        on = np.all(np.isclose(mesh.points[mesh.surfaces][:, :, -1], 0.5),
                    axis=1)
        mesh.surface_flags[on] = IFACE
    dom_fp = Domain(meshes[0], device=device)
    dom_d = Domain(meshes[1], device=device).p2_domain()
    prob = FSI(dom_fp.p2_domain(), dom_fp, dom_d, [IFACE],
               parameter_list=ParameterList("P", dict(
                   {"Viscosity": 0.1, "E": 50.0, "Poisson Ratio": 0.3,
                    "dt": 0.02, "MaxNonLinIts": 12}, **params)),
               device=device)
    prob.assemble()

    def lid(x, t):
        on = torch.isclose(x[dim - 1], torch.ones((), dtype=x.dtype,
                                                  device=x.device))
        return torch.stack([0.5 * on.double()] + [0.0 * x[0]] * (dim - 1))

    prob.add_bc(lid, 1, 0)
    prob.add_bc(lambda x, t: [0.0] * dim, 1, 2)
    return prob


def _level1_shape(np, A, cluster):
    """(P, R, W) of the padded cluster blocks DenseBlockSpMV.from_csr(...,
    balance=True) builds for this matrix and these clusters, computed on
    the host before anything is allocated on the card."""
    from feddlib_tpu_torch.la.dense_blocks import rebalance_row_clusters

    sp = A.to_scipy().tocsr()
    rc = rebalance_row_clusters(sp, cluster)
    P = int(rc.max()) + 1
    R = -(-int(np.bincount(rc, minlength=P).max()) // 8) * 8
    coo = sp.tocoo()
    off = rc[coo.row] != rc[coo.col]
    key = np.unique(rc[coo.row[off]].astype(np.int64) * A.shape[0]
                    + coo.col[off])
    G = int(np.bincount(key // A.shape[0], minlength=P).max())
    W = -(-(R + max(G, 1)) // 8) * 8
    return P, R, W + (8 if W % 128 == 0 else 0)


def _phase11(torch, np, args, dev, hold_b123):
    """Serial FSI (see the module docstring): 11a the 3D GE loop on the
    mixed-precision path (B1-B3 on the four-field system), 11b the 2D GE
    step with FaCSI, 11c the 2D GI step with the shape derivatives."""
    from feddlib_tpu_torch.fe import shape_derivatives as sd
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.la.block import BlockMatrix
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    t0 = time.perf_counter()
    # -- 11a: 3D two-box GE, mixed precision, 'SchwarzOneLevel' ------------
    # GMRES(100) with 1,000 inner iterations a pass stalls on this
    # saddle-point system (host relres 0.14 after 8 passes); GMRES(1000)
    # with 3,000 reaches 1e-8 in two passes
    prob = _fsi_two_box(torch, 3, args.n_fsi, {
        "Use Mixed Precision": True, "Preconditioner Type": "SchwarzOneLevel",
        "Clusters": args.fsi_clusters, "Convergence Tolerance": 1e-8,
        "Num Blocks": 1000, "Maximum Iterations": 3000,
        "relNonLinTol": 1e-6}, dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    sizes = prob.block_sizes()
    # the level-1 shape on the host, before the card allocates it: the
    # first Newton system's pattern (every later one is alike)
    prob._build_system("Newton", torch.zeros_like(prob.solution[0]),
                       1.0 / prob.dt,
                       1.0 / (prob.newmark_beta * prob.dt ** 2))
    A0 = prob.bc_system().merge()
    dom0 = prob.domains[0]
    dof_map = prob.preconditioner._merged_dof_map(
        MeshPartition(dom0.parent_p1.mesh, args.fsi_clusters))
    cluster = np.zeros(A0.shape[0], np.int32)
    for p, ix in enumerate(dof_map.partition_indices):
        cluster[ix] = p
    P, R, W = _level1_shape(np, A0, cluster)
    gb = {"blocks_and_inverse": 2 * 4 * P * R * W / 1e9,
          "factor_square_blocks": 4 * P * W * W / 1e9}
    print(f"fsi 3D: n={args.n_fsi} n_dofs={sum(sizes)} (u {sizes[0]}, p "
          f"{sizes[1]}, d {sizes[2]}, lambda {sizes[3]}) nnz={A0.nnz} "
          f"level-1 [P, R, W]=[{P}, {R}, {W}] f32 GB "
          f"{ {k: round(v, 2) for k, v in gb.items()} }", flush=True)
    _check(gb["factor_square_blocks"] <= 40.0,
           f"fsi level-1 factor would take {gb['factor_square_blocks']:.1f}"
           f" GB of square blocks (> 40 GB): lower --n-fsi")
    del A0
    prob.system = None

    # a time step's parts from the program's spans: the geometry solve
    # before its Newton, the tangent reassemblies (each builds the
    # system), the merges and the rebuilt clusters, SELL layout and level-1
    # factor (the mixed solve builds the one-level layout of a multi-field
    # system anew for each merged matrix, so at every Newton step), and
    # the refinement (the solve proper)
    parts = (("geometry", "fsi.geometry"), ("tangent", "newton.tangent"),
             ("merge", "block.merge"), ("partition", "mixed.partition"),
             ("layout", "mixed.layout"), ("factor", "prec.level1"),
             ("solve", "refinement.pass"))
    steps, last = [], {}
    merge = BlockMatrix.merge

    def merge_and_keep(self):
        out = merge(self)
        last["A"] = out
        return out

    solve_system = prob.linear_solver.solve_system

    def solve_and_keep(problem, b):
        x, its = solve_system(problem, b)
        last.update(b=b, x=x)
        return x, its

    newton_solve = NonLinearSolver.solve
    # a step runs from the end of the previous one (the geometry solve,
    # mesh move and ALE operator come before its Newton)
    mark = {}

    def newton_and_record(self, problem, t=0.0):
        t1 = time.perf_counter_ns()
        its = newton_solve(self, problem, t)
        torch.cuda.synchronize()
        now = time.perf_counter_ns()
        st = {"t": t, "newton": its, "gmres": list(self.linear_iters),
              "criterion": self.final_criterion,
              "newton_s": (now - t1) * 1e-9,
              "seconds": (now - mark["t"]) * 1e-9,
              "geometry_its": problem.geometry.last_iters,
              "geometry_relres": problem.geometry.last_relres,
              **{k: reg.s(n, lo=mark["t"], hi=now) for k, n in parts}}
        mark["t"] = now
        # the host check is not in the step's seconds
        st["host_relres"] = _host_relres(np, last["A"].to_scipy(),
                                         last["b"].concat(),
                                         last["x"].concat())
        steps.append(st)
        return its

    NonLinearSolver.solve = newton_and_record
    BlockMatrix.merge = merge_and_keep
    prob.linear_solver.solve_system = solve_and_keep
    _cuda.reset_launch_counts()
    t1 = time.perf_counter()
    mark["t"] = time.perf_counter_ns()
    try:
        with _Registry() as reg:
            prob.advance(t_end=0.04)
    finally:
        NonLinearSolver.solve = newton_solve
        BlockMatrix.merge = merge
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t1
    counts = dict(_cuda.launch_counts)
    cache = prob._mixed_cache
    db, split, prec = cache["db32"], cache["sell"], cache["prec"]
    print(f"fsi 3D: P={db.P} R={db.R} G={db.G} W={db.R + db.G} "
          f"E={split.Ac.E} K={split.Ac.K} (host estimate [{P}, {R}, {W}]) "
          f"assembly_s={t_asm:.3f} ge_loop_s={t_loop:.3f} "
          f"padded_operator_builds={len(reg.each('mixed.layout'))}",
          flush=True)
    for i, st in enumerate(steps):
        print(f"fsi 3D step {i + 1}: newton_its={st['newton']} "
              f"gmres_per_newton_step={st['gmres']} criterion="
              f"{st['criterion']:.3e} last_linear_host_f64_relres="
              f"{st['host_relres']:.3e} geometry_gmres_its="
              f"{st['geometry_its']} geometry_relres="
              f"{st['geometry_relres']:.3e} step_s={st['seconds']:.3f} "
              f"newton_s={st['newton_s']:.3f} (" + ", ".join(
                  f"{k} {st[k]:.3f}" for k, _ in parts) + ")", flush=True)
    print(f"fsi 3D launches: {counts}", flush=True)
    u, d = prob.solution[0], prob.solution[2]
    _check(len(steps) == 2, f"fsi time steps {len(steps)}")
    for st in steps:
        _check(st["criterion"] <= 1e-6 and st["newton"] < 12,
               f"fsi Newton did not converge: {st['criterion']}")
        _check(st["host_relres"] <= 1e-8,
               f"fsi last linear solve host relres {st['host_relres']}")
    _check(u.dtype == torch.float64 and bool(torch.isfinite(u).all())
           and bool(torch.isfinite(d).all()), "fsi finite f64 fields")
    _check(float(d.abs().max()) > 0 and float(prob.solution[3].abs().max())
           > 0, "fsi solid moves, traction transferred")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(counts[k] > 0, f"fsi launched no {k}")
    hold_b123(" (fsi)", db, split, prec, counts)
    del prob, cache, db, split, prec, u, d, last
    gc.collect()
    torch.cuda.empty_cache()
    _phase("11a fsi 3D mixed", t0)

    # -- 11b: 2D two-box GE with FaCSI ---------------------------------------
    t1 = time.perf_counter()
    small = []  # the small reference case, on the card then the CPU
    for d_ in (dev, "cpu"):
        p = _fsi_two_box(torch, 2, 4, {
            "Preconditioner Type": "FaCSI", "Subdomains": 4,
            "Maximum Iterations": 8000, "Convergence Tolerance": 1e-9}, d_)
        p.advance(t_end=0.04)
        small.append((p.nonlinear_solver.linear_iters,
                      p.solution.concat().cpu()))
    prob = _fsi_two_box(torch, 2, args.n_fsi2d, {
        "Preconditioner Type": "FaCSI", "Subdomains": 32,
        "Convergence Tolerance": 1e-8}, dev)
    t2 = time.perf_counter()
    _, reg = _measured(prob.advance, t_end=0.02)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t2
    (its_card, x_card), (its_cpu, x_cpu) = small
    dsmall = float((x_card - x_cpu).abs().max() / x_cpu.abs().max())
    print(f"fsi 2D FaCSI small (n=4, 2 steps) card vs cpu: gmres "
          f"{its_card} vs {its_cpu} (JAX package: [21, 21, 21, 21]) "
          f"rel={dsmall:.3e}")
    _check(its_card == its_cpu and dsmall <= 1e-8
           and all(abs(i - 21) <= 2 for i in its_card),
           "small FaCSI case card vs CPU")
    solver = prob.nonlinear_solver
    sizes = prob.block_sizes()
    pre = prob.preconditioner.prec
    r = torch.randn(sum(sizes), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    apply_ms = _device_ms(torch, lambda: pre.apply(r), samples=5, calls=5)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(10):
        pre.apply(r)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - tw) * 100.0
    voi = prob.values_of_interest(tip_point=(0.5, 0.5), force_flags=(1,))
    print(f"fsi 2D FaCSI: n={args.n_fsi2d} n_dofs={sum(sizes)} (u "
          f"{sizes[0]}, p {sizes[1]}, d {sizes[2]}, lambda {sizes[3]}) "
          f"newton_its={len(solver.linear_iters)} gmres_per_newton_step="
          f"{solver.linear_iters} criterion={solver.final_criterion:.3e} "
          f"last_relres={prob.last_relres:.3e} step_s={t_step:.3f}")
    S_solid, S_fluid = pre.solid_prec.S, pre.fluid_prec.S
    for i, (so, fl) in enumerate(zip(reg.each("facsi.solid"),
                                     reg.each("facsi.fluid"))):
        print(f"fsi 2D FaCSI build {i + 1}: S solid {S_solid}, fluid "
              f"{S_fluid}; seconds solid {so:.3f}, fluid {fl:.3f}")
    print(f"fsi 2D FaCSI apply: {apply_ms:.3f} ms (device) {wall_ms:.3f} ms "
          f"(wall); values_of_interest {voi}", flush=True)
    _check(solver.final_criterion <= 1e-6 and prob.last_relres <= 1e-8,
           "fsi 2D FaCSI Newton / GMRES")
    _check(S_solid < 4096 and S_fluid < 4096
           and pre.solid_prec.solver == pre.fluid_prec.solver == "dense",
           "FaCSI subdomains take dense f64 inverses (S < 4096)")
    _check(all(np.isfinite(v) for v in voi.values()), "finite observables")
    del prob, pre, r
    gc.collect()
    torch.cuda.empty_cache()
    _phase("11b fsi 2D FaCSI", t1)

    # -- 11c: 2D GI with the shape derivatives on the card --------------------
    t1 = time.perf_counter()
    prob = _fsi_two_box(torch, 2, args.n_fsi_gi, {
        "Preconditioner Type": "SchwarzOneLevel", "Subdomains": 16}, dev)
    prob.advance_gi(t_end=0.02)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t1
    solver = prob.nonlinear_solver
    sizes = prob.block_sizes()
    dom_u, dom_p = prob.variables[0][0], prob.variables[1][0]
    u, p, _, _, g = prob.solution.blocks
    gp = torch.zeros_like(g)
    uo = 0.5 * u
    args_sd = (prob.viscosity, prob.density_f, prob.dt, 1.0 / prob.dt)
    Dug, Dpg = sd.assemble_shape_derivative_blocks(
        dom_u, dom_p, u, p, g, gp, uo, *args_sd)
    cu = Domain(dom_u.mesh, device="cpu")
    cp = Domain(dom_p.mesh, device="cpu")
    Duc, Dpc = sd.assemble_shape_derivative_blocks(
        cu, cp, u.cpu(), p.cpu(), g.cpu(), gp.cpu(), uo.cpu(), *args_sd)
    err = max(float((Dug.data.cpu() - Duc.data).abs().max()
                    / Duc.data.abs().max()),
              float((Dpg.data.cpu() - Dpc.data).abs().max()
                    / Dpc.data.abs().max()))
    # one shape-derivative chunk: device ms and peak bytes
    E = min(sd._CHUNK, dom_u.n_elements)
    conn_u = torch.as_tensor(dom_u.elem_nodes()[:E], device=dev)
    ref = torch.as_tensor(dom_u.mesh.ref_points[
        dom_u.mesh.elements[:E, :3]], dtype=torch.float64, device=dev)
    fe = [v.reshape(-1, 2)[conn_u] for v in (u, g, gp, uo)]
    pe = p[torch.as_tensor(dom_p.elem_nodes()[:E], device=dev)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    chunk_ms = _device_ms(torch, lambda: sd.elem_shape_derivative(
        fe[0], pe, fe[1], fe[2], ref, fe[3], 2, "P2", "P1", *args_sd),
        samples=5, calls=2)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"fsi 2D GI: n={args.n_fsi_gi} n_dofs={sum(sizes)} {sizes} "
          f"newton_its={len(solver.linear_iters)} gmres_per_newton_step="
          f"{solver.linear_iters} criterion={solver.final_criterion:.3e} "
          f"last_relres={prob.last_relres:.3e} step_s={t_step:.3f}")
    print(f"fsi 2D GI shape derivatives: D_ug nnz={Dug.nnz} D_pg nnz="
          f"{Dpg.nnz} card_vs_cpu_rel={err:.3e}; one chunk of {E} elements "
          f"{chunk_ms:.3f} ms (device) peak_bytes={peak}", flush=True)
    _check(len(sizes) == 5 and solver.final_criterion <= 1e-6
           and prob.last_relres <= 1e-8, "fsi 2D GI Newton / GMRES")
    _check(err <= 1e-12, f"shape-derivative blocks card vs CPU {err}")
    _check(bool(torch.isfinite(prob.solution.concat()).all()),
           "finite GI solution")
    _phase("11c fsi 2D GI", t1)
    _phase("11 fsi", t0)


def _stacked_bytes(torch, *objs):
    """Device bytes of the tensors in `objs` (nested lists / tuples), each
    storage counted once (an expanded view is its one copy)."""
    seen, total = set(), 0

    def walk(o):
        nonlocal total
        if isinstance(o, (list, tuple)):
            for a in o:
                walk(a)
        elif torch.is_tensor(o):
            st = o.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()

    for o in objs:
        walk(o)
    return total


def _phase12(torch, np, args, dev, ref7):
    """The distributed solve, shards stacked on the card (see the module
    docstring)."""
    import scipy.sparse as sps

    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.schwarz import grow_overlap

    t0 = time.perf_counter()
    n_dev = args.dist_devices
    params = {"Use Distributed Solve": True, "Devices": n_dev,
              "Preconditioner Type": "SchwarzTwoLevel",
              "Convergence Tolerance": 1e-8}
    t_asm = time.perf_counter()
    prob = _default_laplace(torch, args.n_dist, params, dev)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t_asm
    A = prob.bc_system().get_block(0, 0)
    A_sp = A.to_scipy()
    # the host estimate of level 1 before the card holds any of it: the
    # overlap-1 sets of the partition the solve will take
    part = MeshPartition(prob.domains[0].mesh, n_dev)
    S_est = max(len(grow_overlap(A_sp, ix, 1))
                for ix in part.unique_map.partition_indices)
    print(f"distributed: n_dofs={A.shape[0]} shards={n_dev} level-1 "
          f"estimate [{n_dev}, {S_est}, {S_est}] f64 = "
          f"{n_dev * S_est * S_est * 8} bytes (host)", flush=True)
    del part
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t1 = time.perf_counter()
    iters, reg = _measured(prob.solve)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    x = prob.solution[0].clone()
    u = x.cpu().numpy()
    rel = _host_relres(np, A_sp, prob.rhs[0], x)
    cache = prob._dist_cache
    dmat, solver = cache["dmat"], cache["solver"]
    build, arrs = cache["precond"]
    sh = build.shape
    setup_s = reg.s("dist.partition", "dist.matrix", "dist.precond")
    _check(x.device.type == "cuda" and dmat.ell_data.device.type == "cuda"
           and arrs[0].device.type == "cuda", "distributed solve on the card")
    print(f"distributed setup s: {reg.parts('dist.partition')} "
          f"matrix={reg.s('dist.matrix'):.3f} ("
          + reg.parts("dist.rows", "dist.halo_plan", "dist.ell")
          + f") precond={reg.s('dist.precond'):.3f} ("
          + reg.parts("prec.overlap", "prec.overlap_plan", "prec.blocks",
                      "prec.factor", "prec.gdsw", "prec.phi",
                      "prec.coarse_solver")
          + f") total={setup_s:.3f}", flush=True)
    cs, co = dmat.plan.comm_stats(), sh["comm"]
    l1_bytes = _stacked_bytes(torch, arrs[0])
    all_bytes = _stacked_bytes(torch, arrs, dmat.ell_data, dmat.ell_cols,
                               dmat.plan.import_arrays,
                               dmat.plan.export_arrays)
    print(f"distributed shapes: level1 [{n_dev}, {sh['S']}, {sh['S']}] "
          f"N_o={dmat.plan.N_o} G={dmat.plan.G} K={dmat.K} "
          f"G_ov={sh['G_ov']} C_loc={sh['C_loc']} nc={sh['nc']} "
          f"level1_bytes={l1_bytes} operator_and_prec_bytes={all_bytes} "
          f"allocated_after_setup={torch.cuda.memory_allocated() - m0} "
          f"peak_in_solve={torch.cuda.max_memory_allocated() - m0}; "
          f"SpMV halo {cs['rounds']} rounds / {cs['ppermute_elems']} "
          f"ppermute elems (all_gather {cs['allgather_elems']}), overlap "
          f"halo {co['rounds']} rounds / {co['ppermute_elems']} elems",
          flush=True)
    _check(sh["S"] == S_est, "level-1 width equals the host estimate")
    ref7s = ("" if ref7 is None else f" phase7_iters={ref7['iters']} "
             f"phase7_host_relres={ref7['relres']:.3e}")
    print(f"distributed solve: gmres_iters={iters} relres="
          f"{prob.last_relres:.3e} host_f64_relres={rel:.3e} "
          f"first_solve_s={t_first:.3f} (setup {setup_s:.3f} inside, "
          f"GMRES {t_first - setup_s:.3f}){ref7s} hopper_launches="
          f"{dict(_cuda.launch_counts)}", flush=True)
    _check(rel <= 1e-8, f"distributed host residual {rel} > 1e-8")
    same_system = ref7 is not None and (args.n_dist == ref7["n"]
                                        and n_dev == ref7["parts"])
    if ref7 is None:
        print("distributed vs phase 7: comparison skipped (phase 7 not "
              "run)", flush=True)
    elif same_system:
        dx = float(np.abs(u - ref7["x"]).max())
        print(f"distributed vs phase 7: max|x_dist - x_serial|={dx:.3e} "
              f"max|x|={np.abs(u).max():.3e}")
        _check(abs(iters - ref7["iters"]) <= 1,
               f"distributed {iters} vs serial {ref7['iters']} iterations")
        _check(dx <= 1e-6 * float(np.abs(u).max()),
               "distributed solution against phase 7's")
    else:
        # only a caller's flags may part the two systems, never the defaults
        ap = _parser()
        _check(any(getattr(args, k) != ap.get_default(k) for k in
                   ("n_dist", "dist_devices", "n_schwarz", "schwarz_parts")),
               "the default phase 12a system differs from phase 7's")
        print(f"distributed vs phase 7: comparison skipped: --n-dist "
              f"{args.n_dist} / --dist-devices {n_dev} differ from phase "
              f"7's --n-schwarz {ref7['n']} / --schwarz-parts "
              f"{ref7['parts']}", flush=True)

    # a second solve reuses the cached shards and preconditioner
    t2 = time.perf_counter()
    iters2 = prob.solve()
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t2
    _check(prob._dist_cache is cache and iters2 == iters
           and torch.equal(prob.solution[0], x),
           "second distributed solve: cached and bitwise equal")
    print(f"distributed second solve: {t_second:.3f} s, bitwise equal, "
          f"cache reused", flush=True)

    # one A apply and one M(A(x)) of the solve, device and wall ms
    A_fn, M_fn = solver.operators(cache["precond"])
    xs = torch.randn(n_dev, dmat.plan.N_o, dtype=torch.float64, device=dev)
    xs = xs * dmat.plan.owned_mask
    a_ms = _device_ms(torch, lambda: A_fn(xs), samples=10, calls=5)
    ma_ms = _device_ms(torch, lambda: M_fn(A_fn(xs)), samples=10, calls=5)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(10):
        M_fn(A_fn(xs))
    torch.cuda.synchronize()
    ma_wall = (time.perf_counter() - tw) / 10 * 1e3
    tw = time.perf_counter()
    for _ in range(10):
        A_fn(xs)
    torch.cuda.synchronize()
    a_wall = (time.perf_counter() - tw) / 10 * 1e3
    la = _launches(torch, dev, lambda: A_fn(xs))[0]
    lm = _launches(torch, dev, lambda: M_fn(xs))[0]
    print(f"distributed applies: A_ms={a_ms:.5f} (device) A_wall_ms="
          f"{a_wall:.5f} A_launches={la} M(A(x))_ms={ma_ms:.5f} (device) "
          f"M(A(x))_wall_ms={ma_wall:.5f} M_launches={lm}", flush=True)
    # phase 13a's reference: this solve and its split matrix, collected
    ref12 = {"n": args.n_dist, "parts": n_dev, "iters": iters, "x": u,
             "A": _collect_csr(np, dmat), "asm_s": t_asm,
             "dmat_s": reg.s("dist.matrix")}
    del prob, A, cache, dmat, solver, build, arrs, A_fn, M_fn, xs
    gc.collect()
    torch.cuda.empty_cache()
    _phase("12a distributed solve", t0)

    # 12b: the card against the CPU at a small size
    t1 = time.perf_counter()
    for name, fn in _dist_cases(torch):
        _small_pair(np, name, [fn(dev), fn(torch.device("cpu"))])
    _phase("12b distributed card vs cpu", t1)
    _phase("12 distributed", t0)
    return ref12


def _laplace2d(torch, n, params, device):
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    prob = Laplace(Domain.structured(2, n, device=device),
                   parameter_list=ParameterList("P", dict(params)),
                   device=device)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def _stokes2d(torch, n, params, device):
    """The lid-driven P2/P1 Stokes cavity of tests/test_schwarz.py:81 with
    'SchwarzTwoLevel' (the monolithic block GDSW) and one pressure pin."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.stokes import Stokes
    from feddlib_tpu_torch.utils.config import ParameterList

    dom_p = Domain.structured(2, n, device=device)
    prob = Stokes(dom_p.p2_domain(), dom_p, parameter_list=ParameterList(
        "P", dict(params, **{"Viscosity": 1.0,
                             "Preconditioner Type": "SchwarzTwoLevel",
                             "Maximum Iterations": 4000})), device=device)
    prob.assemble()
    prob.add_bc(lambda x, t: torch.stack(
        [torch.isclose(x[1], torch.ones_like(x[1])).double(), 0.0 * x[0]]),
        1, 0)
    dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
    dom_p.mesh.point_flags[0] = 77
    prob.bc_builder.add_bc(lambda x, t: 0.0, 77, 1, dom_p, "Dirichlet", 1)
    prob.set_boundaries_rhs()
    return prob


def _small_pair(np, name, out):
    ([it_c], x_c), ([it_h], x_h) = out  # the card's run, the CPU's
    dx = float(np.abs(x_c - x_h).max())
    print(f"distributed {name} cuda vs cpu: iters {it_c} vs {it_h}, "
          f"max|dx|={dx:.3e} max|x|={np.abs(x_h).max():.3e}", flush=True)
    _check(it_c == it_h and dx <= 1e-9 * float(np.abs(x_h).max()),
           f"distributed {name} cuda vs cpu")


def _collect_csr(np, dmat):
    """Distributed ELL → global scipy CSR (the check's oracle, as
    tests/test_fsi_pipeline.py:21 collects it)."""
    import scipy.sparse as sps

    n = dmat.n_global
    rows_l, cols_l, vals_l = [], [], []
    for p in range(dmat.n_dev):
        owned, R = dmat.local_rows(p)
        if len(owned):
            coo = R.tocoo()
            rows_l.append(owned[coo.row])
            cols_l.append(coo.col)
            vals_l.append(coo.data)
    return sps.csr_matrix((np.concatenate(vals_l),
                           (np.concatenate(rows_l), np.concatenate(cols_l))),
                          shape=(n, n))


def _pipe_bytes(torch, pipe):
    """Device bytes of a pipeline's plans and geometry."""
    fps = [(fp["pos"], fp["mask"], fp["elem_idx"], fp["plan"].import_arrays)
           for fp in pipe.field_plans.values()]
    return _stacked_bytes(
        torch, pipe.seg_ids, pipe._seg_plan, pipe._xc_sidx, pipe._xc_rdst,
        pipe._xc_src, pipe._xc_plan, pipe.ell_cols, pipe.ell_src, pipe._diag,
        pipe.const_vals, pipe.mesh_vc, pipe.mesh_valid,
        list(pipe.mesh_vc_ref.values()), list(pipe.row_wts.values()),
        list(pipe.elem_data.values()), pipe.plan.import_arrays,
        pipe.plan.export_arrays, fps)


# the child spans of `pipe.finalize` (parallel/pipeline.py)
PIPE_PARTS = tuple("pipe." + k for k in (
    "keys", "patterns", "send", "rounds", "ell", "halo", "geometry",
    "fields"))


def _rounds(pipe):
    """(rounds, Σ W a shard, elements moved in all) of the exchange."""
    moved = sum(int((r != pipe.L).sum()) for r in pipe._xc_rdst)
    return len(pipe._xc_meta), sum(w for _, w in pipe._xc_meta), moved


def _phase13a(torch, np, args, dev, ref12):
    """13a: the main path's system through 'Use Device Pipeline'."""
    from feddlib_tpu_torch.la import _cuda

    t0 = time.perf_counter()
    n_dev = args.dist_devices
    params = {"Use Distributed Solve": True, "Use Device Pipeline": True,
              "Devices": n_dev, "Preconditioner Type": "SchwarzTwoLevel",
              "Convergence Tolerance": 1e-8}
    prob = _default_laplace(torch, args.n_dist, params, dev)
    A_sp = prob.bc_system().get_block(0, 0).to_scipy()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t1 = time.perf_counter()
    iters, reg = _measured(prob.solve)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    x = prob.solution[0].clone()
    u = x.cpu().numpy()
    rel = _host_relres(np, A_sp, prob.rhs[0], x)
    pc, pp = prob._pipe_cache, prob._pipe_prec
    pipe, solver = pc["pipe"], pp["solver"]
    dmat = solver.dmat
    build, arrs = pp["precond"]
    _check(x.device.type == "cuda" and dmat.ell_data.device.type == "cuda"
           and pipe.seg_ids.device.type == "cuda", "pipeline on the card")
    print(f"pipeline setup s: {reg.parts('pipe.partition')} "
          f"finalize={reg.s('pipe.finalize'):.3f} ("
          + reg.parts(*PIPE_PARTS)
          + f") precond={reg.s('dist.precond'):.3f} ("
          + reg.parts("prec.overlap", "prec.overlap_plan", "prec.blocks",
                      "prec.factor", "prec.gdsw", "prec.phi",
                      "prec.coarse_solver") + ")", flush=True)
    nr, pp_w, moved = _rounds(pipe)
    print(f"pipeline shapes: n_dofs={A_sp.shape[0]} shards={n_dev} L="
          f"{pipe.L} S={pipe.S} K={pipe.K} N_o={pipe.N_o} E_max="
          f"{pipe.E_max} contributions_per_shard={pipe.seg_ids.shape[1]} "
          f"exchange {nr} rounds / {pp_w} ppermute elems a shard / {moved} "
          f"elems moved in all; pipeline_bytes={_pipe_bytes(torch, pipe)} "
          f"prec_bytes={_stacked_bytes(torch, arrs)} "
          f"allocated_after_solve={torch.cuda.memory_allocated() - m0} "
          f"peak_in_first_solve={torch.cuda.max_memory_allocated() - m0}",
          flush=True)
    setup_s = reg.s("pipe.partition", "pipe.finalize", "dist.precond")
    print(f"pipeline solve: gmres_iters={iters} relres={prob.last_relres:.3e}"
          f" host_f64_relres={rel:.3e} first_solve_s={t_first:.3f} (setup "
          f"{setup_s:.3f} inside) hopper_launches="
          f"{dict(_cuda.launch_counts)}", flush=True)
    _check(rel <= 1e-8, f"pipeline host residual {rel} > 1e-8")
    if ref12 is not None and (args.n_dist, n_dev) == (ref12["n"],
                                                      ref12["parts"]):
        dx = float(np.abs(u - ref12["x"]).max())
        D = _collect_csr(np, dmat)
        da = float(abs(D - ref12["A"]).max())
        amax = float(abs(ref12["A"]).max())
        print(f"pipeline vs phase 12a: iters {iters} vs {ref12['iters']}, "
              f"max|dx|={dx:.3e} max|x|={np.abs(u).max():.3e}, matrix "
              f"max|dA|={da:.3e} max|A|={amax:.3e}", flush=True)
        _check(abs(iters - ref12["iters"]) <= 1,
               f"pipeline {iters} vs split {ref12['iters']} iterations")
        _check(dx <= 1e-6 * float(np.abs(u).max()),
               "pipeline solution against phase 12a's")
        _check(da <= 1e-12 * amax, "pipeline matrix against phase 12a's")
        del D
    else:
        print("pipeline vs phase 12a: comparison skipped (phase 12 not run "
              "or its flags differ)", flush=True)

    # two assemblies bitwise equal; the second solve reuses everything
    a1 = pipe.assemble().ell_data
    a2 = pipe.assemble().ell_data
    _check(torch.equal(a1, a2), "two pipeline assemblies bitwise equal")
    del a1, a2
    t2 = time.perf_counter()
    iters2 = prob.solve()
    torch.cuda.synchronize()
    t_second = time.perf_counter() - t2
    _check(prob._pipe_cache is pc and prob._pipe_prec is pp
           and iters2 == iters and torch.equal(prob.solution[0], x),
           "second pipeline solve: cached and bitwise equal")
    # one assembly: device and wall ms, launches
    asm_ms = _device_ms(torch, lambda: pipe.assemble(), samples=10, calls=3)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(10):
        pipe.assemble()
    torch.cuda.synchronize()
    asm_wall = (time.perf_counter() - tw) * 100.0
    la = _launches(torch, dev, lambda: pipe.assemble())[0]
    ref_s = ("" if ref12 is None else
             f"; phase 12a host assembly {ref12['asm_s']:.3f} s + "
             f"DistributedCsr {ref12['dmat_s']:.3f} s")
    print(f"pipeline assembly: {asm_ms:.5f} ms (device) {asm_wall:.5f} ms "
          f"(wall) launches={la}{ref_s}; second solve {t_second:.3f} s "
          f"(assembly + Dirichlet + GMRES, cached), bitwise equal",
          flush=True)
    # phase 14a's reference: this solve and the values of its matrix
    ref13 = {"n": args.n_dist, "parts": n_dev, "iters": iters, "x": u,
             "ell": dmat.ell_host().copy(), "asm_ms": asm_ms,
             "asm_wall_ms": asm_wall, "setup_s": setup_s}
    del prob, pc, pp, pipe, solver, dmat, build, arrs, A_sp
    gc.collect()
    torch.cuda.empty_cache()
    _phase("13a pipeline main path", t0)
    return ref13


def _phase13b(torch, np, args, dev):
    """13b: Newton Navier–Stokes through the pipeline against the split
    shards."""
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.pipeline import merged_dof_map
    from feddlib_tpu_torch.precond.schwarz import grow_overlap
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    t0 = time.perf_counter()
    n, n_dev = args.n_pipe_ns, args.pipe_ns_devices
    # the host estimate of level 1 before the card holds any of it
    prob = _cavity(torch, n, {}, dev)
    A_sp = prob.bc_system().merge().to_scipy()
    dom_u, dom_p = prob.variables[0][0], prob.variables[1][0]
    dm, _ = merged_dof_map(MeshPartition(dom_p.mesh, n_dev),
                           [(dom_u, 3), (dom_p, 1)])
    S_est = max(len(grow_overlap(A_sp, ix, 1)) for ix in dm.partition_indices)
    est = n_dev * S_est * S_est * 8
    print(f"pipeline cavity: n={n} n_dofs={A_sp.shape[0]} shards={n_dev} "
          f"level-1 estimate [{n_dev}, {S_est}, {S_est}] f64 = {est} bytes "
          f"(host)", flush=True)
    _check(est <= 40e9, "cavity level 1 within 40 GB (lower --n-pipe-ns)")
    del prob, A_sp, dm
    out = {}
    for pipe_on in (False, True):
        prob = _cavity(torch, n, {
            "Use Distributed Solve": True, "Devices": n_dev,
            "Use Device Pipeline": pipe_on,
            "Preconditioner Type": "SchwarzTwoLevel",
            "Convergence Tolerance": 1e-8, "Maximum Iterations": 2000}, dev)
        solver = NonLinearSolver("Newton")
        t1 = time.perf_counter()
        its = solver.solve(prob)
        torch.cuda.synchronize()
        out[pipe_on] = (its, list(solver.linear_iters),
                        prob.solution.concat().cpu().numpy(),
                        time.perf_counter() - t1, prob.last_relres)
        if pipe_on:
            pipe = prob._pipe_cache["pipe"]
            nd = pipe.n_distributes
            pshape = (pipe.L, pipe.S, pipe.K, pipe.N_o, _rounds(pipe))
        del prob, solver
        gc.collect()
        torch.cuda.empty_cache()
    (its0, lin0, x0, s0, r0), (its1, lin1, x1, s1, r1) = out[False], out[True]
    drel = float(np.abs(x1 - x0).max() / np.abs(x0).max())
    print(f"pipeline cavity Newton: split {its0} steps, GMRES {lin0}, "
          f"{s0:.3f} s, last relres {r0:.3e}; pipeline {its1} steps, GMRES "
          f"{lin1}, {s1:.3f} s, last relres {r1:.3e}; max|dx|/max|x|="
          f"{drel:.3e}; n_distributes={nd}; L S K N_o (rounds, W, moved) "
          f"{pshape}", flush=True)
    _check(its1 == its0 and lin1 == lin0, "cavity counts: pipeline = split")
    _check(drel <= 1e-8, "cavity solutions: pipeline = split")
    _check(nd == 1 + its1, "one solution upload in the Newton loop")
    _phase("13b pipeline cavity Newton", t0)


def _fsi_dist_run(torch, np, n, params, dev, gi):
    """Two GE steps (or one GI step) of the 2D two-box FSI: (Newton
    count a step, GMRES a solve, solution, seconds, problem, the
    _Registry of the loop)."""
    per_step = []
    prob = _fsi_two_box(torch, 2, n, dict(
        {"Convergence Tolerance": 1e-10, "relNonLinTol": 1e-9,
         "Maximum Iterations": 4000}, **params), dev)
    t1 = time.perf_counter()

    def obs(t, s):  # the step's Newton solver: its GMRES count a solve
        per_step.append(list(prob.nonlinear_solver.linear_iters))

    with _Registry() as reg:
        if gi:
            prob.advance_gi(t_end=0.02, observer=obs)
        else:
            prob.advance(t_end=0.04, observer=obs)
    _sync(torch, torch.device(dev))
    secs = time.perf_counter() - t1
    return ([len(g) for g in per_step], [i for g in per_step for i in g],
            [b.cpu().numpy() for b in prob.solution.blocks], secs, prob,
            reg)


def _fsi_compare(np, name, ser, dist):
    worst = 0.0
    for a, b in zip(dist[2], ser[2]):
        worst = max(worst, float((np.abs(a - b) / (1e-9 + 1e-6 * np.abs(b)))
                                 .max()))
    print(f"{name}: serial Newton {ser[0]} GMRES {ser[1]} {ser[3]:.3f} s; "
          f"distributed Newton {dist[0]} GMRES {dist[1]} {dist[3]:.3f} s; "
          f"max |dx| / (1e-9 + 1e-6 |x|) = {worst:.3e}", flush=True)
    _check(dist[0] == ser[0], f"{name}: Newton counts")
    _check(worst <= 1.0, f"{name}: trajectory within rtol 1e-6, atol 1e-9")


def _phase13cd(torch, np, args, dev):
    """13c: the 2D GE loop with distributed FaCSI; 13d: the 2D GI step
    distributed — each against the serial loop.  Returns the distributed
    runs' (Newton counts, GMRES counts, solution blocks) under "ge" and
    "gi", phase 15a's reference."""
    t0 = time.perf_counter()
    dist = {"Use Distributed Solve": True, "Devices": args.pipe_fsi_devices,
            "Solid Devices": args.pipe_fsi_solid}
    ser = _fsi_dist_run(torch, np, args.n_pipe_fsi, {
        "Preconditioner Type": "FaCSI",
        "Subdomains": args.pipe_fsi_devices}, dev, gi=False)[:4]
    d = _fsi_dist_run(torch, np, args.n_pipe_fsi, dist, dev, gi=False)
    prob, reg = d[4], d[5]
    cache = prob._pipe_ge
    pipe = cache["pipe"]
    build = cache["prec"][0]
    sizes = prob.block_sizes()
    r = torch.randn(pipe.n_dev, pipe.N_o, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    M = cache["solver"].operators(cache["prec"])[1]
    apply_ms = _device_ms(torch, lambda: M(r), samples=5, calls=5)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(10):
        M(r)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - tw) * 100.0
    print(f"fsi distributed GE: n={args.n_pipe_fsi} n_dofs={sum(sizes)} "
          f"shards={pipe.n_dev} (solid {args.pipe_fsi_solid}) pipeline "
          f"L={pipe.L} S={pipe.S} K={pipe.K} N_o={pipe.N_o} rounds "
          f"{_rounds(pipe)}; pipeline {reg.s('fsi.pipeline'):.3f} s, built "
          f"{cache['builds']} time(s); FaCSI build "
          + reg.parts("facsi.solid", "facsi.fluid", "facsi.interface")
          + f" S {build.shape['S']}, set-up and refreshes s "
          f"{[round(v, 3) for v in reg.each('facsi.setup')]}"
          f"; apply {apply_ms:.3f} ms (device) {wall_ms:.3f} ms (wall); "
          f"n_distributes={pipe.n_distributes} "
          f"({pipe.n_distributes / sum(d[0]):.2f} a Newton step)",
          flush=True)
    _check(cache["builds"] == 1, "one pipeline and FaCSI build for 2 steps")
    _fsi_compare(np, "fsi distributed GE vs serial FaCSI", ser, d[:4])
    ref = {"ge": d[:3]}
    del d, prob, cache, pipe, build, M, r, reg
    gc.collect()
    torch.cuda.empty_cache()
    _phase("13c fsi distributed GE", t0)

    t1 = time.perf_counter()
    gi_dist = {"Use Distributed Solve": True, "Devices": args.pipe_gi_devices,
               "Solid Devices": args.pipe_gi_solid}
    ser = _fsi_dist_run(torch, np, args.n_fsi_gi, {
        "Preconditioner Type": "SchwarzOneLevel",
        "Subdomains": args.pipe_gi_devices}, dev, gi=True)[:4]
    d = _fsi_dist_run(torch, np, args.n_fsi_gi, gi_dist, dev, gi=True)
    cache = d[4]._pipe_gi
    pipe = cache["pipe"]
    # one GI assembly (the shape blocks' jacfwd in _AD_CHUNK chunks):
    # device ms and the peak bytes above what was allocated
    ext = {"w": pipe.distribute_field(0, d[4].solution[0] * 0.0),
           "gp": cache["gp_ext"], "uold": cache["uold_ext"]}
    x = pipe.distribute(d[4].solution.concat())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gi_ms = _device_ms(torch, lambda: pipe.assemble(x=x, ext_fields=ext),
                       samples=5, calls=2)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"fsi distributed GI: n={args.n_fsi_gi} n_dofs="
          f"{sum(d[4].block_sizes())} shards={pipe.n_dev} pipeline L="
          f"{pipe.L} S={pipe.S} K={pipe.K} N_o={pipe.N_o} E_max={pipe.E_max}"
          f" (the shape blocks differentiated in the assembly); pipeline "
          f"{d[5].s('fsi.pipeline'):.3f} s; one assembly {gi_ms:.3f} ms "
          f"(device) peak_bytes={peak}", flush=True)
    del ext, x, cache
    _fsi_compare(np, "fsi distributed GI vs serial", ser, d[:4])
    ref["gi"] = d[:3]
    del d, ser, pipe
    gc.collect()
    torch.cuda.empty_cache()
    _phase("13d fsi distributed GI", t1)
    return ref


def _heat_loop(torch, np, device):
    """The device-RHS implicit-Euler heat loop of tests/test_pipeline.py:
    492 on Domain.structured(2, 8), 4 shards: (CG counts, u)."""
    import math

    from feddlib_tpu_torch.bc import BCBuilder
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline
    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.parallel.spmd import DistributedCsr

    dt = 0.05
    dom = Domain.structured(2, 8, device=device)
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    dmask = np.asarray(bcb.dirichlet_mask(0, dom.n_nodes))
    part = MeshPartition(dom.mesh, 4)
    pipe = DistributedPipeline(part, [(dom, 1)], device=device)
    pipe.add_block(0, 0, "laplace")
    pipe.add_block(0, 0, "mass", coeff=1.0 / dt)
    pipe.add_rhs(0, lambda x, t: torch.sin(2.0 * x[0])
                 * math.cos(1.0 + 3.0 * t))
    pipe.finalize()
    dmat, _ = pipe.apply_dirichlet(pipe.assemble(), None, dmask)
    solver = DistributedSolver(dmat, pipe.axis)
    pm = DistributedPipeline(part, [(dom, 1)], device=device)
    pm.add_block(0, 0, "mass", coeff=1.0 / dt)
    pm.finalize(pipe.axis)
    dM = pm.assemble()
    imp = dM.plan.importer()
    m_dist, _ = pipe.dirichlet_arrays(dmask)
    u = torch.zeros(pipe.axis.n_local, pipe.N_o, dtype=torch.float64,
                    device=pipe.device)
    iters = []
    for k in range(3):
        b = pipe.assemble_rhs_device((k + 1) * dt) + DistributedCsr.\
            local_matvec(dM.ell_data, dM.ell_cols,
                         imp(u, dM.plan.import_arrays))
        u, it, _ = solver.solve(torch.where(m_dist > 0, 0.0, b),
                                method="cg", tol=1e-12, maxiter=2000)
        iters.append(it)
    return iters, pipe.collect(u)


def _pipe_cases(torch, np):
    """The small pipeline scenarios of the CPU tests: [(name, fn(device) →
    (counts, x))] (phases 13e and 14b)."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.nonlin_elasticity import \
        NonLinElasticity
    from feddlib_tpu_torch.problems.tpm import TPM
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver
    from feddlib_tpu_torch.utils import timers
    from feddlib_tpu_torch.utils.config import ParameterList

    pipe_opts = {"Use Distributed Solve": True, "Devices": 4,
                 "Use Device Pipeline": True}

    def laplace(d):
        pr = _laplace2d(torch, 16, dict(pipe_opts, **{
            "Preconditioner Type": "SchwarzTwoLevel",
            "Convergence Tolerance": 1e-9}), d)
        return [pr.solve()], pr.solution[0].cpu().numpy()

    def tpm(d):
        dom_p1 = Domain.structured(2, 4, device=d)
        pr = TPM(dom_p1.p2_domain(), dom_p1, parameter_list=ParameterList(
            "P", dict(pipe_opts, **{
                "dt": 0.05, "Preconditioner Type": "SchwarzOneLevel",
                "Convergence Tolerance": 1e-10,
                "Maximum Iterations": 3000})), device=d)
        pr.assemble()
        pr.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        pr.add_bc(lambda x, t: 0.0, 3, 1)
        pr.assemble_source(lambda x: [0.0, -1.0])
        # each step's Krylov iterations: the registry's counter between
        # two calls of the observer
        its, seen = [], [timers.counters().get("krylov.iterations", 0)]

        def step_its(t, sol):
            now = timers.counters().get("krylov.iterations", 0)
            its.append(now - seen[0])
            seen[0] = now

        pr.advance(t_end=0.1, f_ext=pr.rhs.copy(), observer=step_its)
        return its, pr.solution.concat().cpu().numpy()

    def hyper(d):
        pr = NonLinElasticity(Domain.structured(2, 4, device=d),
                              parameter_list=ParameterList("P", dict(
                                  pipe_opts, **{
                                      "E": 5.0, "Poisson Ratio": 0.3,
                                      "Material Model": "Neo-Hooke",
                                      "Preconditioner Type":
                                          "SchwarzOneLevel",
                                      "Convergence Tolerance": 1e-11,
                                      "Maximum Iterations": 3000,
                                      "relNonLinTol": 1e-9,
                                      "MaxNonLinIts": 15})), device=d)
        pr.assemble()
        pr.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        pr.assemble_source(lambda x: [0.0, -0.4])
        s = NonLinearSolver("Newton")
        its = s.solve(pr)
        return [its] + list(s.linear_iters), pr.solution[0].cpu().numpy()

    return [("Laplace 2D 16 cells, 4 shards", laplace),
            ("device-RHS heat loop", lambda d: _heat_loop(torch, np, d)),
            ("TPM consolidation", tpm), ("hyperelastic Newton", hyper)]


def _dist_cases(torch):
    """The small distributed-solve scenarios of phase 12b: [(name,
    fn(device) → (counts, x))] (phases 12b and 14b)."""
    def laplace(p):
        def run(d):
            pr = _laplace2d(torch, 16, dict(
                p, **{"Use Distributed Solve": True, "Devices": 8}), d)
            return [pr.solve()], pr.solution[0].cpu().numpy()
        return run

    def stokes(d):
        pr = _stokes2d(torch, 8, {"Use Distributed Solve": True,
                                  "Devices": 4}, d)
        return [pr.solve()], pr.solution.concat().cpu().numpy()

    return [("Jacobi", laplace({"Preconditioner Type": "Jacobi"})),
            ("SchwarzOneLevel", laplace({
                "Preconditioner Type": "SchwarzOneLevel", "Overlap": 2,
                "Combine Values in Overlap": "Averaging"})),
            ("SchwarzTwoLevel", laplace({
                "Preconditioner Type": "SchwarzTwoLevel"})),
            ("Stokes P2/P1 block GDSW", stokes)]


def _phase13e(torch, np, dev):
    """13e: the small pipeline scenarios of the CPU tests on the card
    against the same runs on the CPU."""
    t0 = time.perf_counter()
    for name, fn in _pipe_cases(torch, np):
        (it_c, x_c), (it_h, x_h) = fn(dev), fn(torch.device("cpu"))
        dx = float(np.abs(x_c - x_h).max())
        print(f"pipeline {name} cuda vs cpu: counts {it_c} vs {it_h}, "
              f"max|dx|={dx:.3e} max|x|={np.abs(x_h).max():.3e}", flush=True)
        _check(list(it_c) == list(it_h)
               and dx <= 1e-9 * float(np.abs(x_h).max()),
               f"pipeline {name} cuda vs cpu")
    _phase("13e pipeline card vs cpu", t0)


def _phase13(torch, np, args, dev, ref12):
    """The device-resident pipeline (see the module docstring)."""
    t0 = time.perf_counter()
    ref13 = _phase13a(torch, np, args, dev, ref12)
    _phase13b(torch, np, args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    ref13["fsi"] = _phase13cd(torch, np, args, dev)
    _phase13e(torch, np, dev)
    _phase("13 pipeline", t0)
    return ref13


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _wall_ms(torch, dev, fn, calls=10):
    fn()
    _sync(torch, dev)
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    _sync(torch, dev)
    return (time.perf_counter() - t) / calls * 1e3


def _xfer(reg):
    """A rank's cross-rank traffic in `reg` (parallel/spmd.py): the
    counters `axis.xfer_bytes` (sent) and `axis.xfer_calls`, and the
    seconds of the `axis.xfer` spans (host clock)."""
    return {"bytes": reg.counts.get("axis.xfer_bytes", 0),
            "calls": reg.counts.get("axis.xfer_calls", 0),
            "seconds": reg.s("axis.xfer")}


def _setup(tm):
    """A pipeline solve's set-up seconds: partition, finalize, the
    preconditioner."""
    return tm["pipe.partition"] + tm["pipe.finalize"] + tm["dist.precond"]


def _phase14a_rank(n, n_dev, device_type="cuda"):
    """One rank of phase 14a: phase 13a's solve through Problem.solve on
    this rank's shards (the axis of multihost.global_device_axis).
    `device_type` "cpu" rehearses it without a card."""
    import numpy as np  # noqa: F401
    import torch

    from feddlib_tpu_torch.parallel import multihost

    torch.set_num_threads(4)
    dev = multihost.local_device(device_type)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    params = {"Use Distributed Solve": True, "Use Device Pipeline": True,
              "Devices": n_dev, "Preconditioner Type": "SchwarzTwoLevel",
              "Convergence Tolerance": 1e-8}
    t0 = time.perf_counter()
    prob = _default_laplace(torch, n, params, dev)
    _sync(torch, dev)
    t_asm = time.perf_counter() - t0
    if on_card:
        m0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    iters, reg = _measured(prob.solve)
    _sync(torch, dev)
    t_solve = time.perf_counter() - t1
    pc, pp = prob._pipe_cache, prob._pipe_prec
    pipe, solver = pc["pipe"], pp["solver"]
    axis = pipe.axis
    x_solve = _xfer(reg)
    tm = {n: reg.s(n) for n in ("pipe.partition", "pipe.finalize")
          + PIPE_PARTS + ("dist.precond", "prec.level1", "prec.gdsw",
                          "prec.phi", "prec.coarse_solver")}
    x = prob.solution[0].cpu().numpy()
    dmat = solver.dmat
    ell = dmat.ell_host()  # gathered once during the setup
    _check(dmat.ell_data.device == dev == pipe.seg_ids.device
           and dmat.ell_data.shape[0] == axis.n_local, "the rank's shards "
           "on its device")
    # one A, one M(A(x)) and one assembly: wall ms, launches, busy ms,
    # cross-rank bytes and seconds of each
    A_fn, M_fn = solver.operators(pp["precond"])
    g = torch.Generator(device=dev).manual_seed(axis.rank)
    xs = torch.randn(axis.n_local, dmat.plan.N_o, dtype=torch.float64,
                     device=dev, generator=g) * dmat.plan.owned_mask
    out = {}
    for key, fn in (("A", lambda: A_fn(xs)),
                    ("M(A(x))", lambda: M_fn(A_fn(xs))),
                    ("assembly", lambda: pipe.assemble())):
        wall = _wall_ms(torch, dev, fn)
        one = _xfer(_measured(fn)[1])
        _sync(torch, dev)
        la, busy = (_launches(torch, dev, fn) if on_card
                    else (None, None))
        out[key] = {"wall_ms": wall, "launches": la, "busy_ms": busy,
                    "xfer_bytes": one["bytes"], "xfer_s": one["seconds"],
                    "xfer_calls": one["calls"]}
    res = {"rank": axis.rank, "lo": axis.lo, "hi": axis.hi,
           "backend": axis.backend, "iters": iters,
           "relres": prob.last_relres, "assemble_s": t_asm,
           "first_solve_s": t_solve, "setup": tm, "xfer_solve": x_solve,
           "applies": out, "n_local": axis.n_local, "N_o": dmat.plan.N_o,
           "allocated": (torch.cuda.memory_allocated() - m0 if on_card
                         else None),
           "peak": (torch.cuda.max_memory_allocated() - m0 if on_card
                    else None)}
    print(f"rank {axis.rank} shards [{axis.lo}, {axis.hi}) on {dev} "
          f"({axis.backend}): gmres_iters={iters} relres="
          f"{prob.last_relres:.3e} assemble_s={t_asm:.3f} first_solve_s="
          f"{t_solve:.3f}; setup s " + " ".join(
              f"{k}={v:.3f}" for k, v in tm.items())
          + f"; cross-rank in the first solve {x_solve}", flush=True)
    if axis.rank == 0:
        res.update(x=x, ell=ell)
    return res


def _phase14a(torch, np, args, dev, ref13):
    """14a: phase 13a's system on two ranks of the gloo backend, both on
    the one card."""
    from feddlib_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    n, n_dev = args.n_dist, args.dist_devices
    ranks = multihost.launch(_phase14a_rank, 2, args=(n, n_dev, dev.type),
                             backend="gloo", timeout=args.rank_timeout,
                             env={"OPENBLAS_NUM_THREADS": "1"}, echo=True)
    for r in ranks:
        print(f"two ranks: rank {r['rank']} [{r['lo']}, {r['hi']}) "
              f"n_local={r['n_local']} N_o={r['N_o']} gmres={r['iters']} "
              f"relres={r['relres']:.3e} allocated={r['allocated']} "
              f"peak={r['peak']}", flush=True)
        for k, v in r["applies"].items():
            busy = ("None" if v["busy_ms"] is None
                    else f"{v['busy_ms']:.5f}")
            print(f"two ranks: rank {r['rank']} {k}: wall_ms="
                  f"{v['wall_ms']:.5f} busy_ms={busy} (kernels and "
                  f"copies) launches={v['launches']} cross_rank_bytes="
                  f"{v['xfer_bytes']} cross_rank_s={v['xfer_s']:.6f} "
                  f"collectives={v['xfer_calls']}", flush=True)
    r0 = ranks[0]
    _check(all(r["iters"] == r0["iters"] for r in ranks)
           and r0["relres"] <= 1e-8, "two ranks: converged alike")
    if ref13 is None or (ref13["n"], ref13["parts"]) != (n, n_dev):
        print("two ranks vs phase 13a: comparison skipped (phase 13a not "
              "run or its flags differ)", flush=True)
    else:
        dx = float(np.abs(r0["x"] - ref13["x"]).max()
                   / np.abs(ref13["x"]).max())
        same = bool(np.array_equal(r0["ell"], ref13["ell"]))
        print(f"two ranks vs phase 13a: gmres {r0['iters']} vs "
              f"{ref13['iters']}, max|dx|/max|x|={dx:.3e}, matrix bitwise "
              f"equal={same}; setup "
              f"{max(_setup(r['setup']) for r in ranks):.3f} s "
              f"vs 13a's {ref13['setup_s']:.3f}; assembly wall "
              f"{max(r['applies']['assembly']['wall_ms'] for r in ranks):.5f}"
              f" ms vs 13a's {ref13['asm_wall_ms']:.5f}", flush=True)
        _check(r0["iters"] == ref13["iters"], "two ranks: 13a's count")
        _check(dx <= 1e-12, "two ranks: x within 1e-12 of 13a's")
        _check(same, "two ranks: the matrix bitwise 13a's")
    _phase("14a two ranks on one card (gloo)", t0)


def _phase14b_rank(device_type="cuda"):
    """Phase 14b's rank: the small cases of 12b and 13e."""
    import numpy as np
    import torch

    from feddlib_tpu_torch.parallel import multihost

    dev = multihost.local_device(device_type)
    axis = multihost.global_device_axis(4, dev)
    _check(axis.group is not None and axis.world == 1,
           "14b runs inside a process group of one rank")
    print(f"one rank of {axis.backend} on {dev}", flush=True)
    return [(name, fn(dev)) for name, fn in
            _dist_cases(torch) + _pipe_cases(torch, np)]


def _nccl_probe_rank():
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def _phase14b(torch, np, args, dev):
    """14b: one rank over NCCL, bitwise the stacked runs; what NCCL says
    to two ranks on one card."""
    from feddlib_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    # NCCL on the card; gloo where a CPU rehearses the phase
    backend = "nccl" if dev.type == "cuda" else "gloo"
    (got,) = multihost.launch(_phase14b_rank, 1, args=(dev.type,),
                              backend=backend, timeout=args.rank_timeout,
                              echo=True)
    ref = [(name, fn(dev)) for name, fn in
           _dist_cases(torch) + _pipe_cases(torch, np)]
    for (name, (it_r, x_r)), (_, (it_s, x_s)) in zip(got, ref):
        same = list(it_r) == list(it_s) and np.array_equal(x_r, x_s)
        print(f"one {backend} rank vs stacked, {name}: counts {list(it_r)} "
              f"vs {list(it_s)}, bitwise equal={same}", flush=True)
        _check(same, f"one {backend} rank bitwise the stacked run: {name}")
    if dev.type != "cuda":
        _phase("14b one rank", t0)
        return
    t1 = time.perf_counter()
    try:
        val = multihost.launch(_nccl_probe_rank, 2, backend="nccl",
                               timeout=90)
        print(f"NCCL with two ranks on one card: all_reduce ran, {val}",
              flush=True)
    except RuntimeError as e:
        said = [ln.strip() for ln in str(e).splitlines()
                if "NCCL" in ln or "nccl" in ln or "Error" in ln]
        print("NCCL with two ranks on one card refused it: "
              + " | ".join(said[-6:]), flush=True)
    print(f"NCCL probe {time.perf_counter() - t1:.3f} s (diagnostic; no "
          f"path runs two NCCL ranks on one card)", flush=True)
    _phase("14b one NCCL rank", t0)


# the eight symmetries of the unit square, on [n, 2] points
_SQUARE_MAPS = (lambda p: p, lambda p: p[:, ::-1], lambda p: 1 - p,
                lambda p: (1 - p)[:, ::-1],
                lambda p: p * [-1, 1] + [1, 0], lambda p: p * [1, -1] + [0, 1],
                lambda p: p[:, ::-1] * [-1, 1] + [1, 0],
                lambda p: p[:, ::-1] * [1, -1] + [0, 1])


def _geometry_key(np, points, elements):
    """A hash of a mesh's geometry, blind to the numbering of its points
    and elements (refine_distributed_2d numbers them otherwise than
    refine_mesh_2d): each point by the rank of its coordinates, each
    element by its sorted point ranks, the elements sorted."""
    import hashlib

    uniq, rank = np.unique(np.round(points, 12), axis=0, return_inverse=True)
    el = np.sort(rank.reshape(-1)[elements], axis=1)
    el = el[np.lexsort(el.T[::-1])]
    return hashlib.sha1(uniq.tobytes() + el.tobytes()).hexdigest()


def _mesh_key(np, mesh, maps=(_SQUARE_MAPS[0],)):
    """The least `_geometry_key` of the mesh under `maps`: meshes that are
    images of each other under one of them share the key."""
    el = mesh.elements[:, : mesh.dim + 1]
    return min(_geometry_key(np, m(mesh.points), el) for m in maps)


def _phase14c(torch, np, args, dev, hold_b123):
    """14c: adaptive_solve_cycles on the card, three modes."""
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh
    from feddlib_tpu_torch.solvers.refinement import adaptive_solve_cycles
    from feddlib_tpu_torch.utils.config import ParameterList

    t0 = time.perf_counter()

    def f_t(x):
        return torch.exp(-100 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    def f_np(x):
        return float(np.exp(-100 * ((x[0] - .5) ** 2 + (x[1] - .5) ** 2)))

    base = {"Convergence Tolerance": args.amr_tol}
    dist = {"Use Distributed Solve": True, "Use Device Pipeline": True,
            "Devices": args.amr_devices}
    modes = [("mixed", {"Use Mixed Precision": True, "TwoLevel": True,
                        "Clusters": args.amr_clusters}),
             ("dist", dist), ("dist_amr", dict(dist, **{
                 "Use Distributed AMR": True}))]
    hist, kept = {}, {}
    keys = ("permute_gather", "sell_spmv", "dense_gemv_f32")
    # the problem's symmetries: the square's that map the first mesh onto
    # itself (the source is radial about the centre); a tied group of
    # indicators can split into either of two mirror-image meshes
    mesh0 = build_structured_mesh(2, args.n_amr)
    k0 = _mesh_key(np, mesh0)
    maps = [m for m in _SQUARE_MAPS
            if _mesh_key(np, mesh0, (m,)) == k0]
    for mode, opts in modes:
        per, reg, mark = [], _Registry(), [0]

        def cb(c, prob, rec, mode=mode, per=per, reg=reg, mark=mark):
            counts = dict(_cuda.launch_counts)
            shape = ""
            if mode == "mixed":
                ca = prob._mixed_cache
                db = ca["db32"]
                shape = (f" B3 [{db.P}, {db.R}, {db.R + db.G}] B2 "
                         f"{ca['sell'].Ac.vals.shape[0]} chunks B1 "
                         f"{db.ghost_plan[0].numel()} outputs")
                kept[mode] = (ca, counts)
            else:  # the cycle's plan rebuilds and set-up
                pp = prob._pipe_prec
                parts = [f"{n} {reg.s(n, lo=mark[0]):.3f}" for n in (
                    "pipe.partition", "pipe.finalize", "dist.precond")]
                shape = (f" (solve: {', '.join(parts)}, level-1 width "
                         f"{pp['precond'][0].shape['S']})")
            mark[0] = time.perf_counter_ns()
            launches = {k: counts.get(k, 0) for k in keys}
            launches["mesh"] = _mesh_key(np, prob.domains[0].mesh, maps)
            per.append(launches)
            print(f"AMR {mode} cycle {c}: n_elements={rec['n_elements']} "
                  f"dofs={rec['n_dofs']} eta={rec['eta']:.12e} gmres="
                  f"{rec['iters']} s " + " ".join(
                      f"{k}={v:.3f}" for k, v in rec["seconds"].items())
                  + f" mesh {launches['mesh'][:12]} hopper_launches="
                  + str({k: launches[k] for k in keys}) + shape, flush=True)
            _cuda.reset_launch_counts()

        _cuda.reset_launch_counts()
        t1 = time.perf_counter()
        with reg:
            h = adaptive_solve_cycles(
                build_structured_mesh(2, args.n_amr), f_t,
                cycles=args.amr_cycles, theta=0.6,
                params=ParameterList("P", dict(base, **opts)),
                source_np=f_np, device=dev, callback=cb)
        _sync(torch, dev)
        hist[mode] = (h, per, time.perf_counter() - t1)
        print(f"AMR {mode}: {hist[mode][2]:.3f} s for {args.amr_cycles} "
              f"cycles", flush=True)
    # the mixed mode launched B1–B3 in every cycle
    for c, launches in enumerate(hist["mixed"][1]):
        _check(all(launches[k] > 0 for k in keys),
               f"AMR mixed cycle {c} launched B1-B3: {launches}")
    n_el = {m: [r["n_elements"] for r in hist[m][0]] for m in hist}
    eta = {m: np.array([r["eta"] for r in hist[m][0]]) for m in hist}
    key = {m: [p["mesh"] for p in hist[m][1]] for m in hist}
    for m in ("dist_amr", "mixed"):
        same = [a == b for a, b in zip(key[m], key["dist"])]
        print(f"AMR {m} vs dist per cycle: n_elements {n_el[m]} vs "
              f"{n_el['dist']}, the same mesh up to the {len(maps)} "
              f"symmetries {same}, eta rel diff "
              f"{(np.abs(eta[m] - eta['dist']) / eta['dist']).tolist()}",
              flush=True)
    _check(key["dist_amr"] == key["dist"]
           and np.allclose(eta["dist_amr"], eta["dist"], rtol=1e-8, atol=0),
           "AMR: distributed AMR = distributed refinement, every cycle")
    # the mixed mode: on every mesh it shares with the distributed run, up
    # to the problem's symmetries, eta within 1e-8 (up to the first cycle
    # whose mesh differs: the Dörfler cut can fall inside a group of
    # exactly tied indicators, which the last bits of u may split into
    # meshes that are not images of each other)
    _check(key["mixed"][0] == key["dist"][0],
           "AMR: the mixed and distributed runs start on one mesh")
    shared = next((c for c, (a, b) in enumerate(zip(key["mixed"],
                                                    key["dist"]))
                   if a != b), len(key["dist"]))
    print(f"AMR mixed vs dist: the first {shared} of {len(key['dist'])} "
          f"meshes shared", flush=True)
    _check(np.allclose(eta["mixed"][:shared], eta["dist"][:shared],
                       rtol=1e-8, atol=0),
           "AMR: mixed eta within 1e-8 of the distributed run's on every "
           "shared mesh")
    if hold_b123 is not None and "mixed" in kept:
        ca, counts = kept["mixed"]
        hold_b123(" (AMR last cycle)", ca["db32"], ca["sell"], ca["prec"],
                  {k: sum(p[k] for p in hist["mixed"][1]) for k in keys})
    _phase("14c AMR on the card", t0)


def _phase14(torch, np, args, dev, ref13, hold_b123):
    """Shards on several processes and AMR (see the module docstring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _phase14a(torch, np, args, dev, ref13)
    _phase14b(torch, np, args, dev)
    _phase14c(torch, np, args, dev, hold_b123)
    _phase("14 ranks and AMR", t0)


# -- phase 15: the FSI loops on ranks, the drivers, the entry points --------


def _phase15a_rank(runs, device_type="cuda"):
    """One rank of phase 15a: each (mode, n, shards, solid shards) of
    `runs` — 13c's GE loop and 13d's GI step — on this rank's shards, and
    one assembly and one FaCSI apply of each: wall and busy ms, launches,
    cross-rank bytes.  `device_type` "cpu" rehearses it without a card."""
    import numpy as np
    import torch

    from feddlib_tpu_torch.parallel import multihost

    torch.set_num_threads(4)
    dev = multihost.local_device(device_type)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
    out = {}
    for mode, n, n_dev, solid in runs:
        gi = mode == "GI"
        steps, log, sol, secs, prob, reg = _fsi_dist_run(
            torch, np, n, {"Use Distributed Solve": True, "Devices": n_dev,
                           "Solid Devices": solid}, dev, gi=gi)
        cache = prob._pipe_gi if gi else prob._pipe_ge
        pipe = cache["pipe"]
        axis = pipe.axis
        loop_xfer = _xfer(reg)
        facsi_s = reg.each("facsi.setup")
        x = pipe.distribute(prob.solution.concat())
        if gi:
            ext = {"w": pipe.distribute_field(0, prob.solution[0] * 0.0),
                   "gp": cache["gp_ext"], "uold": cache["uold_ext"]}
            vc = {}
        else:
            ext, vc = cache["w_ext"], {0: cache["vc"]}
        M = cache["solver"].operators(cache["prec"])[1]
        g = torch.Generator(device=dev).manual_seed(axis.rank)
        r = torch.randn(axis.n_local, pipe.N_o, dtype=torch.float64,
                        device=dev, generator=g)
        applies = {}
        for key, fn in (("assembly", lambda: pipe.assemble(
                            x=x, ext_fields=ext, vert_coords=vc)),
                        ("FaCSI apply", lambda: M(r))):
            wall = _wall_ms(torch, dev, fn, calls=5)
            one = _xfer(_measured(fn)[1])
            _sync(torch, dev)
            la, busy = (_launches(torch, dev, fn) if on_card
                        else (None, None))
            applies[key] = {"wall_ms": wall, "launches": la,
                            "busy_ms": busy, "xfer_bytes": one["bytes"],
                            "xfer_s": one["seconds"],
                            "xfer_calls": one["calls"]}
        res = {"rank": axis.rank, "lo": axis.lo, "hi": axis.hi,
               "backend": axis.backend, "steps": steps, "log": log,
               "loop_s": secs, "pipeline_s": reg.s("fsi.pipeline"),
               "facsi_s": facsi_s, "loop_xfer": loop_xfer,
               "applies": applies, "n_local": axis.n_local, "N_o": pipe.N_o}
        if axis.rank == 0:
            res["sol"] = sol
        out[mode] = res
        print(f"rank {axis.rank} {mode} shards [{axis.lo}, {axis.hi}) on "
              f"{dev} ({axis.backend}): Newton {steps} GMRES {log} loop "
              f"{secs:.3f} s pipeline {res['pipeline_s']:.3f} s FaCSI "
              f"{[round(v, 3) for v in facsi_s]} s; cross-rank in the loop "
              f"{loop_xfer}", flush=True)
        del prob, cache, pipe, x, ext, vc, M, r, reg
    return out


def _phase15a(torch, np, args, dev, ref):
    """15a: phase 13c's GE loop and 13d's GI step on two gloo ranks of the
    one card, against 13c / 13d (`ref`, None skips the comparison)."""
    from feddlib_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    runs = [("GE", args.n_pipe_fsi, args.pipe_fsi_devices,
             args.pipe_fsi_solid),
            ("GI", args.n_fsi_gi, args.pipe_gi_devices, args.pipe_gi_solid)]
    ranks = multihost.launch(_phase15a_rank, 2, args=(runs, dev.type),
                             backend="gloo", timeout=args.rank_timeout,
                             env={"OPENBLAS_NUM_THREADS": "1"}, echo=True)
    for mode, n, n_dev, solid in runs:
        rr = [r[mode] for r in ranks]
        for r in rr:
            print(f"fsi on two ranks {mode}: rank {r['rank']} [{r['lo']}, "
                  f"{r['hi']}) n_local={r['n_local']} N_o={r['N_o']} "
                  f"setup_s={r['pipeline_s'] + r['facsi_s'][0]:.3f} "
                  f"(pipeline {r['pipeline_s']:.3f} + FaCSI build "
                  f"{r['facsi_s'][0]:.3f}) loop_s={r['loop_s']:.3f} "
                  f"loop_cross_rank_bytes={r['loop_xfer']['bytes']} "
                  f"loop_cross_rank_s={r['loop_xfer']['seconds']:.3f}",
                  flush=True)
            for k, v in r["applies"].items():
                busy = ("None" if v["busy_ms"] is None
                        else f"{v['busy_ms']:.5f}")
                print(f"fsi on two ranks {mode}: rank {r['rank']} {k}: "
                      f"wall_ms={v['wall_ms']:.5f} busy_ms={busy} "
                      f"launches={v['launches']} cross_rank_bytes="
                      f"{v['xfer_bytes']} cross_rank_s={v['xfer_s']:.6f} "
                      f"collectives={v['xfer_calls']}", flush=True)
        _check([(r["lo"], r["hi"]) for r in rr]
               == [(0, n_dev // 2), (n_dev // 2, n_dev)],
               f"fsi on two ranks {mode}: each rank its half of the shards")
        _check(rr[0]["steps"] == rr[1]["steps"]
               and rr[0]["log"] == rr[1]["log"],
               f"fsi on two ranks {mode}: the ranks count alike")
        key = mode.lower()
        if ref is None or key not in ref:
            print(f"fsi on two ranks {mode} vs phase 13: comparison skipped "
                  f"(phase 13c/d not run)", flush=True)
            continue
        steps, log, sol = ref[key]
        worst = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
                    for a, b in zip(rr[0]["sol"], sol))
        print(f"fsi on two ranks {mode} vs phase 13: Newton "
              f"{rr[0]['steps']} vs {steps}, GMRES {rr[0]['log']} vs {log}, "
              f"max over fields of max|dx|/max|x| = {worst:.3e}", flush=True)
        _check(rr[0]["steps"] == steps and rr[0]["log"] == log,
               f"fsi on two ranks {mode}: phase 13's counts")
        _check(worst <= 1e-10, f"fsi on two ranks {mode}: fields within "
               f"1e-10 of phase 13's")
    _phase("15a fsi loops on two ranks (gloo)", t0)


def _after(text, key):
    line = [ln for ln in text.splitlines() if key in ln][0]
    return float(line.split(key)[1].split()[0].rstrip(",;"))


def _phase15b(torch, np, args, dev):
    """15b: every driver's main([...]) in this process on the card, at the
    sizes of tests/test_drivers.py, with its goldens."""
    import contextlib
    import importlib
    import io
    import tempfile

    from feddlib_tpu_torch.scenarios import write_channel_mesh
    from feddlib_tpu_torch.utils import timers

    t0 = time.perf_counter()
    on = [] if dev.type == "cuda" else ["--cpu"]
    tmp = tempfile.mkdtemp(prefix="fedd_drivers_")
    channel = write_channel_mesh(os.path.join(tmp, "channel.mesh"))

    def rel(v, want):
        return abs(v - want) / abs(want)

    def laplace3d(o):
        return abs(_after(o, "GMRES iterations:") - 10) <= 1

    def adaptive(o):
        eta = [_after(ln, "eta=") for ln in o.splitlines()
               if ln.startswith("cycle")]
        return len(eta) == 3 and eta[-1] < eta[0]

    def elasticity(o):
        return (_after(o, "relres:") <= 1e-8
                and _after(o, "tip sag:") < 0)

    def stokes(o):
        return _after(o, "div u| (weak) =") < 1e-6

    def tpm(o):
        line = [ln for ln in o.splitlines() if "consolidation:" in ln][0]
        p0 = float(line.split("max|p|")[1].split("->")[0])
        p1 = float(line.split("->")[1].split(";")[0])
        s = float(line.split("settlement =")[1])
        return (rel(p0, 1.4150e-01) < 1e-3 and rel(p1, 1.2751e-01) < 1e-3
                and rel(s, -1.07034e-02) < 1e-3)

    def geometry(o):
        line = [ln for ln in o.splitlines() if "moved mesh" in ln][0]
        g = float(line.split("max|g| =")[1].split(",")[0])
        return (abs(g - 0.1) < 1e-6 and "all positive: True" in o
                and rel(_after(o, "min |elem vol| ="), 1.159e-02) < 0.01)

    def unsteady_elas(o):
        return rel(_after(o, "final max|d| ="), 3.19400e-04) < 1e-3

    def unsteady_ns(o):
        return (len([ln for ln in o.splitlines()
                     if ln.strip().startswith("t=")]) == 2
                and np.isfinite(_after(o, "final |u|max:")))

    def navier_stokes(o):
        # the JAX driver's counts and forces on this channel (held in
        # tests/test_torch_drivers.py::test_driver_matches_jax)
        return ("Newton its: 6 " in o
                and "GMRES per step: [15, 19, 23, 24, 24, 24]" in o
                and abs(_after(o, "drag=") - 5.7236) <= 1e-4
                and abs(_after(o, "lift=") + 34.5509) <= 1e-4)

    def fsi_box(o):
        return np.isfinite(_after(o, "max |d| ="))

    def fsi_tube(o):
        return (rel(_after(o, "max |d| ="), 1.13975e-03) < 1e-2
                and rel(_after(o, "max |lambda| ="), 2.28796e-01) < 1e-2)

    serial = {}

    def pipeline(o):
        return _after(o, "GMRES iterations:") == serial["laplace"]

    def laplace2d(o):
        serial["laplace"] = _after(o, "GMRES iterations:")
        return True

    cases = [
        ("laplace", ["--dim", "3", "--n", "8", "--subdomains", "8"],
         laplace3d),
        ("laplace", [], laplace2d),
        ("laplace", ["--pipeline", "--devices", "4"], pipeline),
        ("laplace_adaptive", ["--cycles", "3", "--n", "6"], adaptive),
        ("elasticity", ["--n", "4"], elasticity),
        ("elasticity", ["--n", str(args.n_driver_elas), "--subdomains",
                        "16"], elasticity),
        ("stokes", ["--h", "0.25"], stokes),
        ("tpm", [], tpm),
        ("geometry", [], geometry),
        ("unsteady_elasticity", ["--t-end", "0.15", "--n", "4"],
         unsteady_elas),
        ("unsteady_navier_stokes", ["--mesh", channel, "--t-end", "0.04",
                                    "--dt", "0.02"], unsteady_ns),
        ("navier_stokes", ["--mesh", channel, "--subdomains", "4"],
         navier_stokes),
        ("fsi", ["--n", "3", "--t-end", "0.04"], fsi_box),
        # slow in Tier-1 (tests/test_drivers.py:102), seconds here
        ("fsi", ["--scenario", "tube", "--n", "2", "--t-end", "0.04",
                 "--dt", "0.02", "--prec", "Jacobi"], fsi_tube),
    ]
    print("driver runs left out: navier_stokes on its DFG mesh "
          "(dfg_fsi_fluid_h004.mesh is not in the repository); it runs on "
          "the channel", flush=True)
    for name, argv, ok in cases:
        mod = importlib.import_module(f"feddlib_tpu_torch.drivers.{name}")
        timers.reset()
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv + on)
        _sync(torch, dev)
        secs = time.perf_counter() - t1
        out = buf.getvalue()
        print(f"driver {name} {' '.join(argv)}: {secs:.3f} s", flush=True)
        for ln in out.splitlines():
            print("  " + ln)
        if "total [s]" not in out:
            for ln in timers.report().splitlines():
                print("  " + ln)
        _check(rc == 0 and ok(out), f"driver {name} {' '.join(argv)}: its "
               f"goldens")
    timers.reset()
    _phase("15b drivers", t0)


def _phase15c(torch, np, args, dev):
    """15c: the entry step on the card against the CPU, then
    dryrun_multichip(4) on stacked shards on the card against the same on
    the CPU."""
    from feddlib_tpu_torch.graft_entry import dryrun_multichip, entry

    t0 = time.perf_counter()
    x = np.random.default_rng(0).standard_normal(13 ** 3)
    ys = {}
    for d in (dev, torch.device("cpu")):
        f, (vc, _) = entry(d)
        ys[d.type] = f(vc, torch.as_tensor(x, device=d)).cpu().numpy()
    err = float(np.abs(ys[dev.type] - ys["cpu"]).max()
                / np.abs(ys["cpu"]).max())
    f, ex = entry(dev)
    wall = _wall_ms(torch, dev, lambda: f(*ex))
    print(f"entry() step on {dev} vs cpu: max|dy|/max|y| = {err:.3e}; "
          f"{wall:.5f} ms a step (wall)", flush=True)
    _check(err <= 1e-12, "entry() step on the card within 1e-12 of the CPU")
    runs = {}
    for d in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        runs[d.type] = dryrun_multichip(4, d)
        _sync(torch, d)
        print(f"dryrun_multichip(4) on {d}: {runs[d.type]} in "
              f"{time.perf_counter() - t1:.3f} s", flush=True)
    card, cpu = dict(runs[dev.type]), dict(runs["cpu"])
    tip = (np.array(card.pop("fsi_tip")), np.array(cpu.pop("fsi_tip")))
    tip_err = float(np.abs(tip[0] - tip[1]).max() / np.abs(tip[1]).max())
    print(f"dryrun_multichip(4) {dev} vs cpu: counts {card} vs {cpu}, FSI "
          f"tip max|d tip|/max|tip| = {tip_err:.3e}", flush=True)
    _check(card == cpu, "dryrun_multichip(4): the card's counts are the "
           "CPU's")
    _check(tip_err <= 1e-10, "dryrun_multichip(4): the FSI tip within 1e-10 "
           "of the CPU's")
    _phase("15c entry points", t0)


def _phase15(torch, np, args, dev, ref13):
    """The FSI loops on ranks, the drivers and the entry points (see the
    module docstring)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _phase15a(torch, np, args, dev, None if ref13 is None
              else ref13.get("fsi"))
    _phase15b(torch, np, args, dev)
    _phase15c(torch, np, args, dev)
    _phase("15 fsi on ranks, drivers, entry points", t0)


def _phase2_coo(np, mesh, fast):
    """The COO of phase 2's P1 Laplace scatter: ordered (a, b, E) as
    fast_assembly.pattern_abe builds it where the fast path runs (a CUDA
    domain), else (E, a, b) as assembly.scatter_pattern does."""
    el = np.asarray(mesh.elements, dtype=np.int64)
    E, nb = el.shape
    if fast:
        dT = el.T
        rows = np.broadcast_to(dT[:, None, :], (nb, nb, E))
        cols = np.broadcast_to(dT[None, :, :], (nb, nb, E))
    else:
        rows = np.broadcast_to(el[:, :, None], (E, nb, nb))
        cols = np.broadcast_to(el[:, None, :], (E, nb, nb))
    return (np.ascontiguousarray(rows).reshape(-1),
            np.ascontiguousarray(cols).reshape(-1))


def _timed(fn, *a):
    t = time.perf_counter()
    out = fn(*a)
    return out, time.perf_counter() - t


def _phase16(torch, np, args, dev, host_build, mesh=None):
    """The native host library against its numpy versions on the card
    machine's host: (a) from_coo on phase 2's COO, (b) read_mesh of MEDIT
    files written here, P1 and P2, (c) rcb of phase 2's points.  Each pair
    must agree bitwise; prints one {"host_native": ...} line.  `mesh` is
    phase 2's (built here when None: 11 s of boundary facets at 64
    cells)."""
    import tempfile

    from feddlib_tpu_torch import native, scenarios
    from feddlib_tpu_torch.fe import fast_assembly
    from feddlib_tpu_torch.la.csr import SparsityPattern
    from feddlib_tpu_torch.mesh.io import read_mesh, read_mesh_plain, write_mesh
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh

    t0 = time.perf_counter()
    out = {"compiler": host_build["compiler"],
           "build_s": host_build["build_s"]}
    # (a) the symbolic phase of phase 2's operator
    if mesh is None:
        mesh, t_mesh = _timed(build_structured_mesh, 3, args.n)
        out["mesh_s"] = t_mesh
    rows, cols = _phase2_coo(np, mesh, fast_assembly.use_fast(dev))
    n = mesh.n_points
    pn, t_nat = _timed(SparsityPattern.from_coo, rows, cols, n, n)
    pp, t_plain = _timed(SparsityPattern.from_coo_plain, rows, cols, n, n)
    for f in ("indptr", "indices", "coo_slots"):
        a, b = getattr(pn, f), getattr(pp, f)
        _check(a.dtype == b.dtype and np.array_equal(a, b),
               f"phase 16a: native from_coo {f} differs from plain")
    out["from_coo"] = {"cells": args.n, "elements": mesh.n_elements,
                       "entries": len(rows), "n_rows": n, "nnz": pn.nnz,
                       "native_s": t_nat, "plain_s": t_plain,
                       "plain_over_native": t_plain / t_nat}
    print(f"16a from_coo: {len(rows)} COO entries over {mesh.n_elements} "
          f"tets, nnz={pn.nnz}: native {t_nat:.4f} s, plain {t_plain:.4f} "
          f"s ({t_plain / t_nat:.3f}x), bitwise equal", flush=True)
    del rows, cols, pn, pp
    # (c) rcb of phase 2's points into its clusters' count
    pts = mesh.points
    rn, t_rn = _timed(native.rcb, pts, args.clusters)
    rp, t_rp = _timed(native.rcb_plain, pts, args.clusters)
    _check(np.array_equal(rn, rp), "phase 16c: native rcb differs from plain")
    _check(np.array_equal(np.unique(rn), np.arange(args.clusters)),
           "phase 16c: rcb leaves a part empty")
    out["rcb"] = {"points": len(pts), "parts": args.clusters,
                  "native_s": t_rn, "plain_s": t_rp}
    print(f"16c rcb: {len(pts)} points into {args.clusters} parts: native "
          f"{t_rn:.4f} s, plain {t_rp:.4f} s, bitwise equal", flush=True)
    # (b) MEDIT files written here, read by both parsers
    fields = ("points", "point_flags", "elements", "element_flags",
              "surfaces", "surface_flags", "lines", "line_flags", "p2_edges")
    out["read_mesh"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        cube = os.path.join(tmp, "cube.mesh")
        m3 = build_structured_mesh(3, args.n_medit)
        _check(m3.surfaces is not None and len(m3.surfaces) > 0,
               "phase 16b: the cube has no boundary triangles")
        _, t_w = _timed(write_mesh, m3, cube)
        files = {f"cube{args.n_medit}": cube,
                 "channel": scenarios.write_channel_mesh(
                     os.path.join(tmp, "channel.mesh"))}
        for name, path in files.items():
            for fe in ("P1", "P2"):
                mn, t_mn = _timed(read_mesh, path, fe)
                mp, t_mp = _timed(read_mesh_plain, path, fe)
                for f in fields:
                    a, b = getattr(mn, f), getattr(mp, f)
                    _check((a is None and b is None) or (
                        a is not None and b is not None
                        and a.dtype == b.dtype and np.array_equal(a, b)),
                        f"phase 16b: read_mesh {name} {fe} {f} differs")
                out["read_mesh"][f"{name}_{fe}"] = {
                    "bytes": os.path.getsize(path), "points": mn.n_points,
                    "elements": mn.n_elements, "native_s": t_mn,
                    "plain_s": t_mp}
                print(f"16b read_mesh {name} {fe}: {os.path.getsize(path)} "
                      f"bytes, {mn.n_points} points, {mn.n_elements} "
                      f"elements: native {t_mn:.4f} s, plain {t_mp:.4f} s, "
                      f"bitwise equal", flush=True)
        out["read_mesh"]["write_s"] = t_w
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"host_native": out}), flush=True)
    _phase("16 host native library", t0)


def _start_host_build():
    """Build the native host library in a thread (beside nvcc); returns a
    function that waits for it and returns {"compiler", "build_s"}."""
    import threading

    from feddlib_tpu_torch import native

    res = {}

    def run():
        t = time.perf_counter()
        try:
            native.get_lib()
        except RuntimeError as e:
            res["error"] = e
        res["build_s"] = time.perf_counter() - t

    th = threading.Thread(target=run)
    th.start()

    def wait():
        th.join()
        if "error" in res:
            raise res["error"]
        return {"compiler": native.compiler_version(),
                "build_s": res["build_s"]}

    return wait


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=64,
                    help="cells per side of the main-path cube")
    ap.add_argument("--clusters", type=int, default=512)
    ap.add_argument("--n-bench", type=int, default=40,
                    help="cells per side of the bench-chain cube")
    ap.add_argument("--bench-clusters", type=int, default=512)
    ap.add_argument("--n-elas", type=int, default=32,
                    help="cells per side of the P2 elasticity operator cube")
    ap.add_argument("--n-solve", type=int, default=40,
                    help="cells per side of the P1 elasticity solve cube")
    ap.add_argument("--solve-clusters", type=int, default=128)
    # phases 7, 12a, 13a and 14a solve this one system (12a-14a against
    # phase 7's); at 64 cells they took 290-334 s of the script (runs 12d,
    # 13c), which went over its time limit on a slow host
    ap.add_argument("--n-schwarz", type=int, default=48,
                    help="cells per side of the f64 default-path cube "
                         "(cut from 64)")
    ap.add_argument("--schwarz-parts", type=int, default=512)
    # the cavity's dof-map clusters are rebalanced (rebalance_row_clusters),
    # which widens the widest cluster's ghost set 5-6x: at 20 cells and 128
    # clusters its [P, W, W] f32 level-1 blocks would take 203 GiB
    ap.add_argument("--n-ns", type=int, default=12,
                    help="cells per side of the cavity's pressure cube")
    ap.add_argument("--ns-clusters", type=int, default=64)
    ap.add_argument("--n-hyper", type=int, default=32,
                    help="cells per side of the hyperelastic block's cube")
    ap.add_argument("--hyper-clusters", type=int, default=64)
    ap.add_argument("--n-newmark", type=int, default=8,
                    help="cells per side of the checkpointed Newmark cube")
    ap.add_argument("--n-asm", type=int, default=64,
                    help="cells per side of the P1 assembly cube")
    ap.add_argument("--n-asm-p2", type=int, default=32,
                    help="cells per side of the P2 assembly cube")
    ap.add_argument("--n-hex", type=int, default=24,
                    help="cells per side of the Q2 hex cube")
    # the FSI's dof-map clusters are rebalanced as the cavity's are: at 16
    # cells a side and 64 clusters the level-1 factor's square f32 blocks
    # [64, W, W] would take 59 GB (W = 15,220, the host estimate phase 11
    # prints), beyond the 40 GB the phase allows itself; at 12, 17.5 GB
    ap.add_argument("--n-fsi", type=int, default=12,
                    help="cells per side of each 3D FSI box (n, n, n/2)")
    ap.add_argument("--fsi-clusters", type=int, default=64)
    ap.add_argument("--n-fsi2d", type=int, default=64,
                    help="cells per side of each 2D FSI box (FaCSI)")
    ap.add_argument("--n-dist", type=int, default=48,
                    help="cells per side of the distributed solve's cube "
                         "(cut from 64 with --n-schwarz)")
    ap.add_argument("--dist-devices", type=int, default=512,
                    help="shards of the distributed solve")
    ap.add_argument("--n-fsi-gi", type=int, default=32,
                    help="cells per side of each 2D FSI box (GI)")
    ap.add_argument("--n-pipe-ns", type=int, default=6,
                    help="cells per side of phase 13b's cavity (cut from "
                         "12 for phase 14's time, then to 6 for phase "
                         "15's)")
    ap.add_argument("--pipe-ns-devices", type=int, default=64,
                    help="shards of phase 13b's cavity")
    # at phase 11b's 64 cells the eight solid shards' FaCSI subdomains are
    # 4,690 wide: their host inverses took 28-32 s a Newton step on the
    # card's host, 181 s for the two steps (run 10a); at 32, 1,200 wide
    ap.add_argument("--n-pipe-fsi", type=int, default=32,
                    help="cells per side of each 2D FSI box (phase 13c)")
    ap.add_argument("--pipe-fsi-devices", type=int, default=32,
                    help="shards of phase 13c's GE loop (and serial FaCSI "
                         "subdomains)")
    ap.add_argument("--pipe-fsi-solid", type=int, default=8,
                    help="solid shards of phase 13c")
    ap.add_argument("--pipe-gi-devices", type=int, default=16,
                    help="shards of phase 13d's GI step (and serial "
                         "subdomains)")
    ap.add_argument("--pipe-gi-solid", type=int, default=4,
                    help="solid shards of phase 13d")
    ap.add_argument("--n-amr", type=int, default=128,
                    help="cells per side of phase 14c's first mesh")
    ap.add_argument("--amr-cycles", type=int, default=3,
                    help="phase 14c's cycles (cut from 5: the fifth's "
                         "distributed set-up took 36-38 s a mode; then "
                         "to 3 to make room for phase 15)")
    ap.add_argument("--amr-devices", type=int, default=16,
                    help="shards of phase 14c's distributed modes")
    ap.add_argument("--amr-clusters", type=int, default=64,
                    help="clusters of phase 14c's mixed-precision mode")
    ap.add_argument("--amr-tol", type=float, default=1e-12,
                    help="phase 14c's solve tolerance (eta agrees to about "
                         "the solves' error: 2e-7 at 1e-10)")
    ap.add_argument("--rank-timeout", type=float, default=400,
                    help="seconds each spawned rank of phase 14 may take")
    ap.add_argument("--n-driver-elas", type=int, default=16,
                    help="cells a side of phase 15b's 3D elasticity driver "
                         "run")
    ap.add_argument("--n-medit", type=int, default=32,
                    help="cells a side of phase 16b's MEDIT cube")
    ap.add_argument("--only", choices=["9", "12,13", "14", "15", "16"],
                    default=None,
                    help="after the build run phase 9 alone (without "
                         "its B1-B3 checks), phases 12 and 13 alone "
                         "(phase 12 without its phase 7 comparison), "
                         "phase 13a and phase 14, phases 13c/13d and "
                         "phase 15, or phase 16; no kernel entries")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

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
    host_wait = _start_host_build()
    lib_path = _cuda.build()
    _cuda.lib()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())
    print(f"kernels built: {lib_path}")
    host_build = host_wait()
    print(f"host library built with {host_build['compiler']} in "
          f"{host_build['build_s']:.3f} s (beside nvcc)")
    _phase("1 build", t0)
    if args.only is not None:
        if args.only == "9":
            _phase9(torch, np, args, dev, None)
        elif args.only == "16":
            _phase16(torch, np, args, dev, host_build)
        elif args.only == "12,13":
            ref12 = _phase12(torch, np, args, dev, None)
            gc.collect()
            torch.cuda.empty_cache()
            _phase13(torch, np, args, dev, ref12)
        elif args.only == "14":
            _phase14(torch, np, args, dev,
                     _phase13a(torch, np, args, dev, None), None)
        else:
            _phase15(torch, np, args, dev,
                     {"fsi": _phase13cd(torch, np, args, dev)})
        print(json.dumps({"kernels": []}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    # -- phase 2: main path ---------------------------------------------------
    t0 = time.perf_counter()
    _cuda.reset_launch_counts()
    prob = _laplace(torch, args.n, args.clusters, dev)
    t_setup = time.perf_counter()
    iters, reg2 = _measured(prob.solve)
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
    mesh2 = prob.variables[0][0].mesh  # host arrays, for phase 16
    # the same solve twice more with the built preconditioner: the first
    # captures the Arnoldi steps (solvers/krylov.py ArnoldiPlan), the
    # second replays them under the benchmark's profiler reduction
    # (benchmark/tracing.py), which times the refinement and inner GMRES
    # alone for the card's busy share; both give the first solve's x
    u1 = u.clone()
    again = []

    def solve_again():
        its, reg = _measured(prob.solve)
        again.append((its, reg.counts, prob.solution[0].clone()))
        return its

    iters_again, tr = _traced(torch, dev, solve_again)
    t_ir = tr.window_s
    _check(abs(iters_again - iters) <= 2, "repeated solve iterations")
    (its_c, cnt_c, u_c), (its_r, cnt_r, u_r) = again
    print(f"main path: repeated solves {its_c}, {its_r} iterations; "
          f"graph captures {cnt_c.get('krylov.graph_captures', 0)}, "
          f"{cnt_r.get('krylov.graph_captures', 0)}, replays "
          f"{cnt_c.get('krylov.graph_replays', 0)}, "
          f"{cnt_r.get('krylov.graph_replays', 0)}", flush=True)
    _check(cnt_c.get("krylov.graph_captures", 0) > 0,
           "the second solve captured no Arnoldi step")
    _check(cnt_r.get("krylov.graph_captures", 0) == 0
           and cnt_r.get("krylov.graph_replays", 0)
           == cnt_r["krylov.iterations"] == its_r,
           "the profiled solve replayed every iteration")
    _check(its_c == its_r == iters and torch.equal(u_c, u1)
           and torch.equal(u_r, u1),
           "the capturing and the replaying solves against the first, "
           "bit for bit")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(tr.kernel(k) is not None,
               f"the replayed solve's trace names no {k}")
    print(f"main path: the repeated solve under the profiler: "
          f"{sum(v[1] for v in tr.kernels.values())} device events, busy "
          f"{tr.busy_s * 1e3:.3f} ms (union of kernels and copies) of "
          f"{tr.window_s * 1e3:.3f} ms wall = "
          f"{tr.busy_s / tr.window_s:.4f} busy; idle gaps "
          f"{[[n, round(v, 4)] for n, v in tr.breakdown['idle_gaps'][:4]]}",
          flush=True)
    print(f"main path: n_dofs={A_sp.shape[0]} nnz={A_sp.nnz} P={db.P} "
          f"R={db.R} G={db.G} W={db.R + db.G} E={split.Ac.E} "
          f"K={split.Ac.K} coarse_dim={prec.n_coarse}")
    print(f"main path: ir_passes={prob.last_passes} inner_iters={iters} "
          f"relres={prob.last_relres:.3e} host_f64_relres={rel_host:.3e} "
          f"setup_s={t_setup - t0:.3f} solve_s={t_solve:.3f} "
          f"ir_s={t_ir:.3f} (under the profiler) set-up s "
          + reg2.parts("mixed.partition", "mixed.layout", "prec.level1",
                       "prec.gdsw", "gdsw.extend", "prec.coarse_layout"))
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

    def entry(name, src, replaces, launches, err, ms, plain_ms, bound,
              lib_ms, lib_stored_ms=None, err_kind="abs", **more):
        """Appends to `kernels` (phases 4 and 5 call it too).  The SELL
        kernels have two library times: `lib_ms` over a CSR of the nonzero
        values (the same function), `lib_stored_ms` over a CSR of every
        stored entry (the same work as the kernel, less the padding);
        `lib_ms` None where no library call computes it (B6).  `err` is
        the largest absolute error, or relative with `err_kind` "rel".
        `more` adds keys whose values are dicts of times (B2's with its
        inputs out of L2, B4's at a stress shape, B5's three bounds, B6's
        residual-only launch and previous path)."""
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches,
                        f"max_{err_kind}_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound[0],
                        "bound_by": bound[1], "library_ms": lib_ms})
        lib = "none" if lib_ms is None else f"{lib_ms:.5f}"
        stored = ""
        if lib_stored_ms is not None:
            kernels[-1]["library_stored_ms"] = lib_stored_ms
            stored = f" library_stored_ms={lib_stored_ms:.5f}"
        print(f"  {name}: ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib}{stored} bound_ms={bound[0]:.5f} "
              f"({bound[1]}) max_{err_kind}_err={err:.3e}", flush=True)
        for key, val in more.items():
            kernels[-1][key] = val
            print(f"    {key}: " + " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in val.items()), flush=True)

    def hold_b1(where, idx, n_in, launches):
        """B1 against its plain version and the x[idx] yardstick, back to
        back and with x and the plan out of L2 (between two ghost fetches
        of a solve, B3's level-1 stream passes through the L2)."""
        x = torch.randn(n_in, generator=g, device=dev)
        y_k = pm.permute_gather(x, idx)
        y_p = pm.permute_gather_plain(x, idx)
        torch.cuda.synchronize()
        _check(torch.equal(y_k, y_p), f"B1 bit-exact{where}")
        x_ext = torch.cat([x, x.new_zeros(1)])
        idx_lib = torch.where(idx < 0, n_in, idx).long()
        _check(torch.equal(x_ext[idx_lib], y_p), f"B1 yardstick{where}")
        print(f"B1 shapes{where}: n_in={n_in} n_out={idx.numel()} "
              f"ragged end={idx.numel() % 64} (outputs past the last whole "
              f"warp tile of 64)")

        def lib_call(x_ext, idx_lib):
            return x_ext[idx_lib]

        cold = {"ms": _device_ms(torch, _cold_calls(pm.permute_gather, x,
                                                    idx)),
                "library_ms": _device_ms(
                    torch, _cold_calls(lib_call, x_ext, idx_lib))}
        entry("B1 permute_gather" + where,
              "feddlib_tpu_torch/csrc/permute.cu",
              "feddlib_tpu/la/permute.py:206", launches, 0.0,
              _device_ms(torch, lambda: pm.permute_gather(x, idx)),
              _device_ms(torch, lambda: pm.permute_gather_plain(x, idx)),
              _bound(4 * n_in + 8 * idx.numel(), 0, PEAK_F32_S),
              _device_ms(torch, lambda: lib_call(x_ext, idx_lib)), cold=cold)
        return x

    def hold_b123(where, db, split, prec, counts):
        """B1, B2 and B3 against their plain versions at the shapes of one
        mixed-precision two-level solve (its cached operators)."""
        # B1: the cluster ghost fetch
        idx = db.ghost_plan[0]
        x = hold_b1(where, idx, db.P * db.R, counts["permute_gather"])

        # B2: the padded SELL operator A
        Ac = split.Ac
        xfull = torch.cat([x, pm.permute_gather(x, idx)])
        nx2 = (Ac.shape[1] + 127) // 128
        x2d = torch.zeros(nx2 * 128, device=dev)
        x2d[: Ac.shape[1]] = xfull
        x2d = x2d.reshape(nx2, 128)
        y_k = sl.sell_spmv(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
        y_p = sl.sell_spmv_plain(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
        err = float((y_k - y_p).abs().max())
        _check(err <= 1e-6 * float(y_p.abs().max()), f"B2 error {err}{where}")
        csr = _sell_to_torch_csr(torch, Ac)
        csr_st = _sell_to_torch_csr(torch, Ac, stored=True)
        xcol = x2d.reshape(-1)
        n_rows = Ac.shape[0]
        for c in (csr, csr_st):
            _check(float(((c @ xcol)[:n_rows] - y_p[:n_rows]).abs().max())
                   <= 1e-5 * float(y_p.abs().max()), f"B2 yardstick{where}")
        slots = Ac.vals.numel()
        nnz_sell = int((Ac.vals != 0).sum())
        print(f"B2 shapes{where}: nchunks={Ac.vals.shape[0]} E={Ac.E} "
              f"K={Ac.K} nx2={nx2} rows={n_rows} nnz={Ac.nnz} "
              f"slots={slots} stored_entries={int((Ac.data_slots >= 0).sum())}"
              f" nonzero={nnz_sell} spill="
              f"{0 if Ac.spill_rows is None else Ac.spill_rows.numel()}")
        # back to back the main path's 27 MB of planes stay in the L2; in
        # the solve they come from HBM, so time them cold as well
        def b2(v, p, b):
            return sl.sell_spmv(v, p, b, x2d, Ac.E)

        def mv(c):
            return c @ xcol

        l2_cold = {
            "ms": _device_ms(torch, _cold_calls(b2, Ac.vals, Ac.pidx,
                                                Ac.bids)),
            "library_ms": _device_ms(torch, _cold_calls(mv, csr)),
            "library_stored_ms": _device_ms(torch, _cold_calls(mv, csr_st))}
        entry("B2 sell_spmv" + where, "feddlib_tpu_torch/csrc/sell.cu",
              "feddlib_tpu/la/sell.py:354", counts["sell_spmv"], err,
              _device_ms(torch, lambda: b2(Ac.vals, Ac.pidx, Ac.bids)),
              _device_ms(torch, lambda: sl.sell_spmv_plain(
                  Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)),
              _bound(6 * slots + 4 * Ac.bids.numel() + 4 * x2d.numel()
                     + 4 * (slots // Ac.E), 2 * nnz_sell, PEAK_F32_S),
              _device_ms(torch, lambda: mv(csr)),
              _device_ms(torch, lambda: mv(csr_st)), l2_cold=l2_cold)
        del csr, csr_st

        # B3: the f32 level-1 inverse (of the two-level preconditioner, or
        # the one-level DenseBlockSchwarz itself)
        inv = getattr(prec, "level1", prec).inv
        P, R, W = inv.shape
        xs = torch.randn(P, W, generator=g, device=dev)
        y_k = dk.dense_block_mv(inv, xs)
        y_p = dk.dense_block_mv_plain(inv, xs)
        err = float((y_k - y_p).abs().max())
        _check(err <= 1e-5 * float(y_p.abs().max()), f"B3 error {err}{where}")
        print(f"B3 shapes{where}: P={P} R={R} W={W} bytes={inv.numel() * 4}")
        entry("B3 dense_gemv_f32" + where,
              "feddlib_tpu_torch/csrc/dense_gemv.cu",
              "feddlib_tpu/la/pallas_kernels.py:26", counts["dense_gemv_f32"],
              err, _device_ms(torch, lambda: dk.dense_block_mv(inv, xs)),
              _device_ms(torch, lambda: dk.dense_block_mv_plain(inv, xs),
                         samples=20, calls=2),
              _b3_bound(db),
              _device_ms(torch, lambda: torch.bmm(inv, xs.unsqueeze(-1))))

    # the least time of any launch under _device_ms: an empty one-block
    # kernel, back to back (not a kernel of the port; not in the last line)
    floor_ms = _device_ms(torch, lambda: torch.cuda._sleep(0))
    print(f"launch_floor_ms={floor_ms:.5f} (torch.cuda._sleep(0), one block, "
          f"back to back: the floor of every kernel time below)", flush=True)
    hold_b123("", db, split, prec, counts2)

    # B4 at a store beyond the 50 MB L2, a stress shape off every path:
    # the main path's level-1 inverse as bf16 (written in phase 4 into the
    # entry of B4, whose launches are the bench chain's)
    inv = prec.level1.inv.to(torch.bfloat16)
    P, R, W = inv.shape
    xs = torch.randn(P, W, generator=g, device=dev)
    y_k = dk.dense_block_mv_lowp(inv, xs)
    y_p = dk.dense_block_mv_lowp_plain(inv, xs)
    err = float((y_k - y_p).abs().max())
    _check(err <= 1e-5 * float(y_p.abs().max()), f"B4 error {err} (L2)")
    xs_bf = xs.to(torch.bfloat16).unsqueeze(-1)
    print(f"B4 shapes (main-path level-1 inverse as bf16): P={P} R={R} "
          f"W={W} bytes={inv.numel() * 2}")
    b4_beyond_l2 = {
        "shape": [P, R, W], "max_abs_err": err,
        "ms": _device_ms(torch, lambda: dk.dense_block_mv_lowp(inv, xs)),
        "plain_ms": _device_ms(
            torch, lambda: dk.dense_block_mv_lowp_plain(inv, xs),
            samples=20, calls=2),
        "bound_ms": _bound(2 * P * R * W + 4 * P * W + 4 * P * R,
                           2 * P * R * W, PEAK_BF16_S)[0],
        "library_ms": _device_ms(torch, lambda: torch.bmm(inv, xs_bf))}
    del inv, xs, xs_bf, y_k, y_p
    _phase("3 kernels (main-path shapes)", t0)

    # free phase 2 before phase 4 builds its own operators
    del prob, cache, db, split, prec, A_sp, u
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 4: bench-chain configuration -----------------------------------
    t0 = time.perf_counter()
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.solvers.krylov import solve
    from feddlib_tpu_torch.solvers.refinement import iterative_refinement

    bc = _bench_chain(torch, np, args.n_bench, args.bench_clusters, dev)
    Kb_sp, bb_np, Kb, db, Ap, prec = (bc.K_sp, bc.b_np, bc.K, bc.db, bc.Ap,
                                      bc.prec)
    A_fn, A_ops, M_fn, M_ops = bc.A_fn, bc.A_ops, bc.M_fn, bc.M_ops
    bb = torch.as_tensor(bb_np, device=dev)
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
          _device_ms(torch, lambda: torch.bmm(inv, xs_bf)),
          stress_beyond_l2=b4_beyond_l2)
    torch.cuda.synchronize()
    _phase("4 bench chain", t0)

    del Kb, Kb_sp, bb, db, Ap, prec, inv, xs, xs_bf, y_k, y_p, res, xp, bc
    del A_fn, A_ops, M_fn, M_ops
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5: elasticity operator through auto_spmv ----------------------
    t0 = time.perf_counter()
    from feddlib_tpu_torch.la.dia import (BlockDiaMatrix, SplitDiaMatrix,
                                          auto_spmv)
    from feddlib_tpu_torch.la.sell import BlockSellMatrix

    dom = Domain.structured(3, args.n_elas, device=dev).p2_domain()
    t_mesh = time.perf_counter() - t0
    with _Registry() as sym5:
        prob = _linelas(torch, dom, {}, dev)
        A = prob.bc_system().get_block(0, 0)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0 - t_mesh
    pats = sym5.each("fe.pattern")
    print(f"elasticity operator symbolic phase (the patterns built: COO "
          f"and native from_coo): {len(pats)} patterns, {sum(pats):.3f} s; "
          f"the largest {max(pats, default=0.0):.3f} s", flush=True)
    t_fmt = time.perf_counter()
    F, reg = _measured(auto_spmv, A, dtype=torch.float32, dofs_per_node=3)
    torch.cuda.synchronize()
    t_fmt = time.perf_counter() - t_fmt
    _check(isinstance(F, SplitDiaMatrix), f"format is {type(F).__name__}")
    _check(isinstance(F.sell, BlockSellMatrix),
           f"residue is {type(F.sell).__name__}")
    bs, lay = F.sell, F.sell.layout
    n_spill = 0 if bs.spill_rows is None else bs.spill_rows.numel()
    print(f"elasticity operator: n_nodes={dom.n_nodes} n_dofs={A.shape[0]} "
          f"nnz={A.nnz} format={type(F).__name__} dia_share="
          f"{F.dia_share:.4f} node_offsets={len(F.dia.offsets)} residue="
          f"{type(bs).__name__} E={lay.E} K={lay.K} chunks="
          f"{bs.vals.shape[0]} residue_nnz={bs.nnz} spill={n_spill} "
          f"bytes_per_apply={F.hbm_bytes_per_apply()}")
    print(f"elasticity operator setup_s: mesh={t_mesh:.3f} "
          f"assembly_and_bc={t_asm:.3f} auto_spmv={t_fmt:.3f} of which "
          + reg.parts("split.rcm", "split.permute", "split.dia_layout",
                      "split.sell_layout", "split.gathers"), flush=True)
    A_sp = A.to_scipy()
    fn5, ops5 = F.operator()
    x5 = torch.randn(A.shape[0], generator=g, device=dev)

    _cuda.reset_launch_counts()
    y5 = fn5(ops5, x5)
    torch.cuda.synchronize()
    ref5 = A_sp @ x5.double().cpu().numpy()
    err5 = float(np.abs(y5.double().cpu().numpy() - ref5).max()
                 / np.abs(ref5).max())
    _check(err5 <= 1e-5, f"elasticity apply vs host f64 product: {err5}")
    counts_apply = dict(_cuda.launch_counts)
    _check(counts_apply["block_sell_spmv"] == 1
           and counts_apply["permute_gather"] == 2,
           f"launches of one split apply: {counts_apply}")
    F2 = F.with_data(2.0 * A.data)
    y5b = F2.matvec(x5)
    err5b = float((y5b - 2.0 * y5).abs().max() / y5.abs().max())
    _check(err5b <= 1e-6, f"with_data(2*data) does not double: {err5b}")
    del F2, y5b
    # a fixed number of Jacobi-preconditioned GMRES iterations, f32, over
    # the format's (fn, operands)
    from feddlib_tpu_torch.solvers.linear import _jacobi_op

    diag = A.diagonal()
    dinv = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)).float()
    b5_vec = prob.rhs[0].float()
    _cuda.reset_launch_counts()
    t_kr = time.perf_counter()
    res5 = solve("gmres", fn5, ops5, b5_vec, M_fn=_jacobi_op, M_ops=(dinv,),
                 tol=0.0, maxiter=200, restart=50)
    torch.cuda.synchronize()
    t_kr = time.perf_counter() - t_kr
    counts5 = dict(_cuda.launch_counts)
    rel5 = _host_relres(np, A_sp, prob.rhs[0], res5.x)
    _check(res5.iters >= 200, "GMRES iteration count")
    _check(bool(torch.isfinite(res5.x).all()), "finite Krylov iterate")
    _check(rel5 < 0.9, f"host f64 residual did not fall: {rel5}")
    for k in ("block_sell_spmv", "permute_gather"):
        _check(counts5[k] > 0, f"elasticity operator launched no {k}")
    ap_ms = _device_ms(torch, lambda: fn5(ops5, x5), samples=10, calls=10)
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(50):
        y5 = fn5(ops5, x5)
    torch.cuda.synchronize()
    ap_wall_ms = (time.perf_counter() - tw) / 50 * 1e3
    print(f"elasticity operator: apply_vs_host_f64={err5:.3e} "
          f"with_data_err={err5b:.3e} apply_ms={ap_ms:.5f} (device) "
          f"apply_wall_ms={ap_wall_ms:.5f} (host clock, 50 applies)")
    print(f"elasticity operator: gmres_iters={res5.iters} "
          f"host_f64_relres={rel5:.3e} krylov_s={t_kr:.3f} launches of "
          f"one apply={counts_apply} launches of the Krylov solve="
          f"{counts5} (per iteration: block_sell_spmv "
          f"{counts5['block_sell_spmv'] / res5.iters:.3f}, permute_gather "
          f"{counts5['permute_gather'] / res5.iters:.3f})", flush=True)

    # B1 at the split's entry and exit gathers
    hold_b1(" (elasticity operator, entry gather)", F.gin.idx, F.gin.n_in,
            counts5["permute_gather"] // 2)
    hold_b1(" (elasticity operator, exit gather)", F.gout.idx, F.gout.n_in,
            counts5["permute_gather"] - counts5["permute_gather"] // 2)

    # B5 against its plain version at this operator's shapes, on the
    # sliced layout the apply reads (and that layout against the planes)
    d5, pl5 = bs.d, bs.plan
    nn5 = dom.n_nodes
    nx2 = (nn5 + 127) // 128
    x2d = torch.randn(d5 * nx2, 128, generator=g, device=dev)
    x5p = x2d.reshape(d5, -1)

    def b5():
        return sl.block_sell_slices(bs.hvals, pl5.hcols, pl5.slice_ptr,
                                    pl5.row_of, x5p, nn5)

    def b5_plain():
        return sl.block_sell_slices_plain(bs.hvals, pl5.hcols, pl5.slice_ptr,
                                          pl5.row_of, x5p, nn5)

    y_k, y_p = b5(), b5_plain()
    torch.cuda.synchronize()
    err = float((y_k - y_p).abs().max())
    ymax = float(y_p.abs().max())
    _check(err <= 1e-6 * ymax, f"B5 error {err}")
    y_planes = sl.block_sell_spmv_plain(bs.vals, lay.pidx, lay.bids, x2d,
                                        lay.E, d5)[:, :nn5]
    err_planes = float((y_p - y_planes).abs().max())
    _check(err_planes <= 1e-5 * ymax, f"B5 layout vs planes {err_planes}")
    del y_planes
    csr = _block_sell_to_torch_csr(torch, bs)
    csr_st = _block_sell_to_torch_csr(torch, bs, stored=True)
    xcol = x2d.reshape(-1)
    for c in (csr, csr_st):
        _check(float((c @ xcol - y_p.reshape(-1)).abs().max())
               <= 1e-5 * ymax, "B5 yardstick")
    slots = lay.pidx.numel()
    stored = int((bs.vals != 0).sum())
    layout_bytes = bs.hvals.numel() * 4 + pl5.nbytes()
    xy_bytes = 4 * d5 * nn5 * 2
    print(f"B5 shapes: d={d5} node_rows={nn5} slices="
          f"{pl5.slice_ptr.numel() - 1} sigma={sl.SORT_WINDOW} slice_rows="
          f"{sl.SLICE_ROWS} slots={pl5.src.numel()} occupied="
          f"{pl5.n_occupied} slots_per_occupied={pl5.slots_per_occupied:.4f} "
          f"layout_bytes={layout_bytes} stored_nonzeros={stored} (planes: "
          f"nchunks={bs.vals.shape[0]} E={lay.E} K={lay.K} slots={slots} "
          f"plane_bytes={bs.vals.numel() * 4}, kept on the card for parity)")
    # three bounds: the planes the parent kernel read, the sliced layout
    # this kernel reads, and what any format must move (each nonzero value
    # and one 4 B column a nonzero block, x and y): the last is bound_ms
    b_planes = _bound(4 * bs.vals.numel() + 2 * slots + 4 * lay.bids.numel()
                      + 4 * x2d.numel() + 4 * d5 * nn5, 2 * stored,
                      PEAK_F32_S)
    b_layout = _bound(layout_bytes + xy_bytes, 2 * stored, PEAK_F32_S)
    b_any = _bound(4 * stored + 4 * pl5.n_occupied + xy_bytes, 2 * stored,
                   PEAK_F32_S)
    entry("B5 block_sell_slices", "feddlib_tpu_torch/csrc/block_sell.cu",
          "feddlib_tpu/la/sell.py:788", counts5["block_sell_spmv"], err,
          _device_ms(torch, b5),
          _device_ms(torch, b5_plain, samples=10, calls=4), b_any,
          _device_ms(torch, lambda: csr @ xcol),
          _device_ms(torch, lambda: csr_st @ xcol),
          bounds={"planes_ms": b_planes[0], "layout_ms": b_layout[0],
                  "any_format_ms": b_any[0]})
    k5 = kernels[-1]
    print(f"  B5 at {b_any[0] / k5['ms']:.3f} of the any-format bound, "
          f"{b_layout[0] / k5['ms']:.3f} of its layout's, "
          f"{b_planes[0] / k5['ms']:.3f} of the planes'; layout vs planes "
          f"max_abs_err={err_planes:.3e}")
    torch.cuda.synchronize()
    _phase("5 elasticity operator", t0)

    del prob, A, A_sp, F, bs, lay, pl5, fn5, ops5, x5, y5, res5, dinv, diag
    del csr, csr_st, xcol, y_k, y_p, x2d, x5p, dom, ref5, b5_vec
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 6: elasticity solve -------------------------------------------
    t0 = time.perf_counter()
    prob = _linelas(torch, Domain.structured(3, args.n_solve, device=dev),
                    {"Use Mixed Precision": True, "TwoLevel": True,
                     "Null Space Type": "Elasticity",
                     "Clusters": args.solve_clusters,
                     "Convergence Tolerance": 1e-8}, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    _cuda.reset_launch_counts()
    iters, reg6 = _measured(prob.solve)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t_setup
    counts6 = dict(_cuda.launch_counts)
    u = prob.solution[0]
    A = prob.bc_system().get_block(0, 0)
    A_sp = A.to_scipy()
    _check(u.dtype == torch.float64 and u.shape[0] == A.shape[0],
           "elasticity solution dtype/shape")
    _check(bool(torch.isfinite(u).all()), "finite elasticity solution")
    rel6 = _host_relres(np, A_sp, prob.rhs[0], u)
    cache = prob._mixed_cache
    db, prec = cache["db32"], cache["prec"]
    print(f"elasticity solve: n_dofs={A.shape[0]} nnz={A.nnz} P={db.P} "
          f"R={db.R} G={db.G} W={db.R + db.G} E={cache['sell'].Ac.E} "
          f"K={cache['sell'].Ac.K} coarse_dim={prec.n_coarse}")
    print(f"elasticity solve: ir_passes={prob.last_passes} inner_iters="
          f"{iters} relres={prob.last_relres:.3e} host_f64_relres="
          f"{rel6:.3e} setup_s={t_setup - t0:.3f} solve_s={t_solve:.3f} "
          "set-up s " + reg6.parts(
              "mixed.partition", "mixed.layout", "prec.level1", "prec.gdsw",
              "gdsw.extend", "prec.coarse_layout"))
    print(f"elasticity solve launches: {counts6} (per inner iteration: "
          f"{ {k: round(v / max(iters, 1), 2) for k, v in counts6.items()} })",
          flush=True)
    _check(rel6 <= 1e-8, f"elasticity host f64 residual {rel6} > 1e-8")
    _check(float(u.reshape(-1, 3)[:, 2].min()) < 0, "body sags under load")
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        _check(counts6[k] > 0, f"elasticity solve launched no {k}")
    # B1-B3 against their plain versions at this solve's shapes
    hold_b123(" (elasticity solve)", db, cache["sell"], prec, counts6)
    # the structured vector operator takes the block-DIA format
    Fb = auto_spmv(A, dtype=torch.float32, dofs_per_node=3)
    _check(isinstance(Fb, BlockDiaMatrix), f"P1 format {type(Fb).__name__}")
    x6 = torch.randn(A.shape[0], generator=g, device=dev)
    ref6 = A_sp @ x6.double().cpu().numpy()
    err6 = float(np.abs(Fb.matvec(x6).double().cpu().numpy() - ref6).max()
                 / np.abs(ref6).max())
    bd_ms = _device_ms(torch, lambda: Fb.matvec(x6), samples=10, calls=10)
    print(f"elasticity solve: P1 operator format={type(Fb).__name__} "
          f"node_offsets={len(Fb.offsets)} apply_vs_host_f64={err6:.3e} "
          f"apply_ms={bd_ms:.5f} (device)")
    _check(err6 <= 1e-5, f"block-DIA apply vs host f64 product: {err6}")
    # the f64 Krylov path with Jacobi: block-DIA A-apply on the card
    small = {}
    for d in ("cuda", "cpu"):
        p = _linelas(torch, Domain.structured(3, 10, device=d),
                     {"Preconditioner Type": "Jacobi"}, d)
        small[d] = (p.solve(), p.solution[0].cpu().numpy(), p.last_relres,
                    getattr(p, "_autofmt", None))
    dsmall = float(np.abs(small["cuda"][1] - small["cpu"][1]).max())
    print(f"small Jacobi solve cuda vs cpu: iters {small['cuda'][0]} vs "
          f"{small['cpu'][0]}, max|du|={dsmall:.3e}")
    _check(isinstance(small["cuda"][3]["fmt"], BlockDiaMatrix)
           and small["cpu"][3] is None, "f64 path format dispatch")
    _check(small["cuda"][2] <= 1e-8 and small["cpu"][2] <= 1e-8,
           "small Jacobi solves reach 1e-8")
    _check(abs(small["cuda"][0] - small["cpu"][0]) <= 2
           and dsmall < 1e-7, "small Jacobi solve cuda vs cpu")
    _phase("6 elasticity solve", t0)

    del prob, A, A_sp, cache, db, prec, u, Fb, x6, ref6, small
    gc.collect()
    torch.cuda.empty_cache()
    ref7 = _phase7(torch, np, args, dev)
    gc.collect()
    torch.cuda.empty_cache()
    _phase8(torch, np, args, dev, hold_b123)
    gc.collect()
    torch.cuda.empty_cache()
    _phase9(torch, np, args, dev, hold_b123, entry)
    gc.collect()
    torch.cuda.empty_cache()
    _phase10(torch, np, args, dev, entry)
    gc.collect()
    torch.cuda.empty_cache()
    _phase11(torch, np, args, dev, hold_b123)
    gc.collect()
    torch.cuda.empty_cache()
    ref12 = _phase12(torch, np, args, dev, ref7)
    gc.collect()
    torch.cuda.empty_cache()
    ref13 = _phase13(torch, np, args, dev, ref12)
    gc.collect()
    torch.cuda.empty_cache()
    _phase14(torch, np, args, dev, ref13, hold_b123)
    gc.collect()
    torch.cuda.empty_cache()
    _phase15(torch, np, args, dev, ref13)
    _phase16(torch, np, args, dev, host_build, mesh2)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
