"""Entry points of the port — counterpart of the JAX package's
__graft_entry__.py.

`entry()` — a forward step on the flagship pipeline: batched FE assembly
of the 3D Poisson operator (element transforms → einsum stiffness → the
deterministic duplication-plan scatter) fused with an ELL SpMV, the hot
path of every solver iteration.  Plain torch (the JAX step is XLA too).

`dryrun_multichip(n)` — the pipeline's end-to-end steps over n shards
(stacked on one device, or this rank's shards inside a program of ranks:
parallel/multihost.py), none of which forms a global matrix: Poisson with
two-level GDSW and a dedicated coarse shard, a Navier–Stokes Newton step
with block GDSW, the FSI GE multi-mesh step with distributed FaCSI and two
pipeline time steps, then `Problem.solve` with the pipeline.

  python -m feddlib_tpu_torch.graft_entry          # on the card
  python -m feddlib_tpu_torch.graft_entry --cpu
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def entry(device="cuda"):
    """(step, example_args): step(vert_coords, x) assembles the P1
    Poisson stiffness of Domain.structured(3, 12) from the vertex
    coordinates and applies it to x."""
    from feddlib_tpu_torch.fe import assembly as asm
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.la.csr import assemble_csr_data

    dom = Domain.structured(3, 12, device=device)
    pattern = dom.pattern(
        ("square", 1),
        lambda: asm.scatter_pattern(dom.elem_dofs(1), dom.elem_dofs(1),
                                    dom.n_nodes, dom.n_nodes),
    )
    slots = pattern.coo_slots
    nnz = pattern.nnz
    plan = pattern._device_plan(dom.device)
    # ELL plan (host-built, uploaded once)
    ell_cols, slot_of = pattern.ell_plan(dom.device)

    def step(vert_coords, x):
        """Assemble the Poisson stiffness from geometry and apply it to x."""
        Ke = asm.elem_laplace(vert_coords, 3, "P1")
        data = assemble_csr_data(Ke.reshape(-1), slots, nnz, plan=plan)
        padded = torch.cat([data, data.new_zeros(1)])
        return (padded[slot_of] * x[ell_cols]).sum(0)

    example_args = (dom.vert_coords(),
                    torch.ones(dom.n_nodes, dtype=torch.float64,
                               device=dom.device))
    return step, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The device-resident end-to-end steps over n shards; prints one
    line a stage, as the JAX package does, and returns the counts
    {"poisson", "ns", "fsi", "fsi_tip", "solve"} (fsi keys for n >= 3)."""
    from feddlib_tpu_torch.bc import BCBuilder
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel import multihost
    from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline
    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.precond.gdsw import distributed_two_level

    axis = multihost.global_device_axis(n_devices, device)
    dev = axis.device
    counts = {}

    # ---- 1. Poisson, dedicated coarse shard, overlap-2 GDSW ----------------
    dom = Domain.structured(3, 6, device=dev)
    coarse_ranks = 1 if n_devices >= 4 else 0
    part = MeshPartition(dom.mesh, n_devices - coarse_ranks)
    pipe = DistributedPipeline(part, [(dom, 1)], n_free=coarse_ranks,
                               device=dev)
    pipe.add_block(0, 0, "laplace")
    pipe.finalize(axis)
    dmat = pipe.assemble()
    rhs = pipe.assemble_rhs({0: lambda x: 1.0 + 0 * x[0]})
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    dmask = np.asarray(bcb.dirichlet_mask(0, dom.n_nodes))
    dmat, rhs = pipe.apply_dirichlet(dmat, rhs, dmask, np.zeros(dom.n_nodes))
    build, arrs = distributed_two_level(
        dmat, part, dom.mesh.points, 1, dirichlet_mask=dmask,
        coarse_ranks=coarse_ranks, overlap=2)
    solver = DistributedSolver(dmat, axis)
    x, iters, relres = solver.solve(rhs, method="gmres", tol=1e-8,
                                    maxiter=200, precond=(build, arrs))
    assert relres <= 1e-8, f"Poisson pipeline did not converge: {relres}"
    counts["poisson"] = iters
    print(f"dryrun_multichip(n={n_devices}) Poisson: GDSW-GMRES "
          f"iters={iters}, relres={relres:.2e} OK")

    # ---- 2. Navier-Stokes Newton step, monolithic block-GDSW ---------------
    dom_p1 = Domain.structured(2, 5, device=dev)
    dom_u = dom_p1.p2_domain()
    part2 = MeshPartition(dom_p1.mesh, n_devices)
    pipe2 = DistributedPipeline(part2, [(dom_u, 2), (dom_p1, 1)],
                                device=dev)
    pipe2.add_block(0, 0, "stress", viscosity=0.1)
    pipe2.add_block(0, 0, "advection")
    pipe2.add_block(0, 0, "advection_in_u")
    pipe2.add_block(0, 1, "divergence_T")
    pipe2.add_block(1, 0, "divergence")
    pipe2.finalize(axis)
    # lid-driven cavity BCs: u = (1,0) on the boundary strip y=1, 0 elsewhere
    n_u, n_p = dom_u.n_dofs(2), dom_p1.n_dofs(1)
    bmask = np.zeros(n_u + n_p, dtype=bool)
    bnd = dom_u.mesh.point_flags > 0
    bmask[0: n_u: 2] = bnd
    bmask[1: n_u: 2] = bnd
    bmask[n_u] = True  # pin one pressure dof (pure-Dirichlet cavity)
    g = np.zeros(n_u + n_p)
    lid = bnd & np.isclose(dom_u.mesh.points[:, 1], 1.0)
    g[0: n_u: 2] = np.where(lid, 1.0, 0.0)
    # one Newton step around u=g (advection blocks at the current iterate)
    xk = pipe2.distribute(g)
    dmat2 = pipe2.assemble(x=xk)
    rhs2 = torch.zeros_like(xk)
    dmat2, rhs2 = pipe2.apply_dirichlet(dmat2, rhs2, bmask, g)
    build2, arrs2 = distributed_two_level(
        dmat2, dirichlet_mask=bmask, blocks=pipe2.block_specs())
    solver2 = DistributedSolver(dmat2, axis)
    x2, it2, rel2 = solver2.solve(rhs2, method="gmres", tol=1e-8,
                                  maxiter=300, precond=(build2, arrs2))
    assert rel2 <= 1e-8, f"NS pipeline did not converge: {rel2}"
    counts["ns"] = it2
    print(f"dryrun_multichip(n={n_devices}) NS block-GDSW: GMRES "
          f"iters={it2}, relres={rel2:.2e} OK")

    # ---- 2b. FSI GE step: multi-mesh pipeline (fluid + solid on disjoint
    # shard ranges, constant interface couplings, external mesh-velocity
    # field) — no global matrix anywhere ------------------------------------
    if n_devices >= 3:
        from feddlib_tpu_torch.parallel.spmd import distribute_vector
        from feddlib_tpu_torch.precond.facsi import distributed_facsi
        from feddlib_tpu_torch.problems.fsi import FSI
        from feddlib_tpu_torch.scenarios import IFACE_BOX, two_box
        from feddlib_tpu_torch.utils.config import ParameterList

        # the two-box of the JAX package's tests/test_fsi.py:24
        dom_uf, dom_pf, dom_ds, _ = two_box(3, dev)
        plf = ParameterList("P")
        for k, v in {"dt": 0.02, "Viscosity": 0.5, "E": 5.0}.items():
            plf[k] = v
        fsi = FSI(dom_uf, dom_pf, dom_ds, [IFACE_BOX], parameter_list=plf,
                  device=dev)
        fsi.assemble()
        fsi.init_vectors()
        pipe_f = fsi.build_pipeline(n_devices,
                                    solid_devices=max(1, n_devices // 3),
                                    axis=axis)
        dmat_f = fsi.assemble_distributed(pipe_f)
        solver_f = DistributedSolver(dmat_f, axis)
        rng = np.random.default_rng(0)
        bf = distribute_vector(rng.standard_normal(dmat_f.n_global),
                               pipe_f.dof_map, dmat_f.plan.N_o, axis=axis)
        # distributed FaCSI: per-field subdomain solves + interface
        # condensation (the production FSI preconditioner,
        # PrecOpFaCSI_decl.hpp:27)
        buildF, arrsF = distributed_facsi(
            dmat_f, pipe_f.offsets, fsi._uf_cols, fsi._ds_cols,
            fsi._iface_rows, fsi.dt, overlap=1)
        xf, itf, relf = solver_f.solve(bf, method="gmres", tol=1e-8,
                                       maxiter=200, restart=200,
                                       precond=(buildF, arrsF))
        assert relf <= 1e-8, f"FSI pipeline did not converge: {relf}"
        assert itf <= 60, f"FaCSI-preconditioned FSI took {itf} iters"
        counts["fsi"] = itf
        print(f"dryrun_multichip(n={n_devices}) FSI GE multi-mesh pipeline "
              f"(distributed FaCSI): GMRES iters={itf}, relres={relf:.2e} OK")

        # 2c. two pipeline-driven GE time steps: Newton Jacobians assemble
        # device-resident on the moved mesh, solves ride distributed FaCSI
        # (DAESolverInTime::advanceInTimeFSI, DAESolverInTime_def.hpp:726)
        plf["Use Distributed Solve"] = True
        plf["Devices"] = n_devices
        plf["Solid Devices"] = max(1, n_devices // 3)
        fsi.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        fsi.add_bc(lambda x, t: [0.0, 0.0], 1, 2)
        # rotational forcing (a gradient force would be absorbed into
        # hydrostatic pressure and produce zero motion)
        fsi.advance(2 * fsi.dt, source_f=lambda x, t: torch.stack(
            [-8.0 * (x[1] - 0.75), 8.0 * (x[0] - 0.5)]))
        tip = fsi.tip_displacement((0.5, 0.25))
        assert bool(torch.isfinite(fsi.solution.concat()).all())
        assert float(torch.linalg.norm(fsi.solution[2])) > 1e-5
        counts["fsi_tip"] = tuple(float(v) for v in tip)
        print(f"dryrun_multichip(n={n_devices}) FSI GE pipeline time loop: "
              f"2 steps OK, tip={counts['fsi_tip']}")

    # ---- 3. the user-facing path: Problem.solve() with
    # 'Use Distributed Solve' + 'Use Device Pipeline' ------------------------
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    pl = ParameterList("P")
    for k, v in {"Use Distributed Solve": True, "Devices": n_devices,
                 "Use Device Pipeline": True,
                 "Preconditioner Type": "SchwarzTwoLevel",
                 "Convergence Tolerance": 1e-8,
                 "Maximum Iterations": 300}.items():
        pl[k] = v
    dom3 = Domain.structured(2, 12, device=dev)
    prob = Laplace(dom3, 1, parameter_list=pl, device=dev)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    it3 = prob.solve()
    assert prob.last_relres <= 1e-8
    counts["solve"] = it3
    print(f"dryrun_multichip(n={n_devices}) Problem.solve pipeline: "
          f"GMRES iters={it3}, relres={prob.last_relres:.2e} OK")
    return counts


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = "cpu" if args.cpu else "cuda"
    f, ex = entry(dev)
    y = f(*ex)
    print("entry() forward step OK:", tuple(y.shape), float(y.sum()))
    dryrun_multichip(4, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
