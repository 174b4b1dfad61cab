"""'Use Device Pipeline' and the pipeline-assembled solves of the port
against the JAX package, on the solve scenarios of tests/test_pipeline.py:
Laplace through Problem.solve, Newton Navier–Stokes, the pipeline's
Stokes system under the monolithic block GDSW, overlap-2 Schwarz, the
device-RHS heat loop, TPM consolidation and hyperelastic Newton.

Every count (GMRES a solve, Newton a step) must equal the JAX package's
pipeline run's and the port's own distributed run without the pipeline
(the assembled system split into shards); solutions agree within the JAX
tests' tolerances.  The port stacks its shards on the CPU.  Inputs come
from numpy with a seed."""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def blas1():
    """Host LAPACK single-threaded under the JAX package's factor thread
    pool (the port pins its own)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(a, b, rtol):
    a, b = _np(a), _np(b)
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1.0), \
        np.abs(a - b).max()


RUNS = ("jax", "pipe", "dist")  # JAX pipeline, port pipeline, port split


def _opts(run, base):
    d = dict(base, **{"Use Distributed Solve": True, "Devices": 4,
                      "Use Device Pipeline": run != "dist"})
    return JPL("P", d) if run == "jax" else TPL("P", d)


def _laplace(run):
    if run == "jax":
        from feddlib_tpu.problems.laplace import Laplace
        dom = JDomain.structured(2, 16)
        kw = {}
    else:
        from feddlib_tpu_torch.problems.laplace import Laplace
        dom = TDomain.structured(2, 16, device=CPU)
        kw = {"device": CPU}
    prob = Laplace(dom, 1, parameter_list=_opts(run, {
        "Preconditioner Type": "SchwarzTwoLevel", "Overlap": 1,
        "Convergence Tolerance": 1e-9, "Maximum Iterations": 500}), **kw)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def test_use_device_pipeline_laplace():
    """Problem.solve() through the device-resident chain: the count of the
    JAX pipeline run and of the port's split-shard run; a second solve
    reuses the pipeline and its preconditioner, bitwise."""
    out = {}
    for run in RUNS:
        prob = _laplace(run)
        out[run] = (prob.solve(), _np(prob.solution[0]))
        if run == "pipe":
            pc, pp = prob._pipe_cache, prob._pipe_prec
            its2 = prob.solve()
            assert prob._pipe_cache is pc and prob._pipe_prec is pp
            assert its2 == out[run][0]
            assert np.array_equal(_np(prob.solution[0]), out[run][1])
    assert out["pipe"][0] == out["jax"][0] == out["dist"][0]
    _close(out["pipe"][1], out["jax"][1], 1e-9)
    _close(out["pipe"][1], out["dist"][1], 1e-9)


def _ns(run):
    base = {"Viscosity": 0.05, "Density": 1.0,
            "Preconditioner Type": "SchwarzTwoLevel", "Subdomains": 4,
            "Convergence Tolerance": 1e-9, "Maximum Iterations": 2000,
            "relNonLinTol": 1e-8, "MaxNonLinIts": 12}
    if run == "jax":
        from feddlib_tpu.problems import NavierStokes
        from feddlib_tpu.solvers.nonlinear import NonLinearSolver
        dom_p = JDomain.structured(2, 6)
        prob = NavierStokes(dom_p.p2_domain(), dom_p,
                            parameter_list=_opts(run, base))

        def lid(x, t):
            on = jnp.isclose(x[1], 1.0)
            return jnp.where(on, jnp.array([1.0, 0.0]), jnp.zeros(2))
    else:
        from feddlib_tpu_torch.problems import NavierStokes
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver
        dom_p = TDomain.structured(2, 6, device=CPU)
        prob = NavierStokes(dom_p.p2_domain(), dom_p,
                            parameter_list=_opts(run, base), device=CPU)

        def lid(x, t):
            on = torch.isclose(x[1], torch.ones_like(x[1]))
            return torch.stack([on.double(), 0.0 * x[0]])
    prob.assemble()
    prob.add_bc(lid, 1, 0)
    solver = NonLinearSolver("Newton")
    its = solver.solve(prob)
    return prob, its, list(solver.linear_iters)


def test_use_device_pipeline_navier_stokes_newton():
    """Newton on the cavity through the pipeline: each reassembly re-runs
    the assembly on the solution's shards (one upload of the solution in
    all; the others are the Newton right-hand sides)."""
    out = {}
    for run in RUNS:
        prob, its, lin = _ns(run)
        out[run] = (its, lin, _np(prob.solution[0]))
        if run != "dist":
            assert prob._pipe_cache["pipe"].n_distributes == 1 + its
    assert out["pipe"][:2] == out["jax"][:2] == out["dist"][:2]
    _close(out["pipe"][2], out["jax"][2], 1e-6)
    _close(out["pipe"][2], out["dist"][2], 1e-8)


def _stokes_pipe(pkg):
    """The lid-driven P2/P1 Stokes cavity assembled through the pipeline,
    its Dirichlet rows eliminated (tests/test_pipeline.py:233)."""
    if pkg == "jax":
        from feddlib_tpu.mesh.partition import MeshPartition as Part
        from feddlib_tpu.parallel.pipeline import DistributedPipeline as Pipe
        from feddlib_tpu.parallel.spmd import DeviceAxis
        dom_p1 = JDomain.structured(2, 8)
        axis = DeviceAxis.make(4)
    else:
        from feddlib_tpu_torch.mesh.partition import MeshPartition as Part
        from feddlib_tpu_torch.parallel.pipeline import \
            DistributedPipeline as Pipe
        from feddlib_tpu_torch.parallel.spmd import DeviceAxis
        dom_p1 = TDomain.structured(2, 8, device=CPU)
        axis = DeviceAxis.make(4, CPU)
    dom_u = dom_p1.p2_domain()
    n_u, n_p = dom_u.n_dofs(2), dom_p1.n_dofs(1)
    pipe = Pipe(Part(dom_p1.mesh, 4), [(dom_u, 2), (dom_p1, 1)])
    pipe.add_block(0, 0, "stress", viscosity=1.0)
    pipe.add_block(0, 1, "divergence_T")
    pipe.add_block(1, 0, "divergence")
    pipe.finalize(axis)
    bnd = dom_u.mesh.point_flags > 0
    bmask = np.zeros(n_u + n_p, dtype=bool)
    bmask[0:n_u:2] = bnd
    bmask[1:n_u:2] = bnd
    bmask[n_u] = True
    g = np.zeros(n_u + n_p)
    lid = bnd & np.isclose(dom_u.mesh.points[:, 1], 1.0)
    g[0:n_u:2] = np.where(lid, 1.0, 0.0)
    zeros = (jnp.zeros((4, pipe.N_o)) if pkg == "jax"
             else torch.zeros(4, pipe.N_o, dtype=torch.float64))
    dmat, rhs = pipe.apply_dirichlet(pipe.assemble(), zeros, bmask, g)
    return pipe, dmat, rhs, bmask


def test_pipeline_stokes_block_gdsw_distributed():
    """The pipeline's Stokes system under the monolithic block GDSW: the
    count equals the JAX package's and the port's split-shard run of the
    same system (the shards built from the collected global matrix)."""
    from feddlib_tpu.parallel.solve import DistributedSolver as JSolver
    from feddlib_tpu.precond.gdsw import distributed_two_level as jtl

    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.parallel.spmd import DistributedCsr
    from feddlib_tpu_torch.precond.gdsw import distributed_two_level
    from feddlib_tpu_torch.utils import convert

    jp, jd, jr, bmask = _stokes_pipe("jax")
    xj, itj, _ = JSolver(jd, jp.axis).solve(
        jr, method="gmres", tol=1e-8, maxiter=500,
        precond=jtl(jd, dirichlet_mask=bmask, blocks=jp.block_specs()))
    tp, td, tr, _ = _stokes_pipe("torch")
    xt, itt, rel = DistributedSolver(td, tp.axis).solve(
        tr, method="gmres", tol=1e-8, maxiter=500,
        precond=distributed_two_level(td, dirichlet_mask=bmask,
                                      blocks=tp.block_specs()))
    # the split-shard run: the same system assembled globally
    from test_torch_pipeline import _collect

    sp = _collect(td)
    A = convert.csr_from_numpy(sp.indptr, sp.indices, sp.data, sp.shape,
                               device=CPU)
    ds = DistributedCsr(A, tp.dof_map)
    xs, its, _ = DistributedSolver(ds, tp.axis).solve(
        tp.distribute(tp.collect(tr)), method="gmres", tol=1e-8,
        maxiter=500, precond=distributed_two_level(
            ds, dirichlet_mask=bmask, blocks=tp.block_specs()))
    assert itt == itj == its and rel < 1e-8
    n_u = int(tp.offsets[1])
    x1, x2, x3 = tp.collect(xt), jp.collect(xj), tp.collect(xs)
    # the pressure block leaves O(1e-6) slack at relres 1e-8
    np.testing.assert_allclose(x1[:n_u], x2[:n_u], atol=1e-7)
    np.testing.assert_allclose(x1[n_u:], x2[n_u:], atol=1e-4)
    np.testing.assert_allclose(x1, x3, atol=1e-9)


@pytest.mark.parametrize("combine", ["Restricted", "Averaging"])
def test_pipeline_overlap2_schwarz(combine):
    """Overlap-2 Schwarz (its own halo plan beyond the SpMV column map) on
    the pipeline's Poisson system: the JAX package's count, the split-
    shard run's count, and not worse than overlap 1."""
    from feddlib_tpu.mesh.partition import MeshPartition as JPart
    from feddlib_tpu.parallel.pipeline import DistributedPipeline as JPipe
    from feddlib_tpu.parallel.solve import DistributedSolver as JSolver
    from feddlib_tpu.parallel.spmd import DeviceAxis as JAxis
    from feddlib_tpu.precond.schwarz import distributed_schwarz as jds

    from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart
    from feddlib_tpu_torch.parallel.pipeline import \
        DistributedPipeline as TPipe
    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.parallel.spmd import DeviceAxis, DistributedCsr
    from feddlib_tpu_torch.precond.schwarz import distributed_schwarz
    from feddlib_tpu_torch.utils import convert
    from test_torch_pipeline import _collect

    def src(x):
        return 1.0 + 0 * x[0]

    jdom = JDomain.structured(2, 16)
    mask = np.zeros(jdom.n_nodes, bool)
    mask[jdom.mesh.point_flags == 1] = True
    jp = JPipe(JPart(jdom.mesh, 8), [(jdom, 1)])
    jp.add_block(0, 0, "laplace")
    jp.finalize(JAxis.make(8))
    jd, jr = jp.apply_dirichlet(jp.assemble(), jp.assemble_rhs({0: src}),
                                mask, np.zeros(jdom.n_nodes))
    xj, itj, _ = JSolver(jd, jp.axis).solve(
        jr, method="gmres", tol=1e-8, maxiter=500,
        precond=jds(jd, overlap=2, combine=combine))

    tdom = TDomain.structured(2, 16, device=CPU)
    tp = TPipe(TPart(tdom.mesh, 8), [(tdom, 1)])
    tp.add_block(0, 0, "laplace")
    tp.finalize(DeviceAxis.make(8, CPU))
    td, tr = tp.apply_dirichlet(tp.assemble(), tp.assemble_rhs({0: src}),
                                mask, np.zeros(tdom.n_nodes))
    solver = DistributedSolver(td, tp.axis)
    xt, itt, _ = solver.solve(tr, method="gmres", tol=1e-8, maxiter=500,
                              precond=distributed_schwarz(
                                  td, overlap=2, combine=combine))
    _, it1, _ = solver.solve(tr, method="gmres", tol=1e-8, maxiter=500,
                             precond=distributed_schwarz(
                                 td, overlap=1, combine=combine))
    sp = _collect(td)
    ds = DistributedCsr(convert.csr_from_numpy(
        sp.indptr, sp.indices, sp.data, sp.shape, device=CPU), tp.dof_map)
    xs, its, _ = DistributedSolver(ds, tp.axis).solve(
        tr, method="gmres", tol=1e-8, maxiter=500,
        precond=distributed_schwarz(ds, overlap=2, combine=combine))
    assert itt == itj == its and itt <= it1
    np.testing.assert_allclose(tp.collect(xt), jp.collect(xj), atol=1e-9)
    np.testing.assert_allclose(tp.collect(xt), tp.collect(xs), atol=1e-9)


def _heat(pkg):
    """Implicit-Euler heat loop driven on the device (tests/test_pipeline.
    py:492): pipeline matrix, the time-dependent source by the device RHS
    program, the history term a distributed SpMV of a mass pipeline,
    distributed CG; no host↔device vector traffic inside the loop."""
    dt, n_parts = 0.05, 4
    if pkg == "jax":
        import jax
        from jax.sharding import PartitionSpec as P

        from feddlib_tpu.bc import BCBuilder
        from feddlib_tpu.mesh.partition import MeshPartition as Part
        from feddlib_tpu.parallel.pipeline import DistributedPipeline as Pipe
        from feddlib_tpu.parallel.solve import DistributedSolver as Solver
        from feddlib_tpu.parallel.spmd import AXIS
        from feddlib_tpu.parallel.spmd import DistributedCsr as DC
        dom = JDomain.structured(2, 8)
        where, zeros = jnp.where, jnp.zeros
        axis_arg = {}
    else:
        from feddlib_tpu_torch.bc import BCBuilder
        from feddlib_tpu_torch.mesh.partition import MeshPartition as Part
        from feddlib_tpu_torch.parallel.pipeline import \
            DistributedPipeline as Pipe
        from feddlib_tpu_torch.parallel.solve import DistributedSolver as \
            Solver
        from feddlib_tpu_torch.parallel.spmd import DistributedCsr as DC
        dom = TDomain.structured(2, 8, device=CPU)
        axis_arg = {"device": CPU}

    def f(x, t):  # t is traced in the JAX program, a float in the port's
        if pkg == "jax":
            return jnp.sin(2.0 * x[0]) * jnp.cos(1.0 + 3.0 * t)
        return torch.sin(2.0 * x[0]) * math.cos(1.0 + 3.0 * t)

    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    dmask = np.asarray(bcb.dirichlet_mask(0, dom.n_nodes))
    part = Part(dom.mesh, n_parts)
    pipe = Pipe(part, [(dom, 1)], **axis_arg)
    pipe.add_block(0, 0, "laplace")
    pipe.add_block(0, 0, "mass", coeff=1.0 / dt)
    pipe.add_rhs(0, f)
    pipe.finalize()
    dmat, _ = pipe.apply_dirichlet(pipe.assemble(), None, dmask)
    solver = Solver(dmat, pipe.axis)
    pipeM = Pipe(part, [(dom, 1)], **axis_arg)
    pipeM.add_block(0, 0, "mass", coeff=1.0 / dt)
    pipeM.finalize(pipe.axis)
    dM = pipeM.assemble()
    m_dist, _ = pipe.dirichlet_arrays(dmask)
    if pkg == "jax":
        imp = dM.plan.importer()

        def prog(xo, ed, ec, himp):
            xo, ed, ec = xo[0], ed[0], ec[0]
            himp = jax.tree.map(lambda a: a[0], himp)
            return DC.local_matvec(ed, ec, imp(xo, himp))[None]

        fM = jax.jit(pipe.axis.shard_map(prog, (P(AXIS),) * 4, P(AXIS)))

        def mv(u):
            return fM(u, dM.ell_data, dM.ell_cols, dM.plan.import_arrays)
        u = zeros((pipe.n_dev, dmat.plan.N_o))
    else:
        imp = dM.plan.importer()

        def mv(u):
            return DC.local_matvec(dM.ell_data, dM.ell_cols,
                                   imp(u, dM.plan.import_arrays))
        u = torch.zeros(pipe.n_dev, dmat.plan.N_o, dtype=torch.float64)
        where = torch.where
    pipe.n_distributes = 0
    iters = []
    for k in range(3):
        t = (k + 1) * dt
        b = pipe.assemble_rhs_device(t=t) + mv(u)
        b = where(m_dist > 0, 0.0, b)
        u, it, _ = solver.solve(b, method="cg", tol=1e-12, maxiter=2000)
        iters.append(it)
    assert pipe.n_distributes == 0
    return pipe.collect(u), iters, dom, dmask


def test_unsteady_heat_distributed_device_rhs():
    import scipy.sparse.linalg as spla

    from feddlib_tpu_torch.fe import ops

    u_j, it_j, _, _ = _heat("jax")
    u_t, it_t, dom, dmask = _heat("torch")
    assert it_t == it_j
    # the serial implicit-Euler trajectory
    dt = 0.05
    K, M = ops.assemble_laplace(dom), ops.assemble_mass(dom)
    As = M.scale(1.0 / dt).add(K).to_scipy().tolil()
    As[dmask] = 0.0
    for i in np.flatnonzero(dmask):
        As[i, i] = 1.0
    As, Ms = As.tocsc(), M.to_scipy()
    u = np.zeros(dom.n_nodes)
    for k in range(3):
        t = (k + 1) * dt
        b = ops.assemble_rhs(dom, lambda x, tt=t: torch.sin(2.0 * x[0])
                             * np.cos(1.0 + 3.0 * tt)).numpy()
        rhs = Ms @ u / dt + b
        rhs[dmask] = 0.0
        u = spla.spsolve(As, rhs)
    _close(u_t, u, 1e-8)
    _close(u_t, u_j, 1e-10)


def _tpm(run):
    base = {"dt": 0.05, "Preconditioner Type": "SchwarzOneLevel",
            "Subdomains": 4, "Convergence Tolerance": 1e-10,
            "Maximum Iterations": 3000}
    if run == "jax":
        from feddlib_tpu.problems.tpm import TPM
        dom_p1 = JDomain.structured(2, 4)
        prob = TPM(dom_p1.p2_domain(), dom_p1,
                   parameter_list=_opts(run, base))
        prob.assemble()
        prob.add_bc(lambda x, t: jnp.zeros(2), 1, 0)
        prob.assemble_source(lambda x: jnp.array([0.0, -1.0]))
    else:
        from feddlib_tpu_torch.problems.tpm import TPM
        dom_p1 = TDomain.structured(2, 4, device=CPU)
        prob = TPM(dom_p1.p2_domain(), dom_p1,
                   parameter_list=_opts(run, base), device=CPU)
        prob.assemble()
        prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        prob.assemble_source(lambda x: [0.0, -1.0])
    prob.add_bc(lambda x, t: 0.0, 3, 1)
    iters, solve = [], prob.solve

    def counted():
        iters.append(solve())
        return iters[-1]

    prob.solve = counted
    # the load enters each step as f_ext (advance's step right-hand side
    # starts from the history terms alone)
    prob.advance(t_end=0.1, f_ext=prob.rhs.copy())
    return iters, _np(prob.solution.concat())


def test_tpm_consolidation_device_pipeline():
    """TPM consolidation with 'Use Device Pipeline': the Biot system
    assembled on the shards each step; counts and trajectory against the
    JAX pipeline run and the split-shard run."""
    out = {run: _tpm(run) for run in RUNS}
    assert np.abs(out["pipe"][1]).max() > 1e-3  # a loaded consolidation
    assert out["pipe"][0] == out["jax"][0] == out["dist"][0]
    _close(out["pipe"][1], out["jax"][1], 1e-6)
    _close(out["pipe"][1], out["dist"][1], 1e-9)


def _hyper(run):
    base = {"E": 5.0, "Poisson Ratio": 0.3, "Material Model": "Neo-Hooke",
            "Preconditioner Type": "SchwarzOneLevel", "Subdomains": 4,
            "Convergence Tolerance": 1e-11, "Maximum Iterations": 3000,
            "relNonLinTol": 1e-9, "MaxNonLinIts": 15}
    if run == "jax":
        from feddlib_tpu.problems.nonlin_elasticity import NonLinElasticity
        from feddlib_tpu.solvers.nonlinear import NonLinearSolver
        prob = NonLinElasticity(JDomain.structured(2, 4),
                                parameter_list=_opts(run, base))
        prob.assemble()
        prob.add_bc(lambda x, t: jnp.zeros(2), 1, 0)
        prob.assemble_source(lambda x: jnp.array([0.0, -0.4]))
    else:
        from feddlib_tpu_torch.problems.nonlin_elasticity import \
            NonLinElasticity
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver
        prob = NonLinElasticity(TDomain.structured(2, 4, device=CPU),
                                parameter_list=_opts(run, base), device=CPU)
        prob.assemble()
        prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        prob.assemble_source(lambda x: [0.0, -0.4])
    solver = NonLinearSolver("Newton")
    its = solver.solve(prob)
    return its, list(solver.linear_iters), _np(prob.solution[0])


def test_hyperelastic_newton_device_pipeline():
    """Neo-Hooke Newton with 'Use Device Pipeline': the consistent tangent
    assembled on the shards from the current iterate."""
    out = {run: _hyper(run) for run in RUNS}
    assert out["pipe"][:2] == out["jax"][:2] == out["dist"][:2]
    _close(out["pipe"][2], out["jax"][2], 1e-6)
    _close(out["pipe"][2], out["dist"][2], 1e-9)
