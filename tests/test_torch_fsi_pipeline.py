"""The port's distributed FSI (feddlib_tpu_torch.problems.fsi with 'Use
Distributed Solve': the multi-mesh pipeline with disjoint fluid / solid
shard ranges and constant interface couplings, distributed FaCSI, the GE
and GI time loops) against the JAX package, on the scenarios of
tests/test_fsi_pipeline.py (the two-box of tests/test_fsi.py:24 at 3
cells a box, 6 shards of which 2 solid).

The plan arrays equal the JAX package's entry for entry and the shards
agree within 1e-12 of max |a|; the collected matrices equal the port's
serial Jacobians (the JAX tests' 1e-10 / 1e-9); every GMRES count equals
the JAX package's distributed run's, the Newton counts the port's serial
loop's, and the trajectories match the serial loop within the JAX tests'
rtol 1e-6, atol 1e-9.  Inputs come from numpy with a seed."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.parallel.solve import DistributedSolver as JSolver  # noqa: E402
from feddlib_tpu.parallel.spmd import distribute_vector as jdist  # noqa: E402
from feddlib_tpu.precond.facsi import distributed_facsi as jfacsi  # noqa: E402
from feddlib_tpu.problems.fsi import FSI as JFSI  # noqa: E402
from feddlib_tpu.solvers import linear as jlin  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.parallel.solve import DistributedSolver  # noqa: E402
from feddlib_tpu_torch.precond.facsi import distributed_facsi  # noqa: E402
from feddlib_tpu_torch.problems.fsi import FSI as TFSI  # noqa: E402
from feddlib_tpu_torch.problems.fsi import _interface_identity  # noqa: E402
from feddlib_tpu_torch.solvers import linear as tlin  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

from test_torch_fsi import IFACE, _two_box  # noqa: E402
from test_torch_pipeline import _collect, _same_matrix, _same_plans  # noqa: E402,E501

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _fsi(pkg, params):
    dom_u, dom_p, dom_d = _two_box(pkg, 3, 2)
    if pkg == "jax":
        prob = JFSI(dom_u, dom_p, dom_d, [IFACE],
                    parameter_list=JPL("P", dict(params)))
    else:
        prob = TFSI(dom_u, dom_p, dom_d, [IFACE],
                    parameter_list=TPL("P", dict(params)), device=CPU)
    prob.assemble()
    prob.init_vectors()
    return prob


def _vec(pkg, a):
    return jnp.asarray(a) if pkg == "jax" else torch.as_tensor(a)


@pytest.mark.parametrize("material", ["linear", "Neo-Hooke"])
def test_fsi_pipeline_matches_serial_jacobian(material):
    """The GE four-field Jacobian through the multi-mesh pipeline: the
    plans and shards of the JAX package, the port's serial Jacobian."""
    params = {"dt": 0.02, "Viscosity": 0.5, "Density Fluid": 1.2,
              "Density Solid": 2.0, "E": 5.0, "Material Model": material}
    out = {}
    for pkg in ("jax", "torch"):
        prob = _fsi(pkg, params)
        rng = np.random.default_rng(0)
        n_u = prob.block_sizes()[0]
        prob.solution[0] = _vec(pkg, 0.05 * rng.standard_normal(n_u))
        prob.solution[2] = _vec(pkg, 0.01 * rng.standard_normal(
            prob.block_sizes()[2]))
        w = 0.03 * rng.standard_normal(n_u)
        pipe = prob.build_pipeline(6, solid_devices=2)
        out[pkg] = (prob, pipe, prob.assemble_distributed(pipe, w=w), w)
    (_, jp, jd, _), (prob, tp, td, w) = out["jax"], out["torch"]
    _same_plans(jp, tp)
    _same_matrix(jd, td)
    # the port's serial Jacobian at the same state
    wt = torch.as_tensor(w)
    Pmat = tops.assemble_ale_divergence(prob.variables[0][0], wt).scale(
        -prob.density_f)
    prob._build_system("Newton", wt, 1.0 / prob.dt,
                       1.0 / (prob.newmark_beta * prob.dt ** 2), P=Pmat)
    S = prob.system.merge().to_scipy().tocsr()
    assert abs(S - _collect(td)).max() < 1e-10 * max(abs(S).max(), 1.0)


def _gi_state(pkg):
    """The GI problem at the seeded five-field state of
    tests/test_fsi_pipeline.py:77, its pipeline and assembled shards."""
    prob = _fsi(pkg, {"dt": 0.02, "Viscosity": 0.5, "Density Fluid": 1.2,
                      "Density Solid": 2.0, "E": 5.0})
    prob._gi = True
    prob.init_vectors()
    n_u = prob.block_sizes()[0]
    prob.solution.blocks.append(_vec(pkg, np.zeros(n_u)))
    rng = np.random.default_rng(3)
    prob.solution[0] = _vec(pkg, 0.05 * rng.standard_normal(n_u))
    prob.solution[1] = _vec(pkg, 0.05 * rng.standard_normal(
        prob.block_sizes()[1]))
    prob.solution[2] = _vec(pkg, 0.01 * rng.standard_normal(
        prob.block_sizes()[2]))
    g = 0.01 * rng.standard_normal(n_u)
    prob.solution[4] = _vec(pkg, g)
    gp = 0.005 * rng.standard_normal(n_u)
    u_old = 0.02 * rng.standard_normal(n_u)
    b = rng.standard_normal(sum(prob.block_sizes()))
    # the mesh moved to ref + g, as the serial GI reassembly leaves it
    dom_u = prob.variables[0][0]
    dom_u.mesh.points = dom_u.mesh.ref_points + g.reshape(-1, 2)
    dom_u.invalidate_geometry()
    pipe = prob.build_pipeline_gi(6, solid_devices=2)
    dmat = prob.assemble_distributed_gi(pipe, _vec(pkg, gp),
                                        _vec(pkg, u_old))
    return prob, pipe, dmat, (g, gp, u_old, b)


def test_fsi_gi_pipeline_matches_serial_jacobian():
    """The five-field GI Jacobian (the shape-derivative kinds
    differentiated inside the assembly around the reference configuration,
    the fluid blocks on moved coordinates, the geometry block with built-in
    Dirichlet rows) against the JAX package's shards and the port's serial
    GI assembly; then the five-field distributed FaCSI solve, its count
    the JAX package's."""
    from feddlib_tpu_torch.fe.shape_derivatives import \
        assemble_shape_derivative_blocks

    jprob, jp, jd, _ = _gi_state("jax")
    prob, tp, td, (g, gp, u_old, b) = _gi_state("torch")
    _same_plans(jp, tp)
    _same_matrix(jd, td)

    # the serial GI reassembly at the same state
    dt = prob.dt
    dom_u, dom_p = prob.variables[0][0], prob.variables[1][0]
    Lg_bc, _ = prob._gi_geometry_operator()
    prob._assemble_fluid_constant()
    w = torch.as_tensor((g - gp) / dt)
    Pmat = tops.assemble_ale_divergence(dom_u, w).scale(-prob.density_f)
    prob._build_system("Newton", w, 1.0 / dt,
                       1.0 / (prob.newmark_beta * dt * dt), P=Pmat)
    Dug, Dpg = assemble_shape_derivative_blocks(
        dom_u, dom_p, prob.solution[0], prob.solution[1], g, gp, u_old,
        prob.viscosity, prob.density_f, dt, 1.0 / dt)
    sizes = prob.block_sizes()
    S = prob.system
    S.add_block(0, 4, Dug)
    S.add_block(1, 4, Dpg)
    S.add_block(4, 4, Lg_bc)
    S.add_block(4, 2, _interface_identity(sizes[4], sizes[2], prob._uf_cols,
                                          prob._ds_cols, -1.0, CPU))
    S_sp = S.merge().to_scipy().tocsr()
    assert abs(S_sp - _collect(td)).max() < 1e-9 * max(abs(S_sp).max(), 1.0)

    # five-field FaCSI (the geometry stage, then the FaCSI order)
    xj, itj, _ = JSolver(jd, jp.axis).solve(
        jdist(b, jp.dof_map, jd.plan.N_o), method="gmres", tol=1e-9,
        maxiter=200, restart=200, precond=jfacsi(
            jd, jp.offsets, jprob._uf_cols, jprob._ds_cols,
            jprob._iface_rows, jprob.dt, overlap=1))
    x, it, rel = DistributedSolver(td, tp.axis).solve(
        tp.distribute(b), method="gmres", tol=1e-9, maxiter=200,
        restart=200, precond=distributed_facsi(
            td, tp.offsets, prob._uf_cols, prob._ds_cols, prob._iface_rows,
            dt, overlap=1))
    xg = tp.collect(x)
    assert it == itj and rel < 1e-8 and it <= 80
    assert np.linalg.norm(S_sp @ xg - b) / np.linalg.norm(b) < 1e-7
    np.testing.assert_allclose(xg, jp.collect(xj), atol=1e-9)


def _ge_system(pkg):
    """The GE system at rest (tests/test_fsi_pipeline.py:149): the pipeline,
    its shards and the seeded right-hand side."""
    prob = _fsi(pkg, {"dt": 0.02, "Viscosity": 0.5, "Density Fluid": 1.0,
                      "Density Solid": 1.0, "E": 5.0})
    pipe = prob.build_pipeline(6, solid_devices=2)
    dmat = prob.assemble_distributed(pipe)
    b = np.random.default_rng(1).standard_normal(int(pipe.offsets[-1]))
    return prob, pipe, dmat, b


def _serial_matrix(prob):
    n_u = prob.block_sizes()[0]
    prob._build_system("Newton", torch.zeros(n_u, dtype=torch.float64),
                       1.0 / prob.dt,
                       1.0 / (prob.newmark_beta * prob.dt ** 2))
    return prob.system.merge().to_scipy().tocsr()


def test_fsi_pipeline_distributed_facsi():
    """Distributed FaCSI (per-field subdomain solves and the interface
    condensation in one apply) on the GE system: the JAX package's count
    and solution, the true residual of the port's serial matrix."""
    jprob, jp, jd, b = _ge_system("jax")
    prob, tp, td, _ = _ge_system("torch")
    xj, itj, _ = JSolver(jd, jp.axis).solve(
        jdist(b, jp.dof_map, jd.plan.N_o), method="gmres", tol=1e-9,
        maxiter=200, restart=200, precond=jfacsi(
            jd, jp.offsets, jprob._uf_cols, jprob._ds_cols,
            jprob._iface_rows, jprob.dt, overlap=1))
    build = distributed_facsi(td, tp.offsets, prob._uf_cols, prob._ds_cols,
                              prob._iface_rows, prob.dt, overlap=1)
    x, it, rel = DistributedSolver(td, tp.axis).solve(
        tp.distribute(b), method="gmres", tol=1e-9, maxiter=200,
        restart=200, precond=build)
    xg = tp.collect(x)
    S = _serial_matrix(prob)
    assert it == itj and rel < 1e-8 and it <= 60
    assert np.linalg.norm(S @ xg - b) / np.linalg.norm(b) < 1e-7
    np.testing.assert_allclose(xg, jp.collect(xj), atol=1e-9)
    # a refresh on the same values reproduces the apply bit for bit
    fn, arrs = build
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (tp.n_dev, tp.N_o))) * td.plan.owned_mask
    M1 = DistributedSolver(td, tp.axis).operators(build)[1]
    M2 = DistributedSolver(td, tp.axis).operators((fn, fn.refresh(td)))[1]
    assert torch.equal(M1(r), M2(r))


def test_fsi_pipeline_distributed_solve_matches_serial():
    """The pipeline's GE system under unpreconditioned distributed GMRES:
    the JAX package's count, the true residual of the serial matrix."""
    _, jp, jd, b = _ge_system("jax")
    prob, tp, td, _ = _ge_system("torch")
    _, itj, _ = JSolver(jd, jp.axis).solve(
        jdist(b, jp.dof_map, jd.plan.N_o), method="gmres", tol=1e-9,
        maxiter=600, restart=600, precond=None)
    x, it, rel = DistributedSolver(td, tp.axis).solve(
        tp.distribute(b), method="gmres", tol=1e-9, maxiter=600,
        restart=600, precond=None)
    xg = tp.collect(x)
    S = _serial_matrix(prob)
    assert it == itj and rel < 1e-8
    assert np.linalg.norm(S @ xg - b) / np.linalg.norm(b) < 1e-7


def _loop(pkg, dist, mode):
    """Two time steps of the GE (with the rotational fluid forcing) or GI
    (with a seeded start impulse) loop: (Newton count a step, GMRES a
    Newton step, solution blocks, problem)."""
    d = {"dt": 0.02, "Viscosity": 0.5, "Density Fluid": 1.0,
         "Density Solid": 1.0, "E": 5.0, "Convergence Tolerance": 1e-10,
         "relNonLinTol": 1e-9}
    if dist:
        d.update({"Use Distributed Solve": True, "Devices": 6,
                  "Solid Devices": 2})
    prob = _fsi(pkg, d)
    if pkg == "jax":
        prob.add_bc(lambda x, t: np.zeros(2), 1, 0)
        prob.add_bc(lambda x, t: np.zeros(2), 1, 2)

        def source(x, t):
            return jnp.stack([-8.0 * (x[1] - 0.75), 8.0 * (x[0] - 0.5)])
    else:
        prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
        prob.add_bc(lambda x, t: [0.0, 0.0], 1, 2)

        def source(x, t):
            return torch.stack([-8.0 * (x[1] - 0.75), 8.0 * (x[0] - 0.5)])
    lin = jlin if pkg == "jax" else tlin
    log, newton = [], []
    orig = lin.LinearSolver.solve_system

    def counted(self, problem, b):
        x, it = orig(self, problem, b)
        log.append(it)
        return x, it

    lin.LinearSolver.solve_system = counted
    try:
        if mode == "GE":
            prob.advance(0.04, source_f=source,
                         observer=lambda t, s: newton.append(len(log)))
        else:
            u0 = 0.01 * np.random.default_rng(7).standard_normal(
                prob.block_sizes()[0])
            prob.solution[0] = _vec(pkg, u0)
            prob.advance_gi(0.04,
                            observer=lambda t, s: newton.append(len(log)))
    finally:
        lin.LinearSolver.solve_system = orig
    steps = list(np.diff([0] + newton))
    return steps, log, [_np(bk) for bk in prob.solution.blocks], prob


@pytest.mark.parametrize("mode", ["GE", "GI"])
def test_fsi_advance_distributed_matches_serial_trajectory(mode):
    """Two time steps with 'Use Distributed Solve': every Newton Jacobian
    assembles through the pipeline (moved meshes as vertex coordinates,
    the solution on its shard mirror) and solves with distributed FaCSI.
    GMRES counts equal the JAX package's distributed run's; Newton counts
    and the trajectory (all fields) the port's serial loop's."""
    j_steps, j_log, j_sol, _ = _loop("jax", True, mode)
    d_steps, d_log, d_sol, dprob = _loop("torch", True, mode)
    s_steps, _, s_sol, _ = _loop("torch", False, mode)
    assert d_log == j_log and d_steps == j_steps == s_steps
    assert float(np.linalg.norm(s_sol[2])) > (1e-4 if mode == "GE"
                                               else 1e-8)  # real motion
    for b in range(len(s_sol)):
        np.testing.assert_allclose(d_sol[b], s_sol[b], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(d_sol[b], j_sol[b], rtol=1e-6, atol=1e-9)
    cache = dprob._pipe_ge if mode == "GE" else dprob._pipe_gi
    assert cache["builds"] == 1  # one pipeline and FaCSI build for both
