"""The port's Newton Navier–Stokes slice (feddlib_tpu_torch: the CSR and BC
algebra of a Newton loop, the advection / divergence / stabilization
element operators, Stokes, NavierStokes, NonLinearSolver and the block
preconditioners) against the JAX package, on the scenarios of
tests/test_assembly.py, test_problems.py, test_tpm_blockprec.py and
test_goldens.py.  Assembled matrices agree within 1e-12 relative in f64;
Newton and GMRES iteration counts agree exactly (±2 GMRES iterations on
the mixed-precision path, whose inner sums are f32); solutions within
1e-7."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la.block import BlockVector as JBV  # noqa: E402
from feddlib_tpu.problems import NavierStokes as JNS  # noqa: E402
from feddlib_tpu.problems import Stokes as JStokes  # noqa: E402
from feddlib_tpu.solvers.nonlinear import NonLinearSolver as JNLS  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la import csr as tcsr  # noqa: E402
from feddlib_tpu_torch.problems import NavierStokes as TNS  # noqa: E402
from feddlib_tpu_torch.problems import Stokes as TStokes  # noqa: E402
from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver as TNLS  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same_csr(Kt, Kj):
    assert np.array_equal(Kt.pattern.indptr, Kj.pattern.indptr)
    assert np.array_equal(Kt.pattern.indices, Kj.pattern.indices)
    assert Kt.data.dtype == torch.float64
    assert _rel(Kt.data.numpy(), np.asarray(Kj.data)) < RTOL


def _spaces(dim, n):
    """(u, p) spaces P2/P1 in both packages."""
    pj, pt = JDomain.structured(dim, n), TDomain.structured(dim, n,
                                                            device="cpu")
    return pj.p2_domain(), pj, pt.p2_domain(), pt


# -- assembly and algebra --------------------------------------------------------

@pytest.mark.parametrize("dim,n,fe", [(2, 3, "P2"), (2, 4, "P1"),
                                      (3, 2, "P2"), (3, 3, "P1")])
def test_velocity_operators_match(dim, n, fe):
    """The convection N(u), the Newton term W(u) and the stress form at a
    random velocity field."""
    dj = JDomain.structured(dim, n, fe_type=fe)
    dt = TDomain.structured(dim, n, fe_type=fe, device="cpu")
    u = np.random.default_rng(3).standard_normal(dj.n_dofs(dim))
    _same_csr(tops.assemble_advection(dt, torch.as_tensor(u)),
              jops.assemble_advection(dj, jnp.asarray(u)))
    _same_csr(tops.assemble_advection_in_u(dt, torch.as_tensor(u)),
              jops.assemble_advection_in_u(dj, jnp.asarray(u)))
    _same_csr(tops.assemble_stress(dt, 0.7), jops.assemble_stress(dj, 0.7))
    ue = tops.u_elem_values(dt, torch.as_tensor(u)).numpy()
    assert np.array_equal(ue, np.asarray(jops.u_elem_values(dj,
                                                            jnp.asarray(u))))


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 2)])
def test_divergence_and_stabilization_match(dim, n):
    """B, Bᵀ (P2/P1 and P1/P1) and the Bochev–Dohrmann block, plus the
    anchors tests/test_assembly.py:103 (B of a constant field is zero) and
    :117 (N(u) of a constant field is zero)."""
    duj, dpj, dut, dpt = _spaces(dim, n)
    for (uj, ut) in ((duj, dut), (dpj, dpt)):
        Bt, BTt = tops.assemble_divergence(ut, dpt)
        Bj, BTj = jops.assemble_divergence(uj, dpj)
        _same_csr(Bt, Bj)
        _same_csr(BTt, BTj)
        assert Bt.shape == (dpt.n_nodes, ut.n_dofs(dim))
        c = torch.zeros(ut.n_dofs(dim), dtype=torch.float64)
        c[0::dim] = 3.0
        c[1::dim] = -2.0
        assert float(Bt.matvec(c).abs().max()) < 1e-12
        assert float(tops.assemble_advection(ut, c).matvec(c).abs().max()) \
            < 1e-12
    _same_csr(tops.assemble_bd_stabilization(dpt),
              jops.assemble_bd_stabilization(dpj))
    with pytest.raises(ValueError, match="sharing one mesh"):
        tops.assemble_divergence(
            dut, TDomain.structured(dim, n, device="cpu"))


def test_csr_algebra_matches():
    """scale, add (same pattern, and the cached symbolic union of two
    patterns) and transpose."""
    import scipy.sparse as sps

    from feddlib_tpu.la.csr import CsrMatrix as JCsr

    duj, dpj, dut, dpt = _spaces(2, 3)
    u = np.random.default_rng(5).standard_normal(duj.n_dofs(2))
    Aj, At = jops.assemble_laplace_vec(duj), tops.assemble_laplace_vec(dut)
    Nj = jops.assemble_advection(duj, jnp.asarray(u))
    Nt = tops.assemble_advection(dut, torch.as_tensor(u))
    _same_csr(At.scale(-2.5), Aj.scale(-2.5))
    _same_csr(At.add(Nt, 0.5, 2.0), Aj.add(Nj, 0.5, 2.0))
    Bt, _ = tops.assemble_divergence(dut, dpt)
    Bj, _ = jops.assemble_divergence(duj, dpj)
    _same_csr(Bt.transpose(), Bj.transpose())
    # two different patterns: the union is built once and then reused
    D = (sps.diags(np.arange(1.0, At.shape[0] + 1.0)) * 3.0).tocsr()
    Dt = tcsr.CsrMatrix.from_scipy(D, device="cpu")
    Ct = At.add(Dt, 2.0, -1.0)
    _same_csr(Ct, Aj.add(JCsr.from_scipy(D), 2.0, -1.0))
    assert Ct.pattern is not At.pattern
    assert At.add(Dt).pattern is Ct.pattern
    assert tcsr._union_pattern_cache[(id(At.pattern), id(Dt.pattern))][2] \
        is Ct.pattern


def test_newton_bc_helpers_match():
    """set_vector_minus_bc, set_bc_minus_vector and zero_dirichlet on a
    two-block vector, and the identity diagonal block apply_to_system adds
    for a pinned pressure dof."""
    def build(D, S, PL, lid, **kw):
        dom_p = D.structured(2, 4, **kw)
        prob = S(dom_p.p2_domain(), dom_p, parameter_list=PL("p", {}), **kw)
        prob.assemble()
        prob.add_bc(lid, 1, 0)
        dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
        dom_p.mesh.point_flags[0] = 77
        prob.bc_builder.add_bc(lambda x, t: 0.5, 77, 1, dom_p, "Dirichlet", 1)
        return prob

    pj = build(JDomain, JStokes, JPL, _lid_j(2))
    pt = build(TDomain, TStokes, TPL, _lid_t(2), device="cpu")
    rng = np.random.default_rng(11)
    r = [rng.standard_normal(s) for s in pj.block_sizes()]
    u = [rng.standard_normal(s) for s in pj.block_sizes()]
    rj, uj = JBV([jnp.asarray(a) for a in r]), JBV([jnp.asarray(a)
                                                    for a in u])
    rt = convert.block_vector_from_numpy(r, device="cpu")
    ut = convert.block_vector_from_numpy(u, device="cpu")
    bj, bt = pj.bc_builder, pt.bc_builder
    for got, want in ((bt.set_vector_minus_bc(rt, ut),
                       bj.set_vector_minus_bc(rj, uj)),
                      (bt.set_bc_minus_vector(rt, ut),
                       bj.set_bc_minus_vector(rj, uj)),
                      (bt.zero_dirichlet(rt), bj.zero_dirichlet(rj))):
        for a, b in zip(got.blocks, want.blocks):
            assert _rel(a.numpy(), b) < RTOL
    sj, st = pj.bc_system(), pt.bc_system()
    assert sorted(st.blocks) == sorted(sj.blocks) and (1, 1) in st.blocks
    _same_csr(st.get_block(1, 1), sj.get_block(1, 1))
    _same_csr(st.merge(), sj.merge())


# -- problems ------------------------------------------------------------------

def _lid_j(dim):
    e0 = jnp.zeros(dim).at[0].set(1.0)
    return lambda x, t: jnp.where(jnp.isclose(x[dim - 1], 1.0), e0,
                                  jnp.zeros(dim))


def _lid_t(dim):
    def lid(x, t):
        on = torch.isclose(x[dim - 1], torch.tensor(1.0, dtype=x.dtype))
        return torch.stack([on.double()] + [0.0 * x[0]] * (dim - 1))
    return lid


def _params(PL, **kw):
    return PL("P", {k.replace("_", " "): v for k, v in kw.items()})


def _cavity(D, P, PL, params, lid, dim=2, n=6, pin=True, **kw):
    dom_p = D.structured(dim, n, **kw)
    prob = P(dom_p.p2_domain(), dom_p, parameter_list=_params(PL, **params),
             **kw)
    prob.assemble()
    prob.add_bc(lid, 1, 0)
    if pin:  # pin the pressure's constant mode at node 0
        dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
        dom_p.mesh.point_flags[0] = 77
        prob.bc_builder.add_bc(lambda x, t: 0.0, 77, 1, dom_p, "Dirichlet", 1)
    return prob


def test_stokes_driver():
    """tests/test_problems.py:71: P2/P1 Stokes cavity, 'SchwarzOneLevel'
    on 2 subdomains."""
    params = {"Viscosity": 1.0, "Preconditioner Type": "SchwarzOneLevel",
              "Subdomains": 2, "Maximum Iterations": 2000}
    pj = _cavity(JDomain, JStokes, JPL, params, _lid_j(2))
    pt = _cavity(TDomain, TStokes, TPL, params, _lid_t(2), device="cpu")
    for p in (pj, pt):
        p.set_boundaries_rhs()
    it_j, it_t = pj.solve(), pt.solve()
    assert pt.last_relres <= 1e-8 and it_t == it_j
    u = pt.solution[0].numpy()
    assert _rel(u, pj.solution[0]) < 1e-7
    assert u.reshape(-1, 2)[:, 0].min() < -1e-3  # the flow circulates
    Bu = pt.system.get_block(1, 0).matvec(pt.solution[0])
    assert float(Bu.abs().max()) < 1e-6


@pytest.mark.parametrize("method,params", [
    ("Newton", {"Viscosity": 0.1, "Preconditioner_Type": "SchwarzOneLevel",
                "Subdomains": 2, "Maximum Iterations": 2000,
                "Cancel_MaxNonLinIts": True}),
    ("FixedPoint", {"Viscosity": 0.5, "Preconditioner_Type": "Jacobi",
                    "Maximum Iterations": 4000, "MaxNonLinIts": 20}),
], ids=["newton", "fixed-point"])
def test_navier_stokes_nonlinear(method, params):
    """tests/test_problems.py:107 (Newton) and :134 (fixed point): the same
    nonlinear counts as the JAX package, and per step the same GMRES count
    — within 2 % for the fixed point, whose Jacobi-preconditioned GMRES(100)
    takes about 2,000 iterations a step and drifts with the order of the
    f64 sums (the JAX test holds only the final criterion there)."""
    n = 6 if method == "Newton" else 5
    pj = _cavity(JDomain, JNS, JPL, params, _lid_j(2), n=n)
    pt = _cavity(TDomain, TNS, TPL, params, _lid_t(2), n=n, device="cpu")
    sj, st = JNLS(method), TNLS(method)
    its_j, its_t = sj.solve(pj), st.solve(pt)
    assert its_t == its_j
    slack = 0.0 if method == "Newton" else 0.02
    assert all(abs(a - b) <= slack * b
               for a, b in zip(st.linear_iters, sj.linear_iters)), \
        (st.linear_iters, sj.linear_iters)
    assert st.final_criterion <= 1e-6
    assert abs(st.final_criterion - sj.final_criterion) \
        <= 1e-6 * sj.final_criterion + 1e-14
    u = pt.solution[0].numpy()
    assert _rel(u, pj.solution[0]) < 1e-7
    assert u.reshape(-1, 2)[:, 0].min() < -1e-3
    Fj = pj.surface_forces([1])
    assert np.abs(pt.surface_forces([1]) - np.asarray(Fj)).max() \
        < 1e-7 * max(np.abs(np.asarray(Fj)).max(), 1.0)


def test_newton_step_from_jax_iterate():
    """One Newton step of both packages from the same iterate (the JAX
    package's after one step, carried over), with the update criterion,
    WRMS and the AND combination on."""
    params = {"Viscosity": 0.1, "Preconditioner_Type": "SchwarzTwoLevel",
              "Subdomains": 4, "Convergence Tolerance": 1e-10,
              "MaxNonLinIts": 1, "Criterion": "Update", "Use_WRMS": True,
              "Combo": "AND"}
    pj = _cavity(JDomain, JNS, JPL, params, _lid_j(2))
    pt = _cavity(TDomain, TNS, TPL, params, _lid_t(2), device="cpu")
    JNLS("Newton").solve(pj)
    convert.newton_state_from_numpy(pt, np.array(pj.solution[0]),
                                    np.array(pj.solution[1]))
    assert _rel(pt.calculate_residual().concat().numpy(),
                pj.calculate_residual().concat()) < 1e-10
    sj, st = JNLS("Newton"), TNLS("Newton")
    assert st.solve(pt) == sj.solve(pj) == 1
    assert st.linear_iters == sj.linear_iters
    assert abs(st.final_criterion - sj.final_criterion) \
        <= 1e-6 * sj.final_criterion
    for a, b in zip(pt.solution.blocks, pj.solution.blocks):
        assert _rel(a.numpy(), b) < 1e-7


def test_block_preconditioners_stokes():
    """tests/test_tpm_blockprec.py:60: the diagonal, triangular and SIMPLE
    block preconditioners, each with the JAX package's GMRES count."""
    from feddlib_tpu.precond import block_prec as jbp
    from feddlib_tpu.solvers.krylov import gmres as jgmres

    from feddlib_tpu_torch.precond import block_prec as tbp
    from feddlib_tpu_torch.solvers.krylov import gmres as tgmres

    def build(P, PL, lid, bp, xp, **kw):
        D = TDomain if kw else JDomain
        prob = _cavity(D, P, PL, {"Viscosity": 1.0}, lid, **kw)
        prob.set_boundaries_rhs()
        sysb = prob.bc_system()
        Auu = sysb.get_block(0, 0)
        dA = Auu.diagonal()
        dAi = xp.where(dA != 0, 1.0 / xp.where(dA == 0, 1.0, dA), 0.0 * dA)
        inv_A = lambda r: dAi * r  # noqa: E731
        n_u = prob.block_sizes()[0]
        inv_S = bp.pressure_mass_inverse(prob.pressure_mass_matrix(), 1.0)
        B, BT = sysb.get_block(1, 0), sysb.get_block(0, 1)
        precs = [bp.BlockDiagonalPreconditioner(n_u, inv_A, inv_S),
                 bp.BlockTriangularPreconditioner(n_u, inv_A, inv_S, BT),
                 bp.SimplePreconditioner(
                     n_u, inv_A, bp.schur_diag_inverse(Auu, B, BT), B, BT,
                     dAi)]
        return sysb.merge(), prob.rhs.concat(), precs

    Aj, bj, Pj = build(JStokes, JPL, _lid_j(2), jbp, jnp)
    At, bt, Pt = build(TStokes, TPL, _lid_t(2), tbp, torch, device="cpu")
    r = np.random.default_rng(2).standard_normal(bt.shape[0])
    for mj, mt in zip(Pj, Pt):
        assert _rel(mt.apply(torch.as_tensor(r)).numpy(),
                    mj.apply(jnp.asarray(r))) < RTOL
        rj = jgmres(Aj.matvec, bj, M=mj.apply, tol=1e-8, maxiter=3000,
                    restart=200)
        rt = tgmres(At.matvec, bt, M=mt.apply, tol=1e-8, maxiter=3000,
                    restart=200)
        assert rt.converged and rt.iters == rj.iters
    lumped = tbp.pressure_mass_inverse(
        tops.assemble_mass(TDomain.structured(2, 3, device="cpu")), 2.0,
        lumped=False)
    assert float(lumped(torch.ones(16, dtype=torch.float64)).min()) > 0


# the 3D cavity goldens of tests/test_goldens.py:71 (f64, deterministic
# partitions)
NEWTON_3D_CAVITY = 3
GMRES_3D_CAVITY = [22, 23, 22]
KE_3D_CAVITY = 0.07462684304806966


def test_golden_3d_navier_stokes_anchor():
    """tests/test_goldens.py:71: the 3D lid-driven cavity, P2/P1 Newton with
    the monolithic two-level GDSW on two fields — Newton 3, GMRES
    [22, 23, 22] ±2, kinetic energy to rtol 1e-6."""
    params = {"Viscosity": 0.1, "Density": 1.0,
              "Preconditioner_Type": "SchwarzTwoLevel", "Subdomains": 4,
              "Convergence_Tolerance": 1e-9, "Maximum_Iterations": 2000,
              "relNonLinTol": 1e-8, "MaxNonLinIts": 12}
    prob = _cavity(TDomain, TNS, TPL, params, _lid_t(3), dim=3, n=3,
                   pin=False, device="cpu")
    solver = TNLS("Newton")
    its = solver.solve(prob)
    assert its == NEWTON_3D_CAVITY
    lins = solver.linear_iters
    assert len(lins) == its
    assert all(abs(a - b) <= 2 for a, b in zip(lins, GMRES_3D_CAVITY)), lins
    u = prob.solution[0].numpy().reshape(-1, 3)
    ke = 0.5 * float((u ** 2).sum()) / len(u)
    assert np.isclose(ke, KE_3D_CAVITY, rtol=1e-6), ke


def test_mixed_precision_newton_reuses_preconditioner():
    """tests/test_problems.py:285 on Domain.structured(2, 6): mixed-precision
    Newton (the balance=True cluster branch, B1–B3's plain versions here)
    with the operator refreshed through with_data and the Schwarz level
    reused, against full rebuilds and the JAX package's iterate."""
    def run(D, P, PL, lid, reuse, **kw):
        params = {"Preconditioner_Type": "SchwarzOneLevel", "Clusters": 8,
                  "Use_Mixed_Precision": True, "Reuse_Preconditioner": reuse,
                  "Viscosity": 0.05}
        prob = _cavity(D, P, PL, params, lid, pin=False, **kw)
        solver = (TNLS if kw else JNLS)("Newton")
        its = solver.solve(prob)
        return prob, its, solver

    lid_j = lambda x, t: jnp.stack(  # noqa: E731
        [jnp.where(x[1] > 1 - 1e-9, 1.0, 0.0), 0.0 * x[0]])
    lid_t = lambda x, t: torch.stack(  # noqa: E731
        [(x[1] > 1 - 1e-9).double(), 0.0 * x[0]])
    pj, its_j, _ = run(JDomain, JNS, JPL, lid_j, True)
    out = {}
    for reuse in (True, False):
        pt, its_t, st = run(TDomain, TNS, TPL, lid_t, reuse, device="cpu")
        assert st.final_criterion <= 1e-6
        out[reuse] = pt.solution[0].numpy()
        if reuse:
            assert its_t == its_j
            assert np.abs(out[reuse] - np.asarray(pj.solution[0])).max() \
                < 2e-6
            assert pt._mixed_cache["db32"].P == 8
    np.testing.assert_allclose(out[True], out[False], atol=2e-6)


def test_slice_entry_points_default_to_cuda():
    import inspect

    from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU
    from feddlib_tpu_torch.problems import NonLinearProblem

    for fn in (TStokes.__init__, TNS.__init__, NonLinearProblem.__init__,
               BatchedSparseLU.__init__, convert.block_vector_from_numpy,
               convert.schwarz_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        dom_p = TDomain.structured(2, 2, device="cpu")
        for P in (TStokes, TNS):
            with pytest.raises(RuntimeError, match="cuda"):
                P(dom_p.p2_domain(), dom_p)
