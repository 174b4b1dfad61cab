"""The port's time integration slice (feddlib_tpu_torch: utils/checkpoint.py,
solvers/timestepping.py, problems/misc.py, and the deterministic CSR
assembly the resumed loops rely on) against the JAX package, on the
scenarios of tests/test_timestepping.py and test_tpm_blockprec.py.  Each
loop's final state agrees with the JAX package's within 1e-10 relative
(f64 Krylov solves to 1e-10 or tighter); a resumed run equals the
uninterrupted one bit for bit; checkpoints load across the two packages."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la.block import BlockVector as JBV  # noqa: E402
from feddlib_tpu.problems import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.problems import LinElas as JLinElas  # noqa: E402
from feddlib_tpu.problems import NavierStokes as JNS  # noqa: E402
from feddlib_tpu.problems import misc as jmisc  # noqa: E402
from feddlib_tpu.solvers import timestepping as jts  # noqa: E402
from feddlib_tpu.utils import checkpoint as jck  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la import csr as tcsr  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector as TBV  # noqa: E402
from feddlib_tpu_torch.problems import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.problems import LinElas as TLinElas  # noqa: E402
from feddlib_tpu_torch.problems import NavierStokes as TNS  # noqa: E402
from feddlib_tpu_torch.problems import misc as tmisc  # noqa: E402
from feddlib_tpu_torch.solvers import timestepping as tts  # noqa: E402
from feddlib_tpu_torch.utils import checkpoint as tck  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

RTOL = 1e-10


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


def _params(PL, **kw):
    p = PL("Parameters")
    for k, v in kw.items():
        p[k] = v
    return p


# -- the two packages side by side --------------------------------------------

J = dict(D=JDomain, PL=JPL, BV=JBV, Laplace=JLaplace, LinElas=JLinElas,
         NS=JNS, ts=jts, ops=jops, misc=jmisc, vec=jnp.asarray, kw={},
         lid=lambda x, t: jnp.where(jnp.isclose(x[1], 1.0),
                                    jnp.array([1.0, 0.0]), jnp.zeros(2)))
T = dict(D=TDomain, PL=TPL, BV=TBV, Laplace=TLaplace, LinElas=TLinElas,
         NS=TNS, ts=tts, ops=tops, misc=tmisc, vec=torch.as_tensor,
         kw={"device": "cpu"},
         lid=lambda x, t: torch.stack([
             torch.isclose(x[1], torch.tensor(1.0, dtype=x.dtype)).double(),
             0.0 * x[0]]))
PKGS = (J, T)


def _dom(P, dim, n):
    return P["D"].structured(dim, n, **P["kw"])


def _heat(P, n=8, tol=1e-10):
    """du/dt = Δu, u = 0 on the boundary, u0 the first eigenmode."""
    dom = _dom(P, 2, n)
    prob = P["Laplace"](dom, parameter_list=_params(
        P["PL"], **{"Preconditioner Type": "Jacobi",
                    "Maximum Iterations": 2000,
                    "Convergence Tolerance": tol}), **P["kw"])
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.init_vectors()
    pts = dom.mesh.points
    u0 = np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])
    prob.solution = P["BV"]([P["vec"](u0)])
    return dom, prob, u0


def _semidiscrete_exact(dom, prob, tp, u0, T_end):
    """exp(−M⁻¹K T) u0 on the free dofs (the test of the JAX package)."""
    import scipy.linalg as sla

    free = ~prob.bc_builder.dirichlet_mask(0, dom.n_nodes)
    K = prob.system.get_block(0, 0).to_scipy().toarray()[np.ix_(free, free)]
    M = tp.mass[0].to_scipy().toarray()[np.ix_(free, free)]
    uT = np.zeros_like(u0)
    uT[free] = sla.expm(-np.linalg.solve(M, K) * T_end) @ u0[free]
    return uT


def _sol(prob, b=0):
    v = prob.solution[b]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# -- tables ------------------------------------------------------------------------

def test_tables_match():
    """bdf_coefficients (tests/test_timestepping.py:40), the Butcher
    tables and the fractional-θ parameters."""
    for k in (1, 2, 3):
        assert tts.bdf_coefficients(k) == jts.bdf_coefficients(k)
        b0, al = tts.bdf_coefficients(k)
        assert np.isclose(sum(al), b0)
    assert tts.bdf_coefficients(2) == (1.5, [2.0, -0.5])
    for name in ("Euler", "ImplicitEuler", "CrankNicolson"):
        for a, b in zip(tts.butcher_table(name), jts.butcher_table(name)):
            np.testing.assert_array_equal(a, b)
    assert tts.fractional_theta_parameters() == \
        jts.fractional_theta_parameters()


# -- the heat equation: θ, BDF2, Crank–Nicolson, fractional θ, adaptive θ -------

@pytest.mark.parametrize("scheme", ["theta", "bdf2", "cn", "fractional"])
def test_heat_schemes(scheme):
    """tests/test_timestepping.py:66, :88 and :171: each scheme's
    convergence order against the semidiscrete exact solution in the port,
    and its state at both step sizes equal to the JAX package's."""
    T_end = 0.02
    steps = (8, 16) if scheme in ("theta", "bdf2") else (4, 8)
    errs = []
    for m in steps:
        out = []
        for P in PKGS:
            dom, prob, u0 = _heat(P)
            tp = P["ts"].TimeProblem(prob)
            drv = P["ts"].DAESolverInTime(
                tp, T_end / m, T_end, theta=0.5 if scheme == "cn" else 1.0)
            {"theta": drv.advance_linear_theta,
             "bdf2": lambda: drv.advance_linear_bdf(order=2),
             "cn": drv.advance_linear_theta,
             "fractional": drv.advance_linear_fractional_theta}[scheme]()
            out.append(_sol(prob))
        assert _rel(out[1], out[0]) < RTOL
        exact = _semidiscrete_exact(dom, prob, tp, u0, T_end)
        errs.append(np.abs(out[1] - exact).max())
    rate = np.log2(errs[0] / errs[1])
    # the JAX package's floors: order − 0.45 (θ = 1, BDF2), 1.6, 1.7
    floor = {"theta": 0.55, "bdf2": 1.55, "cn": 1.6, "fractional": 1.7}
    assert rate > floor[scheme], (errs, rate)


def test_adaptive_theta():
    """tests/test_timestepping.py:211: the step-doubling controller takes
    the JAX package's steps (within 1e-8: each step size is a power of an
    error estimate from Krylov solves to 1e-10) and reaches its state."""
    out, hist = [], []
    for P in PKGS:
        dom, prob, u0 = _heat(P)
        tp = P["ts"].TimeProblem(prob)
        drv = P["ts"].DAESolverInTime(tp, 0.001, 0.05, theta=0.5)
        drv.advance_linear_theta_adaptive(rel_tol=1e-5)
        out.append(_sol(prob))
        hist.append(drv.dt_history)
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-8)
    assert _rel(out[1], out[0]) < RTOL
    exact = _semidiscrete_exact(dom, prob, tp, u0, 0.05)
    assert np.abs(out[1] - exact).max() < 5e-4
    assert max(hist[1]) > 2 * 0.001


# -- Newmark and Navier–Stokes ----------------------------------------------------

def _vibrating(P, n=4):
    dom = _dom(P, 2, n)
    prob = P["LinElas"](dom, parameter_list=_params(
        P["PL"], E=1.0, **{"Poisson Ratio": 0.3,
                           "Preconditioner Type": "Jacobi",
                           "Maximum Iterations": 4000,
                           "Convergence Tolerance": 1e-12}), **P["kw"])
    prob.assemble()
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
    prob.init_vectors()
    pts = dom.mesh.points
    d0 = np.zeros((dom.n_nodes, 2))
    d0[:, 1] = 0.01 * np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])
    prob.solution = P["BV"]([P["vec"](d0.ravel())])
    return prob, d0.ravel()


def test_newmark_energy_conservation():
    """tests/test_timestepping.py:106: β = 1/4, γ = 1/2 Newmark conserves
    the energy within 2 %; d and v equal the JAX package's."""
    out = []
    for P in PKGS:
        prob, d0 = _vibrating(P)
        tp = P["ts"].TimeProblem(prob)
        drv = P["ts"].DAESolverInTime(tp, 0.05, 1.0)
        drv.advance_linear_newmark()
        v = drv.velocity[0]
        out.append((_sol(prob), np.asarray(v.numpy() if isinstance(
            v, torch.Tensor) else v)))
    assert _rel(out[1][0], out[0][0]) < RTOL
    assert _rel(out[1][1], out[0][1]) < RTOL
    K = prob.system.get_block(0, 0).to_scipy()
    M = tp.mass[0].to_scipy()
    d, v = out[1]
    E0 = 0.5 * d0 @ (K @ d0)
    assert abs(0.5 * d @ (K @ d) + 0.5 * v @ (M @ v) - E0) / E0 < 0.02


def _cavity(P):
    dom_p = _dom(P, 2, 4)
    dom_u = dom_p.p2_domain()
    prob = P["NS"](dom_u, dom_p, parameter_list=_params(
        P["PL"], Viscosity=0.1, **{"Preconditioner Type": "Jacobi",
                                   "Maximum Iterations": 4000,
                                   "Convergence Tolerance": 1e-11}),
        **P["kw"])
    prob.assemble()
    prob.add_bc(P["lid"], 1, 0)
    dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
    dom_p.mesh.point_flags[0] = 77
    prob.bc_builder.add_bc(lambda x, t: 0.0, 77, 1, dom_p, "Dirichlet", 1)
    return prob


@pytest.mark.parametrize("loop", ["nonlinear_bdf", "extrapolation"])
def test_unsteady_navier_stokes(loop):
    """tests/test_timestepping.py:143 (Newton inside BDF2) and :189 (the
    semi-implicit extrapolation loop, one linear solve a step): the
    started lid-driven flow develops, and u, p equal the JAX package's."""
    out = []
    for P in PKGS:
        prob = _cavity(P)
        tp = P["ts"].TimeProblem(prob, time_step_def=[1, 0])
        drv = P["ts"].DAESolverInTime(tp, 0.05, 0.2)
        if loop == "nonlinear_bdf":
            drv.advance_nonlinear_bdf(order=2)
        else:
            drv.advance_navier_stokes_extrapolation()
        out.append((_sol(prob, 0), _sol(prob, 1)))
    u = out[1][0].reshape(-1, 2)
    assert np.isfinite(u).all() and np.abs(u).max() > 0.1
    assert _rel(out[1][0], out[0][0]) < 1e-8
    # the pinned pressure makes p unique: compare it too
    assert _rel(out[1][1], out[0][1]) < 1e-8


# -- checkpoints --------------------------------------------------------------------

def _ck_problem(P):
    dom = _dom(P, 2, 4)
    prob = P["Laplace"](dom, parameter_list=_params(
        P["PL"], **{"Preconditioner Type": "Jacobi",
                    "Maximum Iterations": 4000,
                    "Convergence Tolerance": 1e-12}), **P["kw"])
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.init_vectors()
    f = P["ops"].assemble_rhs(dom, lambda x: 1.0 + 0 * x[0])
    return prob, (lambda t: P["BV"]([f * min(t, 1.0)]))


def _run(P, scheme, t_end, **kw):
    prob, rhs = _ck_problem(P)
    drv = P["ts"].DAESolverInTime(P["ts"].TimeProblem(prob), 0.1, t_end,
                                  theta=1.0, rhs_func=rhs, **kw)
    getattr(drv, f"advance_linear_{scheme}")()
    return _sol(prob)


@pytest.mark.parametrize("scheme", ["bdf", "newmark", "theta"])
def test_checkpoint_resume_exactness(tmp_path, scheme):
    """tests/test_timestepping.py:227 in the port, held bit for bit:
    checkpoint at t = 0.5, resume in a fresh DAESolverInTime and problem,
    finish; the trajectory equals the uninterrupted run exactly.  Then the
    same resume from a checkpoint the JAX package wrote, and the JAX
    package resuming from the port's, against the uninterrupted runs."""
    ref_t = _run(T, scheme, 1.0)
    ref_j = _run(J, scheme, 1.0)
    assert _rel(ref_t, ref_j) < RTOL
    ck_t = os.path.join(tmp_path, f"{scheme}_t.npz")
    ck_j = os.path.join(tmp_path, f"{scheme}_j.npz")
    _run(T, scheme, 0.5, checkpoint_path=ck_t)
    _run(J, scheme, 0.5, checkpoint_path=ck_j)
    np.testing.assert_array_equal(_run(T, scheme, 1.0, resume_from=ck_t),
                                  ref_t)
    assert _rel(_run(T, scheme, 1.0, resume_from=ck_j), ref_t) < RTOL
    assert _rel(_run(J, scheme, 1.0, resume_from=ck_t), ref_j) < RTOL


@pytest.mark.parametrize("writer,reader", [(tck, tck), (tck, jck),
                                           (jck, tck)])
def test_checkpoint_roundtrip(tmp_path, writer, reader):
    """tests/test_tpm_blockprec.py's round trip, within and across the
    packages: blocks, time, aux and meta come back exactly."""
    blocks = [np.arange(5.0), np.ones(3)]
    sol = (TBV([torch.as_tensor(b) for b in blocks]) if writer is tck
           else JBV([jnp.asarray(b) for b in blocks]))
    path = str(tmp_path / "ck.npz")
    writer.save_checkpoint(path, sol, 0.75, aux={"v": np.zeros(5)},
                           meta={"dt": 0.01})
    kw = {"device": "cpu"} if reader is tck else {}
    sol2, t, aux, meta = reader.load_checkpoint(path, **kw)
    assert t == 0.75 and meta["dt"] == 0.01 and aux["v"].shape == (5,)
    for a, b in zip(sol2.blocks, blocks):
        if reader is tck:
            assert isinstance(a, torch.Tensor) and a.dtype == torch.float64
        np.testing.assert_array_equal(np.asarray(a), b)
    assert [f for f in os.listdir(tmp_path) if "tmp" in f] == []


# -- problems/misc.py ---------------------------------------------------------------

def test_laplace_blocks():
    """tests/test_tpm_blockprec.py:122 in the port: two decoupled Laplace
    blocks solve to 1e-8 with equal blocks, equal to the JAX package's."""
    out = []
    for P in PKGS:
        prob = P["misc"].LaplaceBlocks(_dom(P, 2, 6), parameter_list=_params(
            P["PL"], **{"Preconditioner Type": "Jacobi",
                        "Maximum Iterations": 2000}), **P["kw"])
        prob.assemble()
        prob.assemble_source(lambda x: 1.0 + 0 * x[0])
        prob.add_bc(lambda x, t: 0.0, 1, 0)
        prob.add_bc(lambda x, t: 0.0, 1, 1)
        prob.set_boundaries_rhs()
        prob.solve()
        assert prob.last_relres <= 1e-8
        np.testing.assert_allclose(_sol(prob, 0), _sol(prob, 1), atol=1e-10)
        out.append(_sol(prob, 0))
    assert _rel(out[1], out[0]) < 1e-7


def test_lin_elas_first_order_and_identity():
    """LinElasFirstOrder's blocks [[0, −M], [K, 0]] and _identity_csr
    against the JAX package's."""
    pj = jmisc.LinElasFirstOrder(JDomain.structured(2, 3))
    pt = tmisc.LinElasFirstOrder(TDomain.structured(2, 3, device="cpu"),
                                 device="cpu")
    pj.assemble()
    pt.assemble()
    assert sorted(pt.system.blocks) == sorted(pj.system.blocks) == [
        (0, 1), (1, 0)]
    for ij in ((0, 1), (1, 0)):
        a, b = pt.system.get_block(*ij), pj.system.get_block(*ij)
        np.testing.assert_array_equal(a.pattern.indices, b.pattern.indices)
        assert _rel(a.data.numpy(), b.data) < 1e-12
    It = tmisc._identity_csr(7, device="cpu")
    np.testing.assert_array_equal(It.to_scipy().toarray(),
                                  jmisc._identity_csr(7).to_scipy().toarray())


# -- the deterministic assembly of the card, run here on the CPU ---------------------

@pytest.mark.parametrize("force_sorted", [False, True])
def test_planned_assembly_matches_index_add(force_sorted):
    """The card's assembly route (la/csr.py assemble_planned: scatter-set
    through the duplication plan, or the slot-sorted segmented sum where
    the plan is None) on the CPU: equal to index_add_ to 1e-14 relative,
    repeatable bit for bit; the duplication plan equals the JAX
    package's."""
    from feddlib_tpu.fe import fast_assembly as jfa

    from feddlib_tpu_torch.fe import fast_assembly as tfa

    pt = tfa.pattern_abe(TDomain.structured(3, 4, device="cpu"), 1)
    pj = jfa.pattern_abe(JDomain.structured(3, 4), 1)
    (pos_t, Dp_t), (pos_j, Dp_j) = pt.duplication_plan(), pj.duplication_plan()
    assert Dp_t == Dp_j
    np.testing.assert_array_equal(pos_t, np.asarray(pos_j))
    if force_sorted:
        object.__setattr__(pt, "_dup_plan", (None, 0))
    plan = pt._device_plan(torch.device("cpu"))
    assert plan[0] == ("sorted" if force_sorted else "set")
    vals = torch.as_tensor(np.random.default_rng(0).standard_normal(
        len(pt.coo_slots)))
    ref = torch.zeros(pt.nnz, dtype=torch.float64).index_add_(
        0, torch.as_tensor(pt.coo_slots), vals)
    a = tcsr.assemble_planned(vals, plan, pt.nnz)
    b = tcsr.assemble_planned(vals, plan, pt.nnz)
    assert torch.equal(a, b)
    assert _rel(a.numpy(), ref.numpy()) < 1e-14
    idx = torch.as_tensor(pt.coo_slots)
    assert torch.equal(tcsr.scatter_sum(vals, idx, pt.nnz), ref)
