"""Linear elasticity in the PyTorch port (feddlib_tpu_torch) against the JAX
package: the vector-field assembly (same sparsity pattern, values within
1e-12 relative — the element sums run in another order), the loads, and
the slice as a whole — `LinElas` solved with Jacobi through the f64 Krylov
path and with the mixed-precision two-level solver with the rigid-body
null space (same refinement passes, iterations within ±2, solutions within
1e-7: the inner loop is f32)."""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import assembly as jasm  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.problems import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.problems import LinElas as JLinElas  # noqa: E402
from feddlib_tpu.solvers import refinement as jref  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import assembly as tasm  # noqa: E402
from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.fe.host_assembly import host_lin_elasticity_p1  # noqa: E402
from feddlib_tpu_torch.la.csr import CsrMatrix  # noqa: E402
from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary  # noqa: E402
from feddlib_tpu_torch.problems import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.problems import LinElas as TLinElas  # noqa: E402
from feddlib_tpu_torch.solvers.linear import LinearSolver  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

RTOL = 1e-12
DOMAINS = [(2, 6, "P1"), (2, 4, "P2"), (3, 4, "P1"), (3, 2, "P2")]


@pytest.fixture
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


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same_csr(Kt, Kj):
    assert np.array_equal(Kt.pattern.indptr, Kj.pattern.indptr)
    assert np.array_equal(Kt.pattern.indices, Kj.pattern.indices)
    assert Kt.data.dtype == torch.float64
    assert _rel(Kt.data.numpy(), np.asarray(Kj.data)) < RTOL


def _domains(dim, n, fe):
    return (JDomain.structured(dim, n, fe_type=fe),
            TDomain.structured(dim, n, fe_type=fe, device="cpu"))


# -- (a) assembly ------------------------------------------------------------

@pytest.mark.parametrize("dim,n,fe", DOMAINS)
def test_lin_elasticity_csr_matches(dim, n, fe):
    dj, dt = _domains(dim, n, fe)
    _same_csr(tops.assemble_lin_elasticity(dt, 37.0, 11.0),
              jops.assemble_lin_elasticity(dj, 37.0, 11.0))


@pytest.mark.parametrize("dim,n,fe", DOMAINS)
def test_laplace_vec_csr_matches(dim, n, fe):
    dj, dt = _domains(dim, n, fe)
    _same_csr(tops.assemble_laplace_vec(dt, 0.7),
              jops.assemble_laplace_vec(dj, 0.7))


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("dim,n,fe", DOMAINS)
def test_mass_csr_matches(dim, n, fe, vector):
    dj, dt = _domains(dim, n, fe)
    d = dim if vector else 1
    _same_csr(tops.assemble_mass(dt, d), jops.assemble_mass(dj, d))


@pytest.mark.parametrize("dim,fe", [(2, "P2"), (3, "P1")])
def test_elem_lin_elasticity_matches(dim, fe):
    dj, dt = _domains(dim, 3, fe)
    Ej = jasm.elem_lin_elasticity(dj.vert_coords(), dim, fe, 2.0, 3.0)
    Et = tasm.elem_lin_elasticity(dt.vert_coords(), dim, fe, 2.0, 3.0)
    assert tuple(Et.shape) == tuple(Ej.shape) and Et.shape[-2:] == (dim, dim)
    assert _rel(Et.numpy(), Ej) < RTOL
    Vj = jasm.vectorize_elem_mat(Ej)
    Vt = tasm.vectorize_elem_mat(Et)
    assert tuple(Vt.shape) == tuple(Vj.shape)
    assert _rel(Vt.numpy(), Vj) < RTOL


@pytest.mark.parametrize("dim,n", [(2, 8), (3, 4)])
def test_host_elasticity_matches_fe_path(dim, n):
    dt = TDomain.structured(dim, n, device="cpu")
    K = tops.assemble_lin_elasticity(dt, 37.0, 11.0).to_scipy().tocsr()
    K.sort_indices()
    Kh = host_lin_elasticity_p1(dt, 37.0, 11.0)
    Kh.sort_indices()
    assert K.nnz == Kh.nnz
    assert np.array_equal(K.indices, Kh.indices)
    assert abs(K - Kh).max() / abs(Kh).max() < RTOL


@pytest.mark.parametrize("dim,n,fe", DOMAINS)
def test_vector_rhs_matches(dim, n, fe):
    dj, dt = _domains(dim, n, fe)
    if dim == 2:
        fj = lambda x: jnp.stack([1.0 + x[0] * x[1], -0.1 + 0 * x[0]])
        ft = lambda x: [1.0 + x[0] * x[1], -0.1]
    else:
        fj = lambda x: jnp.stack([x[2], 1.0 + x[0] * x[1], -0.1 + 0 * x[0]])
        ft = lambda x: torch.stack([x[2], 1.0 + x[0] * x[1],
                                    -0.1 + 0 * x[0]])
    bj = jops.assemble_rhs(dj, fj, dim)
    bt = tops.assemble_rhs(dt, ft, dim)
    assert bt.dtype == torch.float64 and bt.shape[0] == dt.n_dofs(dim)
    assert _rel(bt.numpy(), bj) < RTOL
    with pytest.raises(ValueError):
        tops.assemble_rhs(dt, lambda x: [1.0], dim)


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("dim,n,fe", DOMAINS)
def test_surface_rhs_matches(dim, n, fe, vector):
    dj, dt = _domains(dim, n, fe)
    if vector:
        gj = lambda x: jnp.stack([x[0] * x[1]] + [1.0 + 0 * x[0]] * (dim - 1))
        gt = lambda x: [x[0] * x[1]] + [1.0] * (dim - 1)
        d = dim
    else:
        gj = gt = lambda x: 1.0 + x[0] * x[1]
        d = 1
    sj = jops.assemble_surface_rhs(dj, gj, 1, d)
    st = tops.assemble_surface_rhs(dt, gt, 1, d)
    assert float(st.abs().max()) > 0
    assert _rel(st.numpy(), sj) < RTOL
    assert float(tops.assemble_surface_rhs(dt, gt, 99, d).abs().max()) == 0


# -- problem layer -----------------------------------------------------------

def _linelas(D, L, PL, dom_args, params, load, clamp_flag=1, **kw):
    dom = D.structured(*dom_args, **kw)
    if clamp_flag != 1:  # clamp the x = 0 face only
        dim = dom.mesh.dim
        flag_boxed_boundary(dom.mesh, [0.0] * dim, [1.0] * dim,
                            {"x0": clamp_flag})
    prob = L(dom, parameter_list=PL("P", dict(params)), **kw)
    prob.assemble()
    prob.assemble_source(load)
    prob.add_bc(lambda x, t: 0.0, clamp_flag, 0)
    prob.set_boundaries_rhs()
    return prob


def test_linelas_bc_system_matches():
    """LinElas.assemble → assemble_source → surface load → add_bc (vector
    Dirichlet data) → set_boundaries_rhs gives the same row-masked system
    and rhs in both packages."""
    pj = JLinElas(JDomain.structured(3, 3))
    pt = TLinElas(TDomain.structured(3, 3, device="cpu"), device="cpu")
    assert (pt.mu, pt.lam) == (pj.mu, pj.lam)
    assert pt.pipeline_blocks() == pj.pipeline_blocks()
    pj.assemble()
    pt.assemble()
    pj.assemble_source(lambda x: jnp.array([0.0, 0.0, -0.1]))
    pt.assemble_source(lambda x: [0.0, 0.0, -0.1])
    pj.assemble_surface_source(lambda x: jnp.stack([x[0], 0 * x[0], 0 * x[0]]),
                               1)
    pt.assemble_surface_source(lambda x: [x[0], 0.0, 0.0], 1)
    pj.add_bc(lambda x, t: jnp.array([0.01, 0.0, 0.02]) * x[0], 1, 0)
    pt.add_bc(lambda x, t: torch.stack([0.01 * x[0], 0 * x[0], 0.02 * x[0]]),
              1, 0)
    pj.set_boundaries_rhs()
    pt.set_boundaries_rhs()
    _same_csr(pt.bc_system().get_block(0, 0), pj.bc_system().get_block(0, 0))
    assert _rel(pt.rhs[0].numpy(), pj.rhs[0]) < RTOL
    assert np.array_equal(pt.merged_dirichlet_mask(),
                          pj.merged_dirichlet_mask())
    _same_csr(pt.mass_matrix(), pj.mass_matrix())


def test_constant_vector_dirichlet_data():
    """A BC function may return one constant per component."""
    vals = {}
    for name, fn in (("const", lambda x, t: torch.tensor([0.5, -1.0])),
                     ("list", lambda x, t: [0.5, -1.0]),
                     ("field", lambda x, t: torch.stack(
                         [0.5 + 0 * x[0], -1.0 + 0 * x[0]]))):
        pt = TLinElas(TDomain.structured(2, 4, device="cpu"), device="cpu")
        pt.assemble()
        pt.add_bc(fn, 1, 0)
        pt.set_boundaries_rhs()
        vals[name] = pt.rhs[0].numpy()
    assert np.array_equal(vals["const"], vals["field"])
    assert np.array_equal(vals["list"], vals["field"])
    assert set(np.unique(vals["field"])) == {-1.0, 0.0, 0.5}


def test_vector_laplace_problem_matches():
    pj = JLaplace(JDomain.structured(2, 5), dofs_per_node=2)
    pt = TLaplace(TDomain.structured(2, 5, device="cpu"), dofs_per_node=2,
                  device="cpu")
    pj.assemble()
    pt.assemble()
    _same_csr(pt.system.get_block(0, 0), pj.system.get_block(0, 0))


# -- (e) the slice as a whole ------------------------------------------------

def test_linelas_jacobi_solve_matches_jax():
    """The tests/test_problems.py::test_linelas_driver scenario: 2D, all
    boundary nodes clamped, downward load, Jacobi-preconditioned GMRES
    through the f64 branch."""
    params = {"E": 1.0, "Poisson Ratio": 0.3,
              "Preconditioner Type": "Jacobi"}
    pj = _linelas(JDomain, JLinElas, JPL, (2, 8), params,
                  lambda x: jnp.array([0.0, -0.1]))
    pt = _linelas(TDomain, TLinElas, TPL, (2, 8), params,
                  lambda x: [0.0, -0.1], device="cpu")
    it_j, it_t = pj.solve(), pt.solve()
    assert pj.last_relres <= 1e-8 and pt.last_relres <= 1e-8
    assert abs(it_t - it_j) <= 2
    u = pt.solution[0].numpy()
    assert np.abs(u - np.asarray(pj.solution[0])).max() < 1e-7
    assert u.reshape(-1, 2)[:, 1].min() < 0  # sags under the downward load
    # on the CPU the A-apply stays the ELL one, as on the JAX CPU backend
    A = pt.bc_system().get_block(0, 0)
    assert LinearSolver()._auto_format_operator(A, pt, pt.parameter_list) \
        is None


@pytest.mark.parametrize("prec_type,method", [("None", "gmres"),
                                              ("Jacobi", "cg")])
def test_linelas_f64_branch_variants(prec_type, method):
    """'Preconditioner Type' None and the CG method reach 1e-8 with the
    JAX package's iteration counts (±2)."""
    params = {"Preconditioner Type": prec_type, "Solver Type": method}
    load_j = lambda x: jnp.array([0.0, -0.1])
    pj = _linelas(JDomain, JLinElas, JPL, (2, 6), params, load_j)
    pt = _linelas(TDomain, TLinElas, TPL, (2, 6), params,
                  lambda x: [0.0, -0.1], device="cpu")
    if method == "cg":  # CG needs the symmetric system: clamp by elimination
        for p in (pj, pt):
            K = p.system.get_block(0, 0)
            Kb, bb = p.bc_builder.apply_symmetric(K, p.rhs[0], 0)
            p.system.add_block(0, 0, Kb)
            p.rhs[0] = bb
    it_j, it_t = pj.solve(), pt.solve()
    assert pt.last_relres <= 1e-8
    assert abs(it_t - it_j) <= 2
    assert np.abs(pt.solution[0].numpy()
                  - np.asarray(pj.solution[0])).max() < 1e-7


def test_schwarz_types_still_raise():
    """The Schwarz types are ported: 'SchwarzTwoLevel' with the elasticity
    null space solves LinElas to 1e-8 in the JAX package's iteration
    count.  'FaCSI' (ported with the FSI slice) acts on the four GE fields
    of an FSI problem only, and says so on a one-field problem."""
    params = {"Preconditioner Type": "SchwarzTwoLevel", "Subdomains": 4,
              "Null Space Type": "Elasticity"}
    pj = _linelas(JDomain, JLinElas, JPL, (2, 6), params,
                  lambda x: jnp.array([0.0, -0.1]))
    pt = _linelas(TDomain, TLinElas, TPL, (2, 6), params,
                  lambda x: [0.0, -0.1], device="cpu")
    it_j, it_t = pj.solve(), pt.solve()
    assert pt.last_relres <= 1e-8 and it_t == it_j
    assert np.abs(pt.solution[0].numpy()
                  - np.asarray(pj.solution[0])).max() < 1e-7
    pt.parameter_list["Preconditioner Type"] = "FaCSI"
    pt._prec_stale = True
    with pytest.raises(ValueError, match="four GE fields"):
        pt.solve()


MIXED = {"Use Mixed Precision": True, "TwoLevel": True,
         "Null Space Type": "Elasticity", "Clusters": 8}


def test_linelas_mixed_two_level_matches_jax(blas1, monkeypatch):
    """3D P1 LinElas, the x = 0 face clamped, body load, through the
    mixed-precision two-level solver with the rigid-body null space (d = 3
    through B1-B3's plain versions)."""
    passes = []
    orig = jref.iterative_refinement

    def spy(*a, **k):
        res = orig(*a, **k)
        passes.append(res.passes)
        return res

    monkeypatch.setattr(jref, "iterative_refinement", spy)
    pj = _linelas(JDomain, JLinElas, JPL, (3, 8), MIXED,
                  lambda x: jnp.array([0.0, 0.0, -0.1]), clamp_flag=2)
    pt = _linelas(TDomain, TLinElas, TPL, (3, 8), MIXED,
                  lambda x: [0.0, 0.0, -0.1], clamp_flag=2, device="cpu")
    it_j, it_t = pj.solve(), pt.solve()
    assert pj.last_relres <= 1e-8 and pt.last_relres <= 1e-8
    assert pt.last_passes == passes[0]
    assert abs(it_t - it_j) <= 2
    u = pt.solution[0]
    assert u.dtype == torch.float64
    assert np.abs(u.numpy() - np.asarray(pj.solution[0])).max() < 1e-7
    assert pt._mixed_cache["prec"].n_coarse > 0
    # the f64 true residual, recomputed on the host
    A = pt.bc_system().get_block(0, 0).to_scipy()
    b = pt.rhs[0].numpy()
    assert np.linalg.norm(b - A @ u.numpy()) / np.linalg.norm(b) <= 1e-8
    assert u.numpy().reshape(-1, 3)[:, 2].min() < 0


def test_linelas_two_level_cuts_iterations():
    its = {}
    for two in (False, True):
        p = _linelas(TDomain, TLinElas, TPL, (3, 10),
                     dict(MIXED, TwoLevel=two, Clusters=16),
                     lambda x: [0.0, 0.0, -0.1], clamp_flag=2, device="cpu")
        its[two] = p.solve()
        assert p.last_relres <= 1e-8
    assert its[True] < its[False], its


@pytest.mark.parametrize("reuse", [True, False])
def test_mixed_reassembly_reuses_preconditioner(reuse):
    """With an unchanged pattern and a stale flag, the padded operator takes
    the new values through with_data and the factorized preconditioner is
    kept; 'Reuse Preconditioner': False rebuilds it.  Either way the new
    system is solved to 1e-8."""
    pt = _linelas(TDomain, TLinElas, TPL, (3, 6),
                  dict(MIXED, **{"Reuse Preconditioner": reuse}),
                  lambda x: [0.0, 0.0, -0.1], clamp_flag=2, device="cpu")
    pt.solve()
    u1 = pt.solution[0].clone()
    prec, sell = pt._mixed_cache["prec"], pt._mixed_cache["sell"]
    K = pt.system.get_block(0, 0)
    pt.system.add_block(0, 0, CsrMatrix(K.pattern, K.data * 2.0,
                                        device="cpu"))
    pt._prec_stale = True
    pt.solve()
    assert pt.last_relres <= 1e-8 and not pt._prec_stale
    assert (pt._mixed_cache["prec"] is prec) == reuse
    assert pt._mixed_cache["sell"] is not sell
    # interior rows doubled, Dirichlet rows unchanged (zero data): u halves
    assert _rel(pt.solution[0].numpy(), 0.5 * u1.numpy()) < 1e-7


def test_elasticity_entry_points_default_to_cuda():
    assert inspect.signature(TLinElas.__init__).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TLinElas(TDomain.structured(2, 2, device="cpu"))
