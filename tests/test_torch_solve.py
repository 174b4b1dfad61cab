"""The port's solvers and the whole slice (feddlib_tpu_torch) against the
JAX package: Krylov parity on one operator, and Laplace + solve() through
the mixed-precision two-level path — the same refinement passes, inner
iterations within ±2 (f32 sums in another order), solutions within 1e-7."""

import inspect

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet  # noqa: E402
from feddlib_tpu.la.csr import CsrMatrix as JCsr  # noqa: E402
from feddlib_tpu.problems.laplace import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.solvers import krylov as jk  # noqa: E402
from feddlib_tpu.solvers import refinement as jref  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.problems.laplace import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.solvers import krylov as tk  # noqa: E402
from feddlib_tpu_torch.solvers.refinement import iterative_refinement  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402


@pytest.fixture
def blas1():
    """Host LAPACK single-threaded under the factor thread pool (the
    oversubscribed default costs tens of seconds on small hosts)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def poisson():
    K, b = host_poisson_dirichlet(JDomain.structured(3, 6))
    At = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                                device="cpu")
    return K, b, JCsr.from_scipy(K), At


@pytest.mark.parametrize("kind,prec", [("gmres", False), ("gmres", True),
                                       ("cg", True)])
def test_krylov_matches(poisson, kind, prec):
    K, b, Aj, At = poisson
    d = K.diagonal()
    Mj = (lambda r: r / jnp.asarray(d)) if prec else None
    Mt = (lambda r: r / torch.as_tensor(d)) if prec else None
    if kind == "gmres":
        rj = jk.gmres(Aj.matvec, jnp.asarray(b), M=Mj, tol=1e-10, restart=20)
        rt = tk.gmres(At.matvec, torch.as_tensor(b), M=Mt, tol=1e-10,
                      restart=20)
    else:
        rj = jk.cg(Aj.matvec, jnp.asarray(b), M=Mj, tol=1e-10)
        rt = tk.cg(At.matvec, torch.as_tensor(b), M=Mt, tol=1e-10)
    assert rt.converged and rj.converged
    assert rt.iters == rj.iters
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 1e-9


def test_solve_operator_protocol_and_history(poisson):
    K, b, _, At = poisson
    fn, ops = At.operator()
    res = tk.solve("gmres", fn, ops, torch.as_tensor(b), tol=1e-8,
                   restart=10, record_history=True)
    assert res.converged and len(res.history) == res.iters + 1
    assert res.history[-1] <= 1e-8


def test_iterative_refinement_f32_inner(poisson):
    K, b, _, At = poisson

    def inner(r32):
        A32 = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                                     device="cpu", dtype=torch.float32)
        return tk.gmres(A32.matvec, r32, tol=1e-5, restart=50)

    res = iterative_refinement(At.matvec, inner, torch.as_tensor(b),
                               tol=1e-10)
    assert res.converged and res.passes >= 2 and res.x.dtype == torch.float64


def _laplace(D, L, PL, n, clusters, two, **kw):
    pl = PL("P", {"Clusters": clusters, "Use Mixed Precision": True,
                  "TwoLevel": two})
    prob = L(D.structured(3, n, **kw), parameter_list=pl, **kw)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def test_mixed_two_level_solve_matches_jax(blas1, monkeypatch):
    passes = []
    orig = jref.iterative_refinement

    def spy(*a, **k):
        res = orig(*a, **k)
        passes.append(res.passes)
        return res

    monkeypatch.setattr(jref, "iterative_refinement", spy)
    pj = _laplace(JDomain, JLaplace, JPL, 10, 8, True)
    it_j = pj.solve()
    pt = _laplace(TDomain, TLaplace, TPL, 10, 8, True, device="cpu")
    it_t = pt.solve()
    assert pj.last_relres <= 1e-8 and pt.last_relres <= 1e-8
    assert pt.last_passes == passes[0]
    assert abs(it_t - it_j) <= 2
    u_t = pt.solution[0]
    assert u_t.dtype == torch.float64
    assert np.abs(u_t.numpy() - np.asarray(pj.solution[0])).max() < 1e-7
    # the f64 true residual, recomputed on the host
    A = pt.bc_system().get_block(0, 0).to_scipy()
    b = pt.rhs[0].numpy()
    assert np.linalg.norm(b - A @ u_t.numpy()) / np.linalg.norm(b) <= 1e-8


def test_mixed_two_level_cuts_iterations(blas1):
    """The port's version of the JAX anchor (tests/test_schwarz.py:
    test_mixed_precision_two_level_cuts_iterations): the padded GDSW coarse
    level cuts inner GMRES iterations vs one level and both reach 1e-8."""
    its = {}
    for two in (False, True):
        p = _laplace(TDomain, TLaplace, TPL, 20, 32, two, device="cpu")
        its[two] = p.solve()
        assert p.last_relres <= 1e-8
    assert its[True] < its[False], its


def test_entry_points_default_to_cuda():
    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.la.permute import PermutationGather
    from feddlib_tpu_torch.la.sell import SellMatrix
    from feddlib_tpu_torch.problems.base import Problem

    for fn in (TDomain.structured, TDomain.from_file, TDomain.__init__,
               TLaplace.__init__, Problem.__init__, CsrMatrix.__init__,
               CsrMatrix.from_scipy, PermutationGather.__init__,
               SellMatrix.from_csr, BlockVector.zeros,
               convert.csr_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert TDomain.structured(3, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TDomain.structured(3, 2)


def test_unported_paths_raise():
    pt = _laplace(TDomain, TLaplace, TPL, 3, 2, False, device="cpu")
    pt.parameter_list["Use Mixed Precision"] = False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.solve()
    pt.parameter_list["Use Distributed Solve"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.solve()
