"""Assembly of the PyTorch port (feddlib_tpu_torch) against the JAX
package: the Laplace CSR, the rhs and the Dirichlet applications must share
the sparsity pattern exactly and agree in value within 1e-12 relative (the
element sums run in another order, so they are not bit-equal)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.bc import BCBuilder as JBC  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.problems.laplace import Laplace as JLaplace  # noqa: E402

from feddlib_tpu_torch.bc import BCBuilder as TBC  # noqa: E402
from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.fe.host_assembly import host_laplace_p1  # noqa: E402
from feddlib_tpu_torch.problems.laplace import Laplace as TLaplace  # noqa: E402

RTOL = 1e-12


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


@pytest.mark.parametrize("dim,n,fe", [(3, 6, "P1"), (3, 3, "P2"),
                                      (2, 6, "P1"), (2, 4, "P2")])
def test_laplace_csr_matches(dim, n, fe):
    dj, dt = _domains(dim, n, fe)
    _same_csr(tops.assemble_laplace(dt), jops.assemble_laplace(dj))


def test_laplace_matches_host_assembly():
    dt = TDomain.structured(3, 6, device="cpu")
    K = tops.assemble_laplace(dt).to_scipy()
    H = host_laplace_p1(dt)
    assert abs(K - H).max() / abs(H).max() < RTOL


@pytest.mark.parametrize("dim,n,fe", [(3, 6, "P1"), (3, 3, "P2"),
                                      (2, 6, "P2")])
def test_rhs_matches(dim, n, fe):
    dj, dt = _domains(dim, n, fe)
    bj = jops.assemble_rhs(dj, lambda x: 1.0 + x[0] * x[1])
    bt = tops.assemble_rhs(dt, lambda x: 1.0 + x[0] * x[1])
    assert bt.dtype == torch.float64
    assert _rel(bt.numpy(), bj) < RTOL
    cj = jops.assemble_rhs(dj, lambda x: 1.0 + 0 * x[0])
    ct = tops.assemble_rhs(dt, lambda x: 1.0 + 0 * x[0])
    assert _rel(ct.numpy(), cj) < RTOL


@pytest.mark.parametrize("fe", ["P1", "P2"])
def test_symmetric_bc_matches(fe):
    dj, dt = _domains(3, 4 if fe == "P1" else 2, fe)
    Kj, Kt = jops.assemble_laplace(dj), tops.assemble_laplace(dt)
    bj = jops.assemble_rhs(dj, lambda x: 1.0 + 0 * x[0])
    bt = tops.assemble_rhs(dt, lambda x: 1.0 + 0 * x[0])
    gj, gt = JBC(), TBC()
    gj.add_bc(lambda x, t: 1.0 + x[0], 1, 0, dj, "Dirichlet", 1)
    gt.add_bc(lambda x, t: 1.0 + x[0], 1, 0, dt, "Dirichlet", 1)
    Aj, rj = gj.apply_symmetric(Kj, bj, 0)
    At, rt = gt.apply_symmetric(Kt, bt, 0)
    _same_csr(At, Aj)
    assert _rel(rt.numpy(), rj) < RTOL
    sp = At.to_scipy()
    # symmetric up to the roundoff of the element sums
    assert abs(sp - sp.T).max() <= 1e-14 * abs(sp).max()


def test_problem_bc_system_matches():
    """Laplace.assemble → assemble_source → add_bc → set_boundaries_rhs
    gives the same row-masked system and rhs in both packages."""
    pj = JLaplace(JDomain.structured(3, 5))
    pt = TLaplace(TDomain.structured(3, 5, device="cpu"), device="cpu")
    for p in (pj, pt):
        p.assemble()
        p.assemble_source(lambda x: 1.0 + 0 * x[0])
    pj.add_bc(lambda x, t: jnp.sin(x[0]) * 0 + 2.0, 1, 0)
    pt.add_bc(lambda x, t: 2.0, 1, 0)
    pj.set_boundaries_rhs()
    pt.set_boundaries_rhs()
    _same_csr(pt.bc_system().get_block(0, 0), pj.bc_system().get_block(0, 0))
    assert _rel(pt.rhs[0].numpy(), pj.rhs[0]) < RTOL
    assert np.array_equal(pt.merged_dirichlet_mask(),
                          pj.merged_dirichlet_mask())
    x = np.random.default_rng(0).standard_normal(pt.block_sizes()[0])
    yj = pj.system.get_block(0, 0).matvec(jnp.asarray(x))
    yt = pt.system.get_block(0, 0).matvec(torch.as_tensor(x))
    assert _rel(yt.numpy(), yj) < RTOL
