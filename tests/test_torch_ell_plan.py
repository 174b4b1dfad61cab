"""The f64 operator's padded-ELL gather plan lives on its SparsityPattern
(feddlib_tpu_torch/la/csr.py `SparsityPattern.ell_plan`): every CsrMatrix
on one pattern shares one plan per device, built once (counter
`csr.ell_plan_builds`) and reused after (`csr.ell_plan_hits`); the
applies are bitwise those of the plan each matrix built for itself before
(inlined below as the reference); and repeated mixed-precision solves of
one problem build no plan after the first, with the iterations and x of
solves whose plans are built anew.  No JAX: properties of the port."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from feddlib_tpu_torch.bc import BCBuilder  # noqa: E402
from feddlib_tpu_torch.fe import ops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector  # noqa: E402
from feddlib_tpu_torch.la.csr import (CsrMatrix, SparsityPattern,  # noqa: E402
                                      ell_apply)
from feddlib_tpu_torch.problems.laplace import Laplace  # noqa: E402
from feddlib_tpu_torch.utils import timers  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList  # noqa: E402


@pytest.fixture(autouse=True)
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _per_matrix_plan(m: CsrMatrix):
    """The plan as CsrMatrix._ell_plan built it for each matrix before it
    moved to the pattern: the reference of the applies."""
    pat = m.pattern
    lens = pat.row_lengths()
    K = max(int(lens.max()) if len(lens) else 1, 1)
    ell_cols = np.zeros((K, pat.n_rows), dtype=np.int64)
    slot_of = np.full((K, pat.n_rows), pat.nnz, dtype=np.int64)
    pos = np.arange(pat.nnz) - np.repeat(pat.indptr[:-1], lens)
    r = pat.rows_of_slots()
    ell_cols[pos, r] = pat.indices
    slot_of[pos, r] = np.arange(pat.nnz)
    return (torch.as_tensor(ell_cols, device=m.device),
            torch.as_tensor(slot_of, device=m.device))


def _counts():
    c = timers.counters()
    return c.get("csr.ell_plan_builds", 0), c.get("csr.ell_plan_hits", 0)


@pytest.fixture(params=[1, 3], ids=["laplace", "vector3"])
def system(request):
    """(domain, K, dofs per node): a fresh domain's scalar Laplace, or its
    3-dof-per-node vector Laplace (the square vector pattern a Neo-Hooke
    tangent uses), each on a new pattern with no plan yet."""
    dom = Domain.structured(3, 4, device="cpu")
    if request.param == 1:
        return dom, ops.assemble_laplace(dom), 1
    return dom, ops.assemble_laplace_vec(dom), 3


def _bc_builder(dom, dofs):
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: [0.0] * dofs, 1, 0, dom, "Dirichlet", dofs)
    return bcb


def test_matrices_on_one_pattern_share_one_plan(system):
    dom, K, dofs = system
    assert getattr(K.pattern, "_ell_plans", None) is None
    builds, hits = _counts()
    first = K._ell_plan()
    others = [
        CsrMatrix(K.pattern, K.data.clone(), device="cpu"),
        K.scale(0.5),
        K.add(K.scale(2.0), alpha=1.0, beta=-1.0),
        _bc_builder(dom, dofs).apply_to_matrix(K, 0),
    ]
    for m in others:
        assert m.pattern is K.pattern
        plan = m._ell_plan()
        assert plan[0] is first[0] and plan[1] is first[1]
    assert _counts() == (builds + 1, hits + len(others))


def test_applies_bitwise_equal_the_per_matrix_plan(system):
    dom, K, dofs = system
    mats = [K, K.scale(-0.25), _bc_builder(dom, dofs).apply_to_matrix(K, 0)]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(K.shape[1], generator=g, dtype=torch.float64)
    X = torch.randn(K.shape[1], 5, generator=g, dtype=torch.float64)
    builds, _ = _counts()
    for m in mats:
        cols, slots = _per_matrix_plan(m)
        shared = m.pattern.ell_plan(m.device)
        assert torch.equal(shared[0], cols) and torch.equal(shared[1], slots)
        padded = torch.cat([m.data, m.data.new_zeros(1)])
        assert torch.equal(m.matvec(x), ell_apply((m.data, cols, slots), x))
        assert torch.equal(m @ x, ell_apply((m.data, cols, slots), x))
        assert torch.equal(m.matmat(X),
                           (padded[slots][:, :, None] * X[cols]).sum(0))
        fn, operands = m.operator()
        assert fn is ell_apply and operands[0] is m.data
        assert torch.equal(fn(operands, x),
                           ell_apply((m.data, cols, slots), x))
        ec, ed = m.ell_arrays()
        assert torch.equal(ec, cols) and torch.equal(ed, padded[slots])
    assert _counts()[0] == builds + 1


def test_equal_pattern_objects_and_devices_keep_their_own_plans(system):
    _, K, _ = system
    pat = K.pattern
    twin = SparsityPattern.from_csr(pat.indptr.copy(), pat.indices.copy(),
                                    pat.n_cols)
    builds, _ = _counts()
    a = K._ell_plan()
    b = CsrMatrix(twin, K.data, device="cpu")._ell_plan()
    assert a[0] is not b[0] and a[1] is not b[1]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # another device: a plan of its own (shapes only on "meta")
    c = pat.ell_plan("meta")
    assert c[0].device.type == "meta" and c[0].shape == a[0].shape
    assert pat.ell_plan(torch.device("meta"))[0] is c[0]
    assert K._ell_plan()[0] is a[0]
    assert _counts()[0] == builds + 3


@pytest.mark.gpu
def test_cuda_and_cuda0_share_one_plan():
    """The device key is normalised: "cuda" and "cuda:0" build one plan,
    the CPU keeps its own."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA device keys need a card")
    pat = ops.assemble_laplace(Domain.structured(3, 3, device="cpu")).pattern
    builds, _ = _counts()
    a = pat.ell_plan("cuda")
    assert pat.ell_plan(torch.device("cuda", 0))[0] is a[0]
    assert pat.ell_plan("cpu")[0] is not a[0]
    assert _counts()[0] == builds + 2


def _mixed_laplace():
    pl = ParameterList("P", {"Clusters": 8, "Use Mixed Precision": True,
                             "TwoLevel": True})
    prob = Laplace(Domain.structured(3, 8, device="cpu"), parameter_list=pl,
                   device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    return prob


def test_repeated_solves_build_no_plan_and_match_rebuilt_plans():
    """Three solves of one two-level mixed Laplace with three loads: after
    the first, `csr.ell_plan_builds` stays; each solve again with its
    system's plan dropped first (as every solve rebuilt it before) gives
    the same iterations and bitwise the same x."""
    prob = _mixed_laplace()
    n = prob.system.get_block(0, 0).shape[0]
    g = torch.Generator().manual_seed(3)
    loads = [BlockVector([torch.randn(n, generator=g, dtype=torch.float64)])
             for _ in range(3)]
    solver = prob.linear_solver
    shared = []
    for i, b in enumerate(loads):
        shared.append(solver.solve_system(prob, b))
        if i == 0:
            builds, hits = _counts()
    assert _counts()[0] == builds and _counts()[1] > hits
    pat = prob.system.get_block(0, 0).pattern
    assert prob.bc_system().get_block(0, 0).pattern is pat
    for b, (x, its) in zip(loads, shared):
        object.__setattr__(pat, "_ell_plans", {})
        before = _counts()[0]
        x_new, its_new = solver.solve_system(prob, b)
        assert _counts()[0] == before + 1
        assert its_new == its and its > 0
        assert torch.equal(x_new[0], x[0])
