"""The port's hex / P1-disc spaces and element-last fast assembly
(feddlib_tpu_torch.fe.hex, Domain.structured_hex / vert_coords_T, the hex
and P1-disc branches of fe/ops.py, fe/fast_assembly.py) against the JAX
package, on the scenarios of tests/test_p1disc.py, test_components.py
(hex) and test_assembly.py (fast against classic).  Basis tables agree
within 1e-14, assembled matrices and loads within 1e-12 relative in f64;
the SELL assembly (f32) within 1e-6 of max |y|."""

import os

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import fast_assembly as jfa  # noqa: E402
from feddlib_tpu.fe import hex as jhex  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402

from feddlib_tpu_torch.bc import BCBuilder  # noqa: E402
from feddlib_tpu_torch.fe import fast_assembly as tfa  # noqa: E402
from feddlib_tpu_torch.fe import hex as thex  # noqa: E402
from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.solvers.krylov import solve  # noqa: E402

RTOL = 1e-12
HEX_CASES = [("Q1", 2), ("Q2", 2), ("Q1", 3), ("Q2", 3), ("Q2-20", 3)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same_csr(Kt, Kj, rtol=RTOL):
    assert np.array_equal(Kt.pattern.indptr, Kj.pattern.indptr)
    assert np.array_equal(Kt.pattern.indices, Kj.pattern.indices)
    assert Kt.data.dtype == torch.float64
    assert _rel(Kt.data.numpy(), np.asarray(Kj.data)) < rtol


def _hex_pair(dim, n, ft):
    return (JDomain.structured_hex(dim, n, fe_type=ft),
            TDomain.structured_hex(dim, n, fe_type=ft, device="cpu"))


# -- basis tables and mesh ---------------------------------------------------

@pytest.mark.parametrize("ft,dim", HEX_CASES)
def test_hex_tables_and_mesh_match(ft, dim):
    """ref_nodes, φ and the jacfwd gradients (torch.func against jax) on
    every rule the kernels use, the Q1 geometry gradients, and the
    structured mesh."""
    np.testing.assert_array_equal(thex.ref_nodes(ft, dim),
                                  jhex.ref_nodes(ft, dim))
    assert thex.hex_n_basis(ft, dim) == jhex.hex_n_basis(ft, dim)
    nq0 = thex._default_nq(ft)
    for nq in (nq0, nq0 + 1):  # the stiffness / mass and the load rules
        tj, tt = jhex._tables(ft, dim, nq), thex._tables(ft, dim, nq)
        for a, b in zip(tt, tj):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-14
    nodes = thex.ref_nodes(ft, dim)
    np.testing.assert_allclose(thex.hex_phi(ft, dim, nodes),
                               np.eye(len(nodes)), atol=1e-12)
    mj, mt = (jhex.build_hex_mesh(dim, 3, fe_type=ft),
              thex.build_hex_mesh(dim, 3, fe_type=ft))
    np.testing.assert_array_equal(mt.points, mj.points)
    np.testing.assert_array_equal(mt.elements, mj.elements)
    np.testing.assert_array_equal(mt.point_flags, mj.point_flags)
    dj, dt = _hex_pair(dim, 2, ft)
    assert dt.is_hex and dt.n_basis() == dj.n_basis()
    np.testing.assert_array_equal(dt.vert_coords().numpy(),
                                  np.asarray(dj.vert_coords()))
    np.testing.assert_array_equal(dt.vert_coords_T().numpy(),
                                  np.asarray(dj.vert_coords_T()))


@pytest.mark.parametrize("ft,dim", HEX_CASES)
def test_hex_operators_match(ft, dim):
    """Scalar Laplace, scalar / vector mass and the vector load on quads /
    hexes; for Q2 / Q2-20 also the vector Laplace and the P1-disc
    divergence pair and pressure mass."""
    dj, dt = _hex_pair(dim, 3, ft)
    _same_csr(tops.assemble_laplace(dt), jops.assemble_laplace(dj))
    _same_csr(tops.assemble_mass(dt), jops.assemble_mass(dj))
    _same_csr(tops.assemble_mass(dt, dim), jops.assemble_mass(dj, dim))
    bt = tops.assemble_rhs(dt, lambda x: [1.0 + 0 * x[0], 3.0 * x[0]]
                           + [x[1]] * (dim - 2), dofs_per_node=dim)
    bj = jops.assemble_rhs(dj, lambda x: jnp.stack(
        [1.0 + 0 * x[0], 3.0 * x[0]] + [x[1]] * (dim - 2)),
        dofs_per_node=dim)
    assert _rel(bt.numpy(), bj) < RTOL
    if ft == "Q1":
        return
    _same_csr(tops.assemble_hex_laplace_vec(dt, 0.7),
              jops.assemble_hex_laplace_vec(dj, 0.7))
    (Bt, BTt), (Bj, BTj) = (tops.assemble_divergence_p1disc(dt),
                            jops.assemble_divergence_p1disc(dj))
    _same_csr(Bt, Bj)
    _same_csr(BTt, BTj)
    _same_csr(tops.assemble_mass_p1disc(dt), jops.assemble_mass_p1disc(dj))


@pytest.mark.parametrize("ft", ["Q1", "Q2"])
def test_hex_vector_rhs(ft):
    """tests/test_components.py:326 in the port: the per-component dof
    totals equal ∫ f over the unit square."""
    dom = TDomain.structured_hex(2, 3, fe_type=ft, device="cpu")
    b = tops.assemble_rhs(dom, lambda x: [1.0 + 0 * x[0], 3.0 * x[0]],
                          dofs_per_node=2)
    tot = b.numpy().reshape(-1, 2).sum(axis=0)
    np.testing.assert_allclose(tot, [1.0, 1.5], atol=1e-12)


@pytest.mark.parametrize("ft,dim", [("Q1", 2), ("Q1", 3), ("Q2", 2),
                                    ("Q2", 3), ("Q2-20", 3)])
def test_hex_element_kernels(ft, dim):
    """tests/test_components.py:341 and :377 in the port: element
    matrices against the JAX kernels; zero row sums, unit mass, partition
    of unity and the quadratic-exact stiffness energy."""
    mesh = thex.build_hex_mesh(dim, 3, fe_type=ft)
    cc = mesh.points[mesh.elements[:, :2 ** dim]]
    K = thex.hex_elem_laplace(torch.as_tensor(cc), dim, ft).numpy()
    M = thex.hex_elem_mass(torch.as_tensor(cc), dim, ft).numpy()
    assert _rel(K, jhex.hex_elem_laplace(jnp.asarray(cc), dim, ft)) < RTOL
    assert _rel(M, jhex.hex_elem_mass(jnp.asarray(cc), dim, ft)) < RTOL
    np.testing.assert_allclose(K.sum(axis=2), 0.0, atol=1e-12)
    assert np.isclose(M.sum(), 1.0, atol=1e-12)
    pts = np.linspace(0.05, 0.95, 4)[:, None] * np.ones((1, dim))
    np.testing.assert_allclose(thex.hex_phi(ft, dim, pts).sum(axis=1), 1.0,
                               atol=1e-12)
    if ft == "Q1":
        return
    p = mesh.points
    u = p[:, 0] ** 2 + 2 * p[:, 1] ** 2 + p[:, 0] * p[:, 1]
    xg, wg = np.polynomial.legendre.leggauss(3)
    xg, wg = (xg + 1) / 2, wg / 2
    exact = sum(wi * wj * ((2 * xi + yj) ** 2 + (4 * yj + xi) ** 2)
                for xi, wi in zip(xg, wg) for yj, wj in zip(xg, wg))
    ue = u[mesh.elements]
    np.testing.assert_allclose(np.einsum("ea,eab,eb->", ue, K, ue), exact,
                               rtol=1e-12)


def test_q1_hex_poisson_linear_exact():
    """tests/test_components.py:341's solve in the port: Q1 Poisson with
    linear Dirichlet data is exact (CG to 1e-12)."""
    dom = TDomain.structured_hex(3, 3, fe_type="Q1", device="cpu")
    K = tops.assemble_laplace(dom)
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: x[0] + 2 * x[1], 1, 0, dom, "Dirichlet", 1)
    Kb, bb = bcb.apply_symmetric(K, torch.zeros(dom.n_nodes,
                                                dtype=torch.float64), 0)
    fn, ops = Kb.operator()
    res = solve("cg", fn, ops, bb, tol=1e-12, maxiter=1000)
    g = dom.mesh.points[:, 0] + 2 * dom.mesh.points[:, 1]
    assert np.abs(res.x.numpy() - g).max() < 1e-9


def test_q2_hex_poisson_convergence():
    """tests/test_components.py:410 in the port: Q2 Poisson converges at
    ≥ 3rd order in L2, and each level's solution matches the JAX
    package's operators' solve."""
    errs = []
    for n in (2, 4):
        dom = TDomain.structured_hex(2, n, fe_type="Q2", device="cpu")
        K = tops.assemble_laplace(dom)
        b = tops.assemble_rhs(dom, lambda x: 2 * np.pi ** 2 * torch.sin(
            np.pi * x[0]) * torch.sin(np.pi * x[1]))
        bcb = BCBuilder()
        bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
        Kb, bb = bcb.apply_symmetric(K, b, 0)
        fn, ops = Kb.operator()
        res = solve("cg", fn, ops, bb, tol=1e-12, maxiter=2000)
        pts = dom.mesh.points
        ex = np.sin(np.pi * pts[:, 0]) * np.sin(np.pi * pts[:, 1])
        M = tops.assemble_mass(dom)
        e = res.x - torch.as_tensor(ex)
        errs.append(float(torch.sqrt(e @ M.matvec(e))))
        dj = JDomain.structured_hex(2, n, fe_type="Q2")
        bj = jops.assemble_rhs(dj, lambda x: 2 * np.pi ** 2 * jnp.sin(
            np.pi * x[0]) * jnp.sin(np.pi * x[1]))
        assert _rel(b.numpy(), bj) < RTOL
    assert np.log2(errs[0] / errs[1]) > 2.9


# -- the Q2/P1-disc pair (tests/test_p1disc.py) ----------------------------------

def test_p1disc_divergence_exactness():
    """tests/test_p1disc.py:14 in the port."""
    dom = TDomain.structured_hex(2, 4, fe_type="Q2", device="cpu")
    B, BT = tops.assemble_divergence_p1disc(dom)
    u = torch.as_tensor(dom.mesh.points[:, :2].ravel())
    Bu = B.matvec(u).numpy().reshape(dom.n_elements, 3)
    np.testing.assert_allclose(Bu[:, 0], -2.0 * (1.0 / 4) ** 2, atol=1e-12)
    np.testing.assert_allclose(Bu[:, 1:], 0.0, atol=1e-12)
    u2 = torch.as_tensor(dom.mesh.points[:, [1, 0]].ravel())
    np.testing.assert_allclose(B.matvec(u2).numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(B.to_scipy().toarray(),
                               BT.to_scipy().toarray().T, atol=1e-14)


def test_p1disc_mass_spd_block_diagonal():
    """tests/test_p1disc.py:36 in the port."""
    dom = TDomain.structured_hex(2, 3, fe_type="Q2", device="cpu")
    M = tops.assemble_mass_p1disc(dom).to_scipy()
    coo = M.tocoo()
    assert (coo.row // 3 == coo.col // 3).all()
    assert np.linalg.eigvalsh(M.toarray()).min() > 0


def test_stokes_q2_p1disc_cavity():
    """tests/test_p1disc.py:46 in the port: the Q2/P1-disc lid-driven
    cavity, solved from the port's blocks, is discretely divergence-free
    and equals the solve from the JAX package's blocks."""
    def cavity(A, B, BT, dom):
        n_u, n_p = dom.n_dofs(2), dom.n_elements * 3
        S = sps.bmat([[A, BT], [B, None]]).tolil()
        pts, bnd = dom.mesh.points, dom.mesh.point_flags > 0
        mask = np.zeros(n_u + n_p, dtype=bool)
        mask[0:n_u:2] = bnd
        mask[1:n_u:2] = bnd
        mask[n_u] = True
        g = np.zeros(n_u + n_p)
        g[0:n_u:2] = np.where(bnd & np.isclose(pts[:, 1], 1.0), 1.0, 0.0)
        for i in np.nonzero(mask)[0]:
            S.rows[i] = [i]
            S.data[i] = [1.0]
        return spla.spsolve(S.tocsr(), np.where(mask, g, 0.0)), n_u

    dt = TDomain.structured_hex(2, 4, fe_type="Q2", device="cpu")
    dj = JDomain.structured_hex(2, 4, fe_type="Q2")
    Bt, BTt = tops.assemble_divergence_p1disc(dt)
    xt, n_u = cavity(tops.assemble_hex_laplace_vec(dt, 1.0).to_scipy(),
                     Bt.to_scipy(), BTt.to_scipy(), dt)
    Bj, BTj = jops.assemble_divergence_p1disc(dj)
    xj, _ = cavity(jops.assemble_hex_laplace_vec(dj, 1.0).to_scipy(),
                   Bj.to_scipy(), BTj.to_scipy(), dj)
    u = xt[:n_u]
    assert np.isfinite(xt).all() and np.abs(u).max() <= 1.0 + 1e-8
    Bu = Bt.matvec(torch.as_tensor(u)).numpy()
    assert np.abs(Bu[1:]).max() < 1e-9
    bnd = np.repeat(dt.mesh.point_flags > 0, 2)
    assert np.abs(u[~bnd]).max() > 0.05
    assert _rel(xt, xj) < 1e-10


def test_simplex_only_operators_raise_on_hex():
    """The operators the JAX package assembles with simplex kernels only
    raise NotImplementedError on a hex domain."""
    dom = TDomain.structured_hex(2, 2, fe_type="Q2", device="cpu")
    with pytest.raises(NotImplementedError):
        tops.assemble_lin_elasticity(dom, 1.0, 1.0)
    with pytest.raises(NotImplementedError):
        tops.assemble_advection(dom, torch.zeros(dom.n_dofs(2),
                                                 dtype=torch.float64))


# -- element-last fast assembly (tests/test_assembly.py:145, :193) -------------

def _fast_then_classic(build):
    """build() under FEDD_FAST_ASSEMBLY=1, then under "0"; the variable is
    restored in a finally."""
    old = os.environ.get("FEDD_FAST_ASSEMBLY")
    try:
        os.environ["FEDD_FAST_ASSEMBLY"] = "1"
        fast = build()
        os.environ["FEDD_FAST_ASSEMBLY"] = "0"
        classic = build()
    finally:
        if old is None:
            os.environ.pop("FEDD_FAST_ASSEMBLY", None)
        else:
            os.environ["FEDD_FAST_ASSEMBLY"] = old
    return fast, classic


@pytest.mark.parametrize("dim,ft", [(2, "P1"), (2, "P2"), (3, "P1"),
                                    (3, "P2")])
def test_fast_assembly_matches_classic(dim, ft):
    """tests/test_assembly.py:145 in the port: the element-last Laplace
    and mass give the chunked path's CSR structure and its values to
    summation-order roundoff; the flat kernels equal the JAX package's."""
    def build():
        dom = TDomain.structured(dim, 5, fe_type=ft, device="cpu")
        return tops.assemble_laplace(dom), tops.assemble_mass(dom)

    (Kf, Mf), (Kc, Mc) = _fast_then_classic(build)
    for f, c, tol in ((Kf, Kc, 1e-13), (Mf, Mc, 1e-14)):
        assert np.array_equal(f.pattern.indptr, c.pattern.indptr)
        assert np.array_equal(f.pattern.indices, c.pattern.indices)
        assert abs(f.to_scipy() - c.to_scipy()).max() < tol
    dj = (JDomain.structured(dim, 3) if ft == "P1"
          else JDomain.structured(dim, 3).p2_domain())
    dt = TDomain.structured(dim, 3, fe_type=ft, device="cpu")
    for op in ("laplace", "mass"):
        ft_ = tfa._KERNELS[op](dt.vert_coords_T(), dim, ft)
        fj = jfa._KERNELS[op](dj.vert_coords_T(), dim, ft)
        assert _rel(ft_.numpy(), fj) < RTOL
    pt, pj = tfa.pattern_abe(dt, 1), jfa.pattern_abe(dj, 1)
    np.testing.assert_array_equal(pt.coo_slots, pj.coo_slots)


@pytest.mark.parametrize("dim", [2, 3])
def test_fast_advection_matches_classic(dim):
    """tests/test_assembly.py:193 in the port: N(u) and W(u) through the
    element-last kernels against the chunked path, and (in 2D: the JAX
    package compiles its unrolled 3D P2 kernels for about 110 s on the
    CPU) the fast N(u), W(u) against the JAX package's fast path."""
    u_np = np.random.default_rng(1).standard_normal(
        TDomain.structured(dim, 4, fe_type="P2", device="cpu").n_dofs(dim))
    u = torch.as_tensor(u_np)

    def build():
        dom = TDomain.structured(dim, 4, fe_type="P2", device="cpu")
        return (tops.assemble_advection(dom, u),
                tops.assemble_advection_in_u(dom, u))

    (Nf, Wf), (Nc, Wc) = _fast_then_classic(build)
    assert abs(Nf.to_scipy() - Nc.to_scipy()).max() < 1e-13
    assert abs(Wf.to_scipy() - Wc.to_scipy()).max() < 1e-13
    if dim == 3:
        return
    dj = JDomain.structured(dim, 4).p2_domain()
    dt = TDomain.structured(dim, 4, fe_type="P2", device="cpu")
    ue_t = tops.u_elem_values(dt, u)
    ue_j = jops.u_elem_values(dj, jnp.asarray(u_np))
    _same_csr(tfa.assemble_advection_fast(dt, ue_t),
              jfa.assemble_advection_fast(dj, ue_j))
    _same_csr(tfa.assemble_advection_in_u_fast(dt, ue_t),
              jfa.assemble_advection_in_u_fast(dj, ue_j))


def test_use_fast_dispatch():
    """Off on the CPU, on for a CUDA device, and FEDD_FAST_ASSEMBLY forces
    either way (as the JAX package's use_fast)."""
    old = os.environ.pop("FEDD_FAST_ASSEMBLY", None)
    try:
        assert not tfa.use_fast(torch.device("cpu"))
        assert tfa.use_fast(torch.device("cuda"))
        os.environ["FEDD_FAST_ASSEMBLY"] = "0"
        assert not tfa.use_fast(torch.device("cuda"))
        os.environ["FEDD_FAST_ASSEMBLY"] = "1"
        assert tfa.use_fast(torch.device("cpu"))
    finally:
        os.environ.pop("FEDD_FAST_ASSEMBLY", None)
        if old is not None:
            os.environ["FEDD_FAST_ASSEMBLY"] = old
    assert tfa.supported(3, "P2") and not tfa.supported(3, "Q1")


@pytest.mark.parametrize("n_splits", [None, 3])
def test_sell_assemble_matches_jax(n_splits):
    """sell_assemble on the P1 Laplace plan of Domain.structured(3, 4):
    the port's SELL operator (plain B2 on the CPU) against the JAX
    package's (its XLA twin), in f32, within 1e-6 of max |y|; and both
    against the f64 segment sum within 1e-5 relative.  None is the JAX
    split rule (one split here)."""
    dj, dt = JDomain.structured(3, 4), TDomain.structured(3, 4,
                                                          device="cpu")
    pj, pt = jfa.pattern_abe(dj, 1), tfa.pattern_abe(dt, 1)
    plj = jfa.sell_assembly_plans(pj, dj.n_elements, n_splits=n_splits)
    plt = tfa.sell_assembly_plans(pt, dt.n_elements, n_splits=n_splits,
                                  device="cpu")
    assert (plt.H, plt.S) == (plj.H, plj.S)
    flat = np.random.default_rng(0).standard_normal(len(pt.coo_slots))
    yt = tfa.sell_assemble(plt, torch.as_tensor(flat, dtype=torch.float32))
    yj = np.asarray(jfa.sell_assemble(plj, jnp.asarray(flat, jnp.float32)))
    assert yt.dtype == torch.float32
    assert np.abs(yt.numpy() - yj).max() <= 1e-6 * np.abs(yj).max()
    ref = np.zeros(pt.nnz)
    np.add.at(ref, pt.coo_slots, flat)
    assert _rel(yt.numpy(), ref) < 1e-5
    ops_list = tfa.sell_assembly_ops(plt)
    torch.testing.assert_close(tfa.sell_assemble(
        plt, torch.as_tensor(flat, dtype=torch.float32), ops_list), yt,
        rtol=0, atol=0)
