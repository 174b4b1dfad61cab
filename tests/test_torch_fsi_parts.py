"""The parts of the port's FSI slice against the JAX package: the AABB
tree and interface matching (host copies: equal results), the ALE
divergence operator (1e-13 of max |data|), Domain.invalidate_geometry
across two mesh moves, the Geometry mesh-motion solve (1e-10) and the GI
shape-derivative blocks (1e-12 of max |data|, plus the finite-difference
check of tests/test_shape_derivatives.py:14).  Inputs are the same numpy
arrays, random fields from np.random.default_rng(seed); the two-box
domains and helpers come from test_torch_fsi.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.fe.shape_derivatives import \
    assemble_shape_derivative_blocks as j_shape  # noqa: E402
from feddlib_tpu.mesh import aabb as jaabb  # noqa: E402
from feddlib_tpu.mesh import interface as jiface  # noqa: E402
from feddlib_tpu.problems.geometry import Geometry as JGeometry  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import assembly as tasm  # noqa: E402
from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe import shape_derivatives as tsd  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.mesh import aabb as taabb  # noqa: E402
from feddlib_tpu_torch.mesh import interface as tiface  # noqa: E402
from feddlib_tpu_torch.problems.geometry import \
    Geometry as TGeometry  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402
from test_torch_fsi import IFACE, _rel, _two_box, blas1  # noqa: E402,F401


def _same_csr(Kt, Kj, tol):
    assert np.array_equal(Kt.pattern.indptr, Kj.pattern.indptr)
    assert np.array_equal(Kt.pattern.indices, Kj.pattern.indices)
    assert _rel(Kt.data.numpy(), np.asarray(Kj.data)) < tol


def test_aabb_locate_points_equal():
    """AABBTree.locate_points (tests/test_components.py:45): equal element
    ids for random points inside and one outside."""
    mj = JDomain.structured(2, 5).mesh
    mt = TDomain.structured(2, 5, device="cpu").mesh
    pts = np.concatenate([np.random.default_rng(0).random((40, 2)),
                          [[2.5, 2.5]]])
    lj = jaabb.AABBTree(mj.points, mj.elements).locate_points(pts)
    lt = taabb.AABBTree(mt.points, mt.elements).locate_points(pts)
    assert np.array_equal(lt, lj)
    assert (lt[:-1] >= 0).all() and lt[-1] == -1


def test_interface_matching_and_distances_equal():
    """determine_interface (tests/test_fsi.py:43) and
    distances_to_interface (:52): equal node pairs and distances."""
    uj, _, dj = _two_box("jax", 4, 2)
    ut, _, dt = _two_box("torch", 4, 2)
    ij = jiface.determine_interface(uj.mesh, dj.mesh, [IFACE])
    it = tiface.determine_interface(ut.mesh, dt.mesh, [IFACE])
    assert it.n_nodes == 9
    for a in ("nodes_a", "nodes_b", "flags"):
        assert np.array_equal(getattr(it, a), getattr(ij, a))
    np.testing.assert_array_equal(ut.mesh.points[it.nodes_a],
                                  dt.mesh.points[it.nodes_b])
    d_t = tiface.distances_to_interface(ut.mesh, ut.mesh.points[it.nodes_a])
    d_j = jiface.distances_to_interface(uj.mesh, uj.mesh.points[ij.nodes_a])
    assert np.array_equal(d_t, d_j)
    with pytest.raises(ValueError, match="no interface nodes"):
        tiface.determine_interface(ut.mesh, dt.mesh, [77])


@pytest.mark.parametrize("dim,fe", [(2, "P1"), (2, "P2"), (3, "P1"),
                                    (3, "P2")])
def test_ale_divergence_matches(dim, fe):
    """∫(∇·w) u·v at a random mesh velocity within 1e-13 of max |data|, and
    the anchor of tests/test_fsi.py:276: for w with constant divergence c
    the operator is c times the vector mass."""
    n = 3 if dim == 2 else 2
    dj = JDomain.structured(dim, n, fe_type=fe)
    dt = TDomain.structured(dim, n, fe_type=fe, device="cpu")
    w = np.random.default_rng(1).standard_normal(dj.n_dofs(dim))
    _same_csr(tops.assemble_ale_divergence(dt, torch.as_tensor(w)),
              jops.assemble_ale_divergence(dj, jnp.asarray(w)), 1e-13)
    coef = np.array([2.0, 3.0, 4.0][:dim])
    D = tops.assemble_ale_divergence(
        dt, torch.as_tensor((dt.mesh.points * coef).ravel()))
    M = tops.assemble_mass(dt, dim)
    x = torch.as_tensor(
        np.random.default_rng(0).standard_normal(dt.n_dofs(dim)))
    assert _rel(D.matvec(x).numpy(), coef.sum() * M.matvec(x).numpy()) \
        < 1e-12


def test_invalidate_geometry_after_two_moves():
    """A mesh moved twice: after invalidate_geometry both coordinate
    layouts and every assembled operator equal those of a fresh domain on
    the moved points, and the symbolic patterns are kept (same objects)."""
    from feddlib_tpu_torch.fe import fast_assembly as fa

    dom = TDomain.structured(2, 4, fe_type="P2", device="cpu")
    dom.mesh.save_reference_configuration()
    rng = np.random.default_rng(2)
    K0 = tops.assemble_laplace_vec(dom)
    dom.vert_coords_T()
    pat0 = K0.pattern
    for _ in range(2):
        g = 0.02 * rng.standard_normal((dom.n_nodes, 2))
        dom.mesh.move(g)
        dom.invalidate_geometry()
        fresh = TDomain(type(dom.mesh)(**{
            k: getattr(dom.mesh, k) for k in dom.mesh.__dataclass_fields__}),
            device="cpu")
        assert torch.equal(dom.vert_coords(), fresh.vert_coords())
        assert torch.equal(dom.vert_coords_T(), fresh.vert_coords_T())
        K = tops.assemble_laplace_vec(dom)
        assert K.pattern is pat0
        assert torch.equal(K.data, tops.assemble_laplace_vec(fresh).data)
        u = torch.as_tensor(rng.standard_normal(dom.n_dofs(2)))
        assert torch.equal(fa.assemble_advection_fast(
            dom, tops.u_elem_values(dom, u)).data, fa.assemble_advection_fast(
            fresh, tops.u_elem_values(fresh, u)).data)


@pytest.mark.parametrize("model", ["Laplace", "scaled", "Elasticity"])
def test_geometry_solve_motion_matches(model):
    """Geometry.solve_motion (tests/test_fsi.py:61: the interface lifted by
    0.05, outer boundary fixed) within 1e-10, for the harmonic, the
    distance-scaled and the pseudo-elastic extension."""
    uj, _, dj = _two_box("jax", 4, 2)
    ut, _, dt = _two_box("torch", 4, 2)
    ij = jiface.determine_interface(uj.mesh, dj.mesh, [IFACE])
    it = tiface.determine_interface(ut.mesh, dt.mesh, [IFACE])
    kw = {"Maximum Iterations": 2000}
    if model == "Elasticity":
        kw.update({"Model": "Elasticity", "E": 2.0})
    dist = (tiface.distances_to_interface(ut.mesh,
                                          ut.mesh.points[it.nodes_a])
            if model == "scaled" else None)
    gj = JGeometry(uj, parameter_list=JPL("P", kw), distances=dist)
    gt = TGeometry(ut, parameter_list=TPL("P", kw), distances=dist,
                   device="cpu")
    gj.assemble()
    gt.assemble()
    _same_csr(gt.system.get_block(0, 0), gj.system.get_block(0, 0), 1e-13)
    disp = np.zeros((it.n_nodes, 2))
    disp[:, 1] = 0.05
    disp[:, 0] = 0.01 * np.sin(np.pi * ut.mesh.points[it.nodes_a, 0])
    g_t = gt.solve_motion(it.nodes_a, disp)
    g_j = gj.solve_motion(ij.nodes_a, disp)
    assert _rel(g_t, g_j) < 1e-10
    assert gt.last_relres <= 1e-8 and gt.last_iters > 0
    np.testing.assert_allclose(g_t[it.nodes_a], disp, atol=1e-8)
    top = np.isclose(ut.mesh.points[:, 1], 1.0)
    assert np.abs(g_t[top]).max() < 1e-8


def test_shape_derivative_blocks_match():
    """D_ug and D_pg (torch.func.jacfwd inside vmap) against the JAX
    blocks within 1e-12 of max |data|, and against central finite
    differences of the GI residual (tests/test_shape_derivatives.py:14)."""
    pj = JDomain.structured(2, 3)
    uj = pj.p2_domain()
    pt = TDomain.structured(2, 3, device="cpu")
    ut = pt.p2_domain()
    for d in (uj, ut):
        d.mesh.save_reference_configuration()
    rng = np.random.default_rng(0)
    n_u, n_p = ut.n_dofs(2), pt.n_nodes
    u = rng.standard_normal(n_u) * 0.1
    p = rng.standard_normal(n_p) * 0.1
    g = rng.standard_normal(n_u) * 0.01
    gp = rng.standard_normal(n_u) * 0.01
    uo = rng.standard_normal(n_u) * 0.1
    mu, rho, dt, mc = 0.7, 1.3, 0.05, 20.0
    Dut, Dpt = tsd.assemble_shape_derivative_blocks(
        ut, pt, u, p, g, gp, uo, mu, rho, dt, mc)
    Duj, Dpj = j_shape(uj, pj, u, p, g, gp, uo, mu, rho, dt, mc)
    _same_csr(Dut, Duj, 1e-12)
    _same_csr(Dpt, Dpj, 1e-12)

    res = torch.func.vmap(tsd._fluid_elem_residual(2, "P2", "P1", mu, rho,
                                                   dt, mc))
    conn_u = torch.as_tensor(ut.elem_nodes())
    conn_p = torch.as_tensor(pt.elem_nodes())
    refv = torch.as_tensor(ut.mesh.ref_points[ut.mesh.elements[:, :3]])

    def fe(v):
        return torch.as_tensor(v).reshape(-1, 2)[conn_u]

    def global_residual(gvec):
        Ru, Rp = res(fe(u), torch.as_tensor(p)[conn_p], fe(gvec), fe(gp),
                     refv, fe(uo))
        return (tasm.assemble_vector(ut.elem_dofs(2),
                                     Ru.reshape(Ru.shape[0], -1), n_u),
                tasm.assemble_vector(pt.elem_nodes(), Rp, n_p))

    dg = rng.standard_normal(n_u)
    eps = 1e-6
    Fu1, Fp1 = global_residual(g + eps * dg)
    Fu0, Fp0 = global_residual(g - eps * dg)
    dgt = torch.as_tensor(dg)
    assert _rel(Dut.matvec(dgt).numpy(), ((Fu1 - Fu0) / (2 * eps)).numpy()) \
        < 1e-7
    assert _rel(Dpt.matvec(dgt).numpy(), ((Fp1 - Fp0) / (2 * eps)).numpy()) \
        < 1e-7


def test_shape_derivative_blocks_chunked_3d(monkeypatch):
    """3D P2/P1 blocks over several element chunks equal one chunk."""
    pt = TDomain.structured(3, 2, device="cpu")
    ut = pt.p2_domain()
    rng = np.random.default_rng(4)
    n_u = ut.n_dofs(3)
    args = [rng.standard_normal(n_u) * 0.1, rng.standard_normal(pt.n_nodes),
            rng.standard_normal(n_u) * 0.01, rng.standard_normal(n_u) * 0.01,
            rng.standard_normal(n_u) * 0.1, 0.1, 1.0, 0.02, 50.0]
    Du1, Dp1 = tsd.assemble_shape_derivative_blocks(ut, pt, *args)
    monkeypatch.setattr(tsd, "_CHUNK", 7)
    Du2, Dp2 = tsd.assemble_shape_derivative_blocks(ut, pt, *args)
    assert torch.equal(Du1.data, Du2.data) and torch.equal(Dp1.data,
                                                           Dp2.data)
    assert Du1.shape == (n_u, n_u) and Dp1.shape == (pt.n_nodes, n_u)
