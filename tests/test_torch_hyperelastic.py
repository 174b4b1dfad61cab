"""The port's hyperelasticity slice (feddlib_tpu_torch.fe.hyperelastic:
torch.func residuals and tangents; problems/nonlin_elasticity.py:
NonLinElasticity, the Elasticity facade) against the JAX package, on the
scenarios of tests/test_components.py:67 and :88 and an unsteady block:
Newton inside BDF2, in f64 and on the mixed-precision path.  Element
residuals, tangents and energies agree within 1e-12 relative; Newton
counts exactly; solutions within 1e-8 relative (f64 Krylov to 1e-10), 1e-6
on the mixed path (f32 inner sums, ±2 inner iterations)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import hyperelastic as jh  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.problems import nonlin_elasticity as jnl  # noqa: E402
from feddlib_tpu.solvers import timestepping as jts  # noqa: E402
from feddlib_tpu.solvers.nonlinear import NonLinearSolver as JNLS  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import hyperelastic as th  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.problems import LinElas as TLinElas  # noqa: E402
from feddlib_tpu_torch.problems import nonlin_elasticity as tnl  # noqa: E402
from feddlib_tpu_torch.solvers import timestepping as tts  # noqa: E402
from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver as TNLS  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

RTOL = 1e-12
MATERIALS = {"StVK": (0.4, 0.6), "Neo-Hooke": (0.4, 0.6),
             "Mooney-Rivlin": (0.1, 0.1, 0.8)}


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


@pytest.mark.parametrize("material", list(MATERIALS))
@pytest.mark.parametrize("dim,fe", [(2, "P1"), (3, "P1"), (3, "P2")])
def test_element_residual_tangent_energy_match(dim, fe, material):
    """elem_hyper_residual_tangent (torch.func grad / hessian under vmap)
    and elem_hyper_energy against jax.grad / jax.hessian, at a random
    displacement from a seeded generator; the tangent is symmetric."""
    dom = TDomain.structured(dim, 2, fe_type=fe, device="cpu")
    vc = dom.vert_coords()
    de = 0.02 * np.random.default_rng(7).standard_normal(
        (dom.n_elements, dom.n_basis(), dim))
    params = MATERIALS[material]
    Rt, Kt = th.elem_hyper_residual_tangent(vc, torch.as_tensor(de), dim, fe,
                                            material, params)
    Rj, Kj = jh.elem_hyper_residual_tangent(jnp.asarray(vc.numpy()),
                                            jnp.asarray(de), dim, fe,
                                            material, params)
    nbd = dom.n_basis() * dim
    assert Rt.shape == (dom.n_elements, nbd) and Kt.dtype == torch.float64
    assert Kt.shape == (dom.n_elements, nbd, nbd)
    assert _rel(Rt.numpy(), Rj) < RTOL
    assert _rel(Kt.numpy(), Kj) < RTOL
    assert _rel(Kt.numpy(), Kt.transpose(1, 2).numpy()) < 1e-14
    et = th.elem_hyper_energy(vc, torch.as_tensor(de), dim, fe, material,
                              params)
    ej = jh.elem_hyper_energy(jnp.asarray(vc.numpy()), jnp.asarray(de), dim,
                              fe, material, params)
    assert _rel(et.numpy(), ej) < RTOL
    with pytest.raises(ValueError):
        th.material_energy("Ogden")


def _loaded(P, material, n=4, load=-0.001):
    """tests/test_components.py:67's block: NonLinElasticity on
    Domain.structured(2, n), boundary clamped, body load in y."""
    D, PL, NL, kw, zero, src = P
    prob = NL(D.structured(2, n, **kw), parameter_list=_params(
        PL, **{"Material Model": material, "E": 1.0, "Poisson Ratio": 0.3,
               "Preconditioner Type": "Jacobi", "Maximum Iterations": 4000,
               "Convergence Tolerance": 1e-10}), **kw)
    prob.assemble()
    prob.add_bc(lambda x, t: zero, 1, 0)
    prob.assemble_source(src(load))
    return prob


JP = (JDomain, JPL, jnl.NonLinElasticity, {}, jnp.zeros(2),
      lambda g: (lambda x: jnp.array([0.0, g])))
TP = (TDomain, TPL, tnl.NonLinElasticity, {"device": "cpu"}, [0.0, 0.0],
      lambda g: (lambda x: [0.0, g]))


@pytest.mark.parametrize("material", list(MATERIALS))
def test_hyperelastic_newton(material):
    """tests/test_components.py:67 in the port: Newton in ≤ 4 steps to the
    default tolerance, as many steps as the JAX package, the same
    displacement; the tangent and internal forces of the first state
    equal the JAX package's."""
    out = []
    for P, NLS in ((JP, JNLS), (TP, TNLS)):
        prob = _loaded(P, material)
        K0 = prob.system.get_block(0, 0)
        s = NLS("Newton")
        its = s.solve(prob)
        out.append((its, s.final_criterion, np.asarray(prob.solution[0]),
                    K0, np.asarray(prob.internal_forces())))
    (ij, cj, dj, Kj, Fj), (it, ct, dt, Kt, Ft) = out
    assert it == ij and it <= 4 and ct <= 1e-6
    np.testing.assert_array_equal(Kt.pattern.indices, Kj.pattern.indices)
    assert _rel(Kt.data.numpy(), Kj.data) < RTOL
    assert _rel(Ft, Fj) < 1e-8
    assert _rel(dt, dj) < 1e-8
    assert dt.reshape(-1, 2)[:, 1].min() < 0


def test_hyperelastic_matches_linear_small_strain():
    """tests/test_components.py:88 in the port: StVK at small strain
    within 1e-3 of LinElas."""
    common = {"E": 1.0, "Poisson Ratio": 0.3,
              "Preconditioner Type": "Jacobi", "Maximum Iterations": 4000,
              "Convergence Tolerance": 1e-11}
    lin = TLinElas(TDomain.structured(2, 4, device="cpu"),
                   parameter_list=_params(TPL, **common), device="cpu")
    lin.assemble()
    lin.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
    lin.assemble_source(lambda x: [0.0, -1e-4])
    lin.set_boundaries_rhs()
    lin.solve()
    nl = tnl.NonLinElasticity(TDomain.structured(2, 4, device="cpu"),
                              parameter_list=_params(
                                  TPL, **{"Material Model": "StVK",
                                          **common}), device="cpu")
    nl.assemble()
    nl.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
    nl.assemble_source(lambda x: [0.0, -1e-4])
    TNLS("Newton").solve(nl)
    dl, dn = lin.solution[0].numpy(), nl.solution[0].numpy()
    assert np.abs(dn - dl).max() / np.abs(dl).max() < 1e-3


def test_elasticity_facade():
    """Elasticity picks LinElas for 'Material Model' 'linear' and
    NonLinElasticity otherwise — also without parameters, as the JAX
    facade does."""
    dom = TDomain.structured(2, 2, device="cpu")
    assert isinstance(jnl.Elasticity(JDomain.structured(2, 2)),
                      jnl.NonLinElasticity)
    assert isinstance(tnl.Elasticity(dom, device="cpu"),
                      tnl.NonLinElasticity)
    assert isinstance(tnl.Elasticity(dom, _params(
        TPL, **{"Material Model": "linear"}), device="cpu"), TLinElas)
    p = tnl.Elasticity(dom, _params(TPL, **{"Material Model": "StVK"}),
                       device="cpu")
    assert isinstance(p, tnl.NonLinElasticity) and p.material == "StVK"
    pj = jnl.Elasticity(JDomain.structured(2, 2), _params(
        JPL, **{"Material Model": "Mooney-Rivlin"}))
    pt = tnl.Elasticity(dom, _params(TPL, **{"Material Model":
                                             "Mooney-Rivlin"}),
                        device="cpu")
    assert pt.params == pj.params
    from feddlib_tpu_torch.problems import (Elasticity, LaplaceBlocks,
                                            LinElasFirstOrder,
                                            NonLinElasticity)

    assert NonLinElasticity is tnl.NonLinElasticity
    assert Elasticity is tnl.Elasticity
    assert LaplaceBlocks.__module__.endswith("misc")
    assert LinElasFirstOrder.__module__.endswith("misc")


def _unsteady(P, params, n=3):
    """The unsteady hyperelastic block of chip_smoke.py's phase 9 at a
    small size: Neo-Hooke on Domain.structured(3, n), the x = 0 face
    clamped, a body load in z ramped in time, BDF2 over 3 steps."""
    D, PL, NL, kw, _, _ = P
    if kw:
        from feddlib_tpu_torch.fe import ops
        from feddlib_tpu_torch.la.block import BlockVector
        from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary

        zero, vec = [0.0, 0.0, 0.0], (lambda g: (lambda x: [0.0, 0.0, g]))
    else:
        from feddlib_tpu.fe import ops
        from feddlib_tpu.la.block import BlockVector
        from feddlib_tpu.mesh.structured import flag_boxed_boundary

        zero, vec = jnp.zeros(3), (lambda g: (lambda x: jnp.array(
            [0.0, 0.0, g])))
    dom = D.structured(3, n, **kw)
    flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
    prob = NL(dom, parameter_list=_params(PL, **{
        "Material Model": "Neo-Hooke", "E": 1.0, "Poisson Ratio": 0.3,
        **params}), **kw)
    prob.assemble()
    prob.add_bc(lambda x, t: zero, 2, 0)
    f = ops.assemble_rhs(dom, vec(-0.05), 3)
    ts = tts if kw else jts
    tp = ts.TimeProblem(prob)
    drv = ts.DAESolverInTime(tp, 0.5, 1.5,
                             rhs_func=lambda t: BlockVector([f * t]))
    return prob, drv


@pytest.mark.parametrize("mixed", [False, True])
def test_unsteady_hyperelastic_bdf2(mixed):
    """Newton inside advance_nonlinear_bdf(order=2), 3 steps: the f64
    Jacobi-GMRES path, and the mixed-precision two-level path with the
    elasticity null space.  The port's displacement equals the JAX
    package's; on the mixed path the padded operators and the factored
    preconditioner are built once and refreshed with with_data (one
    SparsityPattern for the mass, the tangent, their sum and the
    BC-applied system), as in the JAX package."""
    if mixed:
        params = {"Use Mixed Precision": True, "TwoLevel": True,
                  "Null Space Type": "elasticity", "Clusters": 8,
                  "Convergence Tolerance": 1e-10}
    else:
        params = {"Preconditioner Type": "Jacobi",
                  "Maximum Iterations": 4000,
                  "Convergence Tolerance": 1e-10}
    out = []
    for P in (JP, TP):
        prob, drv = _unsteady(P, params)
        builds = []
        if mixed and P is TP:
            from feddlib_tpu_torch.solvers import linear

            orig = linear.point_cluster_operators

            def counted(*a, **k):
                builds.append(1)
                return orig(*a, **k)

            linear.point_cluster_operators = counted
        try:
            drv.advance_nonlinear_bdf(order=2)
        finally:
            if builds or (mixed and P is TP):
                linear.point_cluster_operators = orig
        out.append((np.asarray(prob.solution[0]), builds))
    dt, dj = out[1][0], out[0][0]
    assert np.isfinite(dt).all() and dt.reshape(-1, 3)[:, 2].min() < 0
    assert _rel(dt, dj) < (1e-6 if mixed else 1e-8)
    if mixed:
        assert len(out[1][1]) == 1


# -- the closed form of Neo-Hooke on P1 tetrahedra ------------------------

NH = (0.4, 0.6)


def _p1_cube(perturbed, n=3):
    """Domain.structured(3, n) on the CPU; `perturbed` moves every interior
    point by up to 0.2 h in each coordinate (seeded)."""
    dom = TDomain.structured(3, n, device="cpu")
    if perturbed:
        pts = dom.mesh.points
        inner = np.all((pts > 1e-12) & (pts < 1 - 1e-12), axis=1)
        jitter = np.random.default_rng(11).uniform(-0.2, 0.2, pts.shape) / n
        pts[inner] += jitter[inner]
    return dom


def _displacements(vc, strain, seed=5):
    """Nodal displacements d_a = (F_e − I) X_a + c_e, so that each element
    has the deformation gradient F_e exactly: I plus `strain` times a
    seeded normal matrix, rescaled ("finite") to a determinant drawn
    uniformly from [0.7, 1.3]."""
    rng = np.random.default_rng(seed)
    E = vc.shape[0]
    amp = 1e-3 if strain == "small" else 0.15
    F = np.eye(3) + amp * rng.standard_normal((E, 3, 3))
    if strain == "finite":
        J = rng.uniform(0.7, 1.3, E)
        J[:2] = 0.7, 1.3
        F *= np.cbrt(J / np.linalg.det(F))[:, None, None]
    X = vc.numpy()
    d = np.einsum("eik,eak->eai", F - np.eye(3), X)
    d += 0.01 * rng.standard_normal((E, 1, 3))
    return torch.as_tensor(d), np.linalg.det(F)


@pytest.mark.parametrize("strain", ["small", "finite"])
@pytest.mark.parametrize("perturbed", [False, True],
                         ids=["structured", "perturbed"])
def test_neo_hooke_p1_closed_form_matches_autodiff_and_jax(perturbed,
                                                           strain):
    """The closed form that Neo-Hooke on 3D P1 elements takes (the plain
    version of csrc/hyperelastic.cu on the CPU) against the port's
    torch.func path and jax.grad / jax.hessian, within 1e-12 relative, at
    small strains and at J from 0.7 to 1.3; its tangent is symmetric."""
    dom = _p1_cube(perturbed)
    vc = dom.vert_coords()
    de, J = _displacements(vc, strain)
    if strain == "finite":
        assert J.min() <= 0.7 + 1e-9 and J.max() >= 1.3 - 1e-9
    R, K = th.elem_hyper_residual_tangent(vc, de, 3, "P1", "Neo-Hooke", NH)
    Ra, Ka = th.autodiff_residual_tangent(vc, de, 3, "P1", "Neo-Hooke", NH)
    Rj, Kj = jh.elem_hyper_residual_tangent(jnp.asarray(vc.numpy()),
                                            jnp.asarray(de.numpy()), 3, "P1",
                                            "Neo-Hooke", NH)
    assert R.shape == (dom.n_elements, 12) and K.shape == (dom.n_elements,
                                                            12, 12)
    assert _rel(R.numpy(), Ra.numpy()) < RTOL
    assert _rel(K.numpy(), Ka.numpy()) < RTOL
    assert _rel(R.numpy(), Rj) < RTOL
    assert _rel(K.numpy(), Kj) < RTOL
    assert _rel(K.numpy(), K.transpose(1, 2).numpy()) < 1e-14


@pytest.mark.parametrize("material,dim,fe", [
    ("Neo-Hooke", 3, "P1"), ("StVK", 3, "P1"), ("Mooney-Rivlin", 3, "P1"),
    ("Neo-Hooke", 3, "P2"), ("Neo-Hooke", 2, "P1")])
def test_residual_only_equals_full_call_bitwise(material, dim, fe):
    """elem_hyper_residual_tangent(..., tangent=False) returns no tangent
    and the full call's R bit for bit, on the closed form and on the
    torch.func path (grad alone)."""
    dom = TDomain.structured(dim, 2, fe_type=fe, device="cpu")
    vc = dom.vert_coords()
    de = torch.as_tensor(0.02 * np.random.default_rng(3).standard_normal(
        (dom.n_elements, dom.n_basis(), dim)))
    params = MATERIALS[material]
    R, K = th.elem_hyper_residual_tangent(vc, de, dim, fe, material, params)
    R1, K1 = th.elem_hyper_residual_tangent(vc, de, dim, fe, material,
                                            params, tangent=False)
    assert K1 is None and K is not None
    assert torch.equal(R1, R)


def test_neo_hooke_p1_inverted_element_is_non_finite():
    """An element with J < 0 gives a non-finite R and K on the closed form,
    as on the torch.func path (ln J), so Newton's line search backtracks;
    the other elements keep their values."""
    dom = _p1_cube(False, n=2)
    vc = dom.vert_coords()
    de, _ = _displacements(vc, "small")
    X = vc[3].numpy()
    de[3] = torch.as_tensor((np.diag([-1.5, 0.0, 0.0]) @ X.T).T)  # J = -0.5
    for fn in (th.elem_hyper_residual_tangent, th.autodiff_residual_tangent):
        R, K = fn(vc, de, 3, "P1", "Neo-Hooke", NH)
        assert not torch.isfinite(R[3]).all()
        assert not torch.isfinite(K[3]).all()
        keep = torch.arange(dom.n_elements) != 3
        assert torch.isfinite(R[keep]).all() and torch.isfinite(K[keep]).all()
    R, _ = th.elem_hyper_residual_tangent(vc, de, 3, "P1", "Neo-Hooke", NH)
    Ra, _ = th.autodiff_residual_tangent(vc, de, 3, "P1", "Neo-Hooke", NH)
    assert _rel(R[keep].numpy(), Ra[keep].numpy()) < RTOL


@pytest.mark.parametrize("material,dim,fe", [
    ("Neo-Hooke", 3, "P1"), ("StVK", 3, "P1"), ("Mooney-Rivlin", 3, "P1"),
    ("Neo-Hooke", 3, "P2"), ("Neo-Hooke", 2, "P1")])
def test_hyper_path_counters(monkeypatch, material, dim, fe):
    """hyper_elem_residual_tangent over a domain: Neo-Hooke on 3D P1 takes
    the closed form in one evaluation (no `hyper.autodiff_chunks`; on the
    CPU its plain version, so no `kernel.neo_hooke_p1` either), every
    other case one torch.func evaluation a chunk of _AUTODIFF_CHUNK."""
    from feddlib_tpu_torch.la import _cuda
    from feddlib_tpu_torch.utils import timers

    monkeypatch.setattr(th, "_AUTODIFF_CHUNK", 10)
    dom = TDomain.structured(dim, 3, fe_type=fe, device="cpu")
    d = torch.as_tensor(0.01 * np.random.default_rng(1).standard_normal(
        dom.n_dofs(dim)))
    timers.reset_counters("hyper.autodiff_chunks")
    _cuda.reset_launch_counts()
    Rf, Kf = tnl.hyper_elem_residual_tangent(dom, d, material,
                                             MATERIALS[material])
    nloc = dom.n_basis() * dim
    assert Rf.shape == (dom.n_elements * nloc,)
    assert Kf.shape == (dom.n_elements * nloc ** 2,)
    chunks = timers.counters().get("hyper.autodiff_chunks", 0)
    assert _cuda.launch_counts["neo_hooke_p1"] == 0
    if material == "Neo-Hooke" and dim == 3 and fe == "P1":
        assert chunks == 0
    else:
        assert chunks == -(-dom.n_elements // 10) > 1


@pytest.mark.parametrize("dofs_per_node", [1, 3])
def test_device_dofs_cached_equal_host_ids(dofs_per_node):
    """Domain.device_dofs: the element dof ids (node ids for 1, NodeWise
    vector_dof_ids for 3) as int64 on the device, built once and reused."""
    from feddlib_tpu_torch.fe.assembly import vector_dof_ids

    dom = TDomain.structured(3, 2, device="cpu")
    ids = dom.device_dofs(dofs_per_node)
    host = (dom.elem_nodes() if dofs_per_node == 1
            else vector_dof_ids(dom.elem_nodes(), dofs_per_node))
    assert ids.dtype == torch.int64 and ids.device.type == "cpu"
    np.testing.assert_array_equal(ids.numpy(), host)
    assert dom.device_dofs(dofs_per_node, "cpu") is ids
