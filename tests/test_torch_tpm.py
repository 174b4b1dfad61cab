"""The port's Biot poroelasticity (feddlib_tpu_torch.problems.tpm: TPM and
NonLinTPM) against the JAX package, on the consolidation scenarios of
tests/test_tpm_blockprec.py:19 and :165: a P2/P1 column, bottom clamped,
sides on rollers, top drained and loaded.  The pressure history p_hist
(max |p| after each step) and the final fields within 1e-8 of max |p| and
max |u|; Newton and GMRES iteration counts equal (f64 Jacobi-GMRES to
1e-9)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la.block import BlockVector as JBV  # noqa: E402
from feddlib_tpu.mesh.structured import \
    flag_boxed_boundary as j_flag  # noqa: E402
from feddlib_tpu.problems import tpm as jtpm  # noqa: E402
from feddlib_tpu.solvers import linear as jlin  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector as TBV  # noqa: E402
from feddlib_tpu_torch.mesh.structured import \
    flag_boxed_boundary as t_flag  # noqa: E402
from feddlib_tpu_torch.problems import NonLinTPM, TPM  # noqa: E402
from feddlib_tpu_torch.solvers import linear as tlin  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

BASE = {"Biot Alpha": 1.0, "Permeability": 1e-2, "Storativity": 1e-3,
        "dt": 0.05, "E": 1.0, "Poisson Ratio": 0.25,
        "Preconditioner Type": "Jacobi", "Convergence Tolerance": 1e-9}
FACES = {"x0": 4, "x1": 4, "y0": 2, "y1": 3}


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


def _consolidation(pkg, cls_name, params, load, t_end):
    """(p_hist, [u, p], linear iterations) of the column under a downward
    top traction `load`, run to t_end."""
    lin = jlin if pkg == "jax" else tlin
    log = []
    orig = lin.LinearSolver.solve_system

    def counted(self, problem, b):
        x, it = orig(self, problem, b)
        log.append(it)
        return x, it

    if pkg == "jax":
        dom_p = JDomain.structured(2, 4)
        flag, ops, BV, cls = j_flag, jops, JBV, getattr(jtpm, cls_name)
        pl, kw = JPL("P", dict(BASE, **params)), {}
        zero2 = (lambda x, t: jnp.zeros(2))
        zero1 = (lambda x, t: 0.0)
        trac = (lambda x: jnp.array([0.0, load]))
    else:
        dom_p = TDomain.structured(2, 4, device="cpu")
        flag, ops, BV = t_flag, tops, TBV
        cls = {"TPM": TPM, "NonLinTPM": NonLinTPM}[cls_name]
        pl, kw = TPL("P", dict(BASE, **params)), {"device": "cpu"}
        zero2 = (lambda x, t: [0.0, 0.0])
        zero1 = (lambda x, t: 0.0)
        trac = (lambda x: [0.0, load])
    dom_u = dom_p.p2_domain()
    for d in (dom_u, dom_p):
        flag(d.mesh, [0, 0], [1, 1], FACES)
    prob = cls(dom_u, dom_p, parameter_list=pl, **kw)
    prob.assemble()
    prob.add_bc(zero2, 2, 0)  # clamp the bottom
    prob.bc_builder.add_bc(zero1, 4, 0, dom_u, "Dirichlet_X", 2)
    prob.bc_builder.add_bc(zero1, 3, 1, dom_p, "Dirichlet", 1)
    f_load = ops.assemble_surface_rhs(dom_u, trac, flag=3, dofs_per_node=2)
    if pkg == "jax":
        f_ext = BV([f_load, jnp.zeros(dom_p.n_nodes)])
    else:
        f_ext = BV([f_load, torch.zeros(dom_p.n_nodes, dtype=torch.float64)])
    p_hist = []
    lin.LinearSolver.solve_system = counted
    try:
        prob.advance(t_end, observer=lambda t, s: p_hist.append(
            float(np.abs(np.asarray(s[1])).max())), f_ext=f_ext)
    finally:
        lin.LinearSolver.solve_system = orig
    return p_hist, [np.array(b) for b in prob.solution.blocks], log


@pytest.mark.parametrize("cls_name,params,load,t_end,steps", [
    ("TPM", {"Maximum Iterations": 6000}, -0.1, 0.25, 5),
    ("NonLinTPM", {"Material Model": "Neo-Hooke", "Maximum Iterations": 8000,
                   "MaxNonLinIts": 10}, -0.05, 0.15, 3),
])
def test_consolidation_matches_jax(cls_name, params, load, t_end, steps):
    pj, sj, lj = _consolidation("jax", cls_name, params, load, t_end)
    pt, st, lt = _consolidation("torch", cls_name, params, load, t_end)
    assert lt == lj
    assert len(pt) == steps
    assert _rel(pt, pj) < 1e-8
    assert _rel(st[0], sj[0]) < 1e-8 and _rel(st[1], sj[1]) < 1e-8
    # the anchors of tests/test_tpm_blockprec.py: pressure generated by
    # the load decays (consolidation), the column compresses
    assert pt[0] > 0 and pt[-1] < pt[0]
    d = st[0].reshape(-1, 2)
    assert d[:, 1].min() < 0 and np.isfinite(d).all()


def test_nonlin_tpm_hooks():
    """NonLinTPM's residual and reassembly exist only inside advance."""
    dom_p = TDomain.structured(2, 2, device="cpu")
    prob = NonLinTPM(dom_p.p2_domain(), dom_p, device="cpu")
    with pytest.raises(RuntimeError, match="advance"):
        prob.calculate_residual()
    with pytest.raises(RuntimeError, match="advance"):
        prob.reassemble()
