"""The cavity cell's plain reference (`reference/fem_ns.py`) against
mathematics it must satisfy, with no program in the loop: the Newton
Jacobian against central differences of the reference's own residual, and
the divergence block against the exact divergence of a quadratic field.
The cell's CPU rehearsal runs in `test_harness_cells.py`.

Run from the repository root: python -m pytest benchmark/tests -q
"""

import numpy as np
import pytest
import torch

from benchmark.reference import fem, fem_ns


@pytest.fixture(scope="module")
def cavity():
    return fem_ns.Cavity(3, 0.01)


def _state(cav, seed):
    """A seeded state that keeps the Dirichlet data."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(cav.n, generator=g, dtype=torch.float64)
    return torch.where(cav.D, cav.g, x)


def test_conical_rule_is_exact_to_degree_five():
    lam, w = fem_ns.conical_rule(3)
    assert np.isclose(w.sum(), 1.0) and (w > 0).all()
    assert np.allclose(lam.sum(axis=1), 1.0) and (lam >= 0).all()
    # int lambda^a / |T| = a! 3! / (a + 3)! over the tetrahedron
    for a, (i, j) in ((5, (1, 1)), (2, (2, 3)), (3, (0, 2))):
        got = (w * lam[:, i] ** (a - 1) * lam[:, j]).sum() if i != j else \
            (w * lam[:, i] ** a).sum()
        e = [0, 0, 0, 0]
        e[i] += a - 1 if i != j else a
        if i != j:
            e[j] += 1
        f = [np.prod(np.arange(1, k + 1)) for k in e]
        want = np.prod(f) * 6.0 / np.prod(np.arange(1, sum(e) + 4))
        assert np.isclose(got, want, rtol=1e-12)


def test_jacobian_is_the_residuals_derivative(cavity):
    """J(x) v against (F(x + h v) - F(x - h v)) / 2h: the residual is
    quadratic in the velocity, so the difference is exact up to rounding
    (the Newton term W is the convection's derivative)."""
    x = _state(cavity, 1)
    g = torch.Generator().manual_seed(2)
    v = torch.randn(cavity.n, generator=g, dtype=torch.float64)
    v = torch.where(cavity.D, torch.zeros_like(v), v)
    h = 1e-3
    fd = (cavity.residual(x + h * v) - cavity.residual(x - h * v)) / (2 * h)
    Jv = fem.matvec(cavity.jacobian(x), v)
    assert (Jv - fd).abs().max() <= 1e-10 * fd.abs().max()
    # the convection is there: J differs from the Stokes part
    stokes = fem_ns.Cavity(3, 0.01, density=0.0)
    assert (fem.matvec(stokes.jacobian(x), v) - Jv).abs().max() \
        > 1e-3 * Jv.abs().max()


def test_divergence_of_a_quadratic_field_is_exact(cavity):
    """B u = -M1 d for u = (x^2, y z, x z), whose divergence d = 3x + z is
    linear: a P2 field and a P1 divergence, both represented exactly, so
    -(div u, q) is the P1 mass matrix times d's nodal values."""
    p = cavity.m.points
    u = np.stack([p[:, 0] ** 2, p[:, 1] * p[:, 2], p[:, 0] * p[:, 2]], 1)
    x = torch.zeros(cavity.n, dtype=torch.float64)
    x[:cavity.n_u] = torch.as_tensor(u.reshape(-1))
    Bu = cavity.residual(x)[cavity.n_u:]
    from benchmark import inputs

    pts, elements = inputs.cube_mesh(3)
    m1 = fem.P1Mesh(pts, elements)
    M1 = fem.mass_matrix(m1, 1)
    d = torch.as_tensor(3 * pts[:, 0] + pts[:, 2])
    want = -fem.matvec(M1, d)
    assert (Bu - want).abs().max() <= 1e-13 * want.abs().max()


def test_dirichlet_rows_and_free_pressure(cavity):
    """Identity rows on every boundary velocity dof (the lid's value on
    z = 1), none on the pressure; the constant pressure is in the
    Jacobian's null space."""
    J = cavity.jacobian(_state(cavity, 3)).to_dense()
    D = cavity.D
    assert torch.equal(J[D][:, D], torch.eye(int(D.sum()),
                                             dtype=torch.float64))
    assert not D[cavity.n_u:].any()
    lid = cavity.g[:cavity.n_u].reshape(-1, 3)
    assert set(lid[:, 0].unique().tolist()) == {0.0, 1.0}
    one_p = torch.cat([torch.zeros(cavity.n_u, dtype=torch.float64),
                       torch.ones(cavity.n_p, dtype=torch.float64)])
    assert (J @ one_p).abs().max() <= 1e-14 * J.abs().max()


@pytest.mark.parametrize("fault", ["altered_answer", "altered_state",
                                   "rounded_f32"])
def test_cavity_fault_comes_out_not_correct(fault):
    """Each fault of `faults_ns.py`, planted underneath a whole rehearsal
    run of the cavity cell, makes `correct` false by the check it aims at
    (the answers' relres, or the steady state's Newton criterion)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.faults_ns", fault,
         "--workload", "cavity3d-p2p1-24.jacobian_solves", "--seed",
         "2147483711", "--seconds", "2", "--trace", "0", "--rehearse"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    check = "newton_criterion" if fault == "altered_state" else "relres_max"
    c = res["checks"][check]
    assert float(c["value"]) > c["limit"]
