"""The plain reference against manufactured solutions, and the roofline's
byte count against padding."""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from benchmark import inputs, plugins, roofline
from benchmark.reference import checks, control, fem

F64 = torch.float64


def _scipy(A):
    return sps.csr_matrix((A.values().numpy(), A.col_indices().numpy(),
                           A.crow_indices().numpy()), shape=A.shape)


def test_mesh_volume_and_orientation():
    pts, el = inputs.cube_mesh(4)
    m = fem.P1Mesh(pts, el)
    assert el.shape == (6 * 4 ** 3, 4) and pts.shape == (5 ** 3, 3)
    assert float(m.vol.sum()) == pytest.approx(1.0, abs=1e-13)
    p = pts[el]
    det = np.linalg.det(np.stack([p[:, a] - p[:, 0] for a in (1, 2, 3)], 1))
    assert (det > 0).all()


def test_laplace_patch_test_and_convergence():
    """Linear functions are reproduced exactly on interior rows; the
    solution of -Lap u = 3 pi^2 sin sin sin converges at second order."""
    pts, el = inputs.cube_mesh(3)
    A = fem.laplace_matrix(fem.P1Mesh(pts, el))
    inner = inputs.point_flags(pts, {}) == 0
    lin = torch.as_tensor(1.0 + pts @ np.array([0.3, -1.2, 2.0]))
    assert float(fem.matvec(A, lin)[torch.as_tensor(inner)].abs().max()) \
        < 1e-13
    errs = []
    for n in (4, 8):
        pts, el = inputs.cube_mesh(n)
        m = fem.P1Mesh(pts, el)
        D = inputs.point_flags(pts, {}) == 1
        exact = np.prod(np.sin(np.pi * pts), axis=1)
        mass = _scipy(fem.mass_matrix(m, 1))
        b = mass @ (3 * np.pi ** 2 * exact)
        b[D] = 0.0
        K = _scipy(fem.laplace_matrix(m)).tolil()
        K[np.flatnonzero(D)] = 0.0
        K[np.flatnonzero(D), np.flatnonzero(D)] = 1.0
        x = spla.spsolve(K.tocsr(), b)
        rel = checks.laplace_relres(pts, el, D, [(b, x)])[0]
        assert rel < 1e-10
        errs.append(np.abs(x - exact).max())
    assert errs[0] / errs[1] > 3.0


def _energy(m, u, mu, lam):
    ue = u.reshape(m.n_nodes, 3)[m.elements]
    F = torch.eye(3, dtype=F64) + torch.einsum("eai,eaj->eij", ue, m.grads)
    J = torch.linalg.det(F)
    W = 0.5 * mu * ((F * F).sum((1, 2)) - 3) - mu * torch.log(J) \
        + 0.5 * lam * torch.log(J) ** 2
    return (m.vol * W).sum()


def test_neo_hooke_force_and_tangent_are_the_energy_derivatives():
    pts, el = inputs.cube_mesh(2)
    m = fem.P1Mesh(pts, el)
    mu, lam = fem.lame(1.0, 0.3)
    u = torch.as_tensor(np.random.default_rng(0).normal(
        scale=0.05, size=pts.size))
    assert float(fem.neo_hooke_force(m, 0 * u, mu, lam).abs().max()) < 1e-14
    g = torch.func.grad(lambda v: _energy(m, v, mu, lam))(u)
    H = torch.func.hessian(lambda v: _energy(m, v, mu, lam))(u)
    F = fem.neo_hooke_force(m, u, mu, lam)
    K = fem.neo_hooke_tangent(m, u, mu, lam).to_dense()
    assert torch.allclose(F, g, rtol=0, atol=1e-13 * float(g.abs().max()))
    assert torch.allclose(K, H, rtol=0, atol=1e-12 * float(H.abs().max()))


def test_bdf_judge_passes_a_converged_trajectory_and_fails_a_stale_step():
    pts, el = inputs.cube_mesh(3)
    D = np.repeat(inputs.point_flags(pts, {"x0": 2}) == 2, 3)
    mu, lam = fem.lame(1.0, 0.3)
    m = fem.P1Mesh(pts, el)
    body = plugins.load("loads", "body_force").Loads(
        pts, None, {"amplitude": 0.3, "period_steps": 8,
                    "directions": [[0.0, 0.0, -1.0]]}, 1, {})
    loads = [fem.body_force(m, body.density(n)) for n in range(1, 5)]
    states = control.bdf_states(pts, el, D, mu, lam, 1.0, loads,
                                tol=1e-10, dtype=F64)
    bdf = checks.Bdf(pts, el, D, mu, lam, 1.0)
    assert max(bdf.ratios(states, loads)) < 1e-9
    assert float(np.abs(states[-1][D]).max()) == 0.0
    stale = states[:2] + [states[1]] + states[3:]
    assert bdf.ratios(stale, loads)[2] > 0.1


def test_b3_bytes_do_not_see_padding():
    """The same three clusters laid out with two paddings."""
    rows, ghosts = np.array([5, 7, 3]), np.array([4, 2, 6])
    n = int(rows.sum())

    def layout(R, G):
        old_of_pad = np.full(3 * R, n)
        ghost_idx = np.full((3, G), 3 * R)
        start = 0
        for p in range(3):
            old_of_pad[p * R:p * R + rows[p]] = np.arange(start,
                                                          start + rows[p])
            ghost_idx[p, :ghosts[p]] = (p + 1) % 3 * R
            start += rows[p]
        return roofline.unpadded_blocks(old_of_pad, ghost_idx, n, R)

    a, b = layout(8, 8), layout(16, 24)
    assert (a[0] == rows).all() and (a[1] == rows + ghosts).all()
    assert roofline.b3_bytes(*a) == roofline.b3_bytes(*b) == \
        4 * float((rows * (rows + ghosts) + 2 * rows + ghosts).sum())
    padded = 4.0 * 3 * 16 * 40
    assert roofline.b3_bytes(*b) < padded
