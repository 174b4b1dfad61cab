"""The Arnoldi plan of the mixed-precision solve (solvers/krylov.py
`ArnoldiPlan`, solvers/linear.py `_arnoldi_plan`) on the CPU: when a plan
is made and dropped, the factored Arnoldi step of the eager GMRES loop
against the loop as it was written before the step was factored out, and
the mixed solve on the CPU, which makes no plan, against the JAX package.
The graphs themselves replay only on the card (tests/test_torch_gpu.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet  # noqa: E402
from feddlib_tpu.problems.laplace import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.solvers import refinement as jref  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector  # noqa: E402
from feddlib_tpu_torch.problems.laplace import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.solvers import krylov as tk  # noqa: E402
from feddlib_tpu_torch.solvers import linear  # noqa: E402
from feddlib_tpu_torch.utils import convert, timers  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

GRAPH_COUNTERS = ("krylov.graph_captures", "krylov.graph_replays")


@pytest.fixture
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _laplace(D, L, PL, n, clusters, **kw):
    pl = PL("P", {"Clusters": clusters, "Use Mixed Precision": True,
                  "TwoLevel": True})
    prob = L(D.structured(3, n, **kw), parameter_list=pl, **kw)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def _counts():
    c = timers.counters()
    return {k: c.get(k, 0) for k in GRAPH_COUNTERS + ("krylov.iterations",)}


# -- the decision ------------------------------------------------------------

def _scale_op(ops, x):
    return ops[0] * x


def _fake_cache(device):
    """What `_arnoldi_plan` reads of a mixed cache, with no tensor on a
    card: the cluster layout's device and the two padded operators."""
    return {"db32": SimpleNamespace(device=torch.device(device)),
            "A_op": (_scale_op, (2.0,)), "M_op": (_scale_op, (3.0,))}


def test_plan_made_on_reuse_and_dropped_by_refresh():
    cache = _fake_cache("cuda")
    # the solve that built (or refreshed) the cache runs the eager loop
    assert linear._arnoldi_plan(cache, reused=False) is None
    assert "arnoldi" not in cache
    plan = linear._arnoldi_plan(cache, reused=True)
    assert isinstance(plan, tk.ArnoldiPlan) and cache["arnoldi"] is plan
    assert plan.V is None  # nothing on the device before a solve uses it
    x = torch.ones(3)
    assert torch.equal(plan.A(x), 2 * x) and torch.equal(plan.M(x), 3 * x)
    # kept while the solves reuse the cache
    assert linear._arnoldi_plan(cache, reused=True) is plan
    # a with_data refresh drops it; the next reuse makes a fresh one
    assert linear._arnoldi_plan(cache, reused=False) is None
    assert "arnoldi" not in cache
    again = linear._arnoldi_plan(cache, reused=True)
    assert again is not plan and cache["arnoldi"] is again


def test_no_plan_for_operators_on_the_cpu():
    cache = _fake_cache("cpu")
    cache["arnoldi"] = object()
    assert linear._arnoldi_plan(cache, reused=True) is None
    assert "arnoldi" not in cache


def test_mixed_solve_reports_reuse_refresh_and_rebuild(blas1, monkeypatch):
    """`_mixed` asks for a plan with `reused` true only on a solve that
    neither refreshed the operator (`with_data`, after a reassembly marks
    the preconditioner stale) nor rebuilt the cache (a pattern change, or
    'Reuse Preconditioner': False)."""
    seen = []
    orig = linear._arnoldi_plan

    def spy(cache, reused):
        seen.append((reused, cache))
        return orig(cache, reused)

    monkeypatch.setattr(linear, "_arnoldi_plan", spy)
    prob = _laplace(TDomain, TLaplace, TPL, 6, 4, device="cpu")
    solve = lambda: prob.linear_solver.solve_system(prob, prob.rhs)  # noqa
    solve()                          # builds the cache
    solve()                          # reuses it
    prob._prec_stale = True          # a reassembly: with_data refresh
    solve()
    solve()
    prob._mixed_cache["pattern"] = object()  # another sparsity pattern
    solve()
    prob.parameter_list["Reuse Preconditioner"] = False
    prob._prec_stale = True          # a reassembly that rebuilds
    solve()
    assert [r for r, _ in seen] == [False, True, False, True, False, False]
    caches = [c for _, c in seen]
    assert caches[0] is caches[1] is caches[2] is caches[3]
    assert caches[4] is not caches[3] and caches[5] is not caches[4]
    assert all("arnoldi" not in c for c in caches)  # no plan on the CPU


def test_plan_refuses_left_preconditioning_and_an_axis():
    plan = tk.ArnoldiPlan(lambda x: x, lambda x: x)
    b = torch.ones(4)
    with pytest.raises(ValueError, match="right-preconditioned"):
        tk.gmres_loop(lambda x: x, lambda x: x, b, torch.zeros(4), 1e-8, 4,
                      4, left=True, plan=plan)
    with pytest.raises(ValueError, match="right-preconditioned"):
        tk.gmres_loop(lambda x: x, lambda x: x, b, torch.zeros(4), 1e-8, 4,
                      4, axis=SimpleNamespace(group=None), plan=plan)


# -- the eager loop ------------------------------------------------------------

def _loop_before_the_step_was_factored(A, M, b, x0, tol, restart, maxiter,
                                       left):
    """GMRES(m) with DGKS as `_gmres_loop` ran it op by op, with the
    Arnoldi step written inline (one process, no history)."""
    norm = tk._norm
    n = b.shape[0]
    m = min(restart, maxiter)
    hdt = np.dtype(str(b.dtype).replace("torch.", ""))
    bnorm = float(norm(M(b) if left else b))
    bnorm = 1.0 if bnorm == 0 else bnorm

    def residual(x):
        r = b - A(x)
        return M(r) if left else r

    def arnoldi_cycle(x):
        r = residual(x)
        beta_d = norm(r)
        beta = hdt.type(float(beta_d))
        V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta_d == 0, torch.ones_like(beta_d), beta_d)
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j, res = 0, beta
        while j < m and res / bnorm > tol:
            w = M(A(V[j])) if left else A(M(V[j]))
            Vj = V[: j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            wnorm = norm(w)
            V[j + 1] = w / torch.where(wnorm == 0, torch.ones_like(wnorm),
                                       wnorm)
            col = torch.cat([h1 + h2, wnorm[None]]).cpu().numpy()
            col = col.astype(hdt)
            H_col = np.zeros(m + 1, hdt)
            H_col[: j + 2] = col
            for i in range(j):
                hi = cs[i] * H_col[i] + sn[i] * H_col[i + 1]
                hip = -sn[i] * H_col[i] + cs[i] * H_col[i + 1]
                H_col[i], H_col[i + 1] = hi, hip
            a_, b_ = H_col[j], H_col[j + 1]
            rnorm = np.sqrt(a_ * a_ + b_ * b_)
            if rnorm == 0:
                c_new, s_new = hdt.type(1.0), hdt.type(0.0)
            else:
                c_new, s_new = a_ / rnorm, b_ / rnorm
            H_col[j], H_col[j + 1] = rnorm, 0.0
            cs[j], sn[j] = c_new, s_new
            gj = g[j]
            g[j], g[j + 1] = c_new * gj, -s_new * gj
            H[:, j] = H_col
            res = abs(g[j + 1])
            j += 1
        y = np.zeros(m, hdt)
        for i in range(j - 1, -1, -1):
            num = g[i] - H[i] @ y
            y[i] = num / (H[i, i] if H[i, i] != 0 else 1.0)
        dx = V[:j].T @ torch.as_tensor(y[:j], device=b.device)
        return x + (dx if left else M(dx)), j, float(res)

    x = x0
    total = 0
    res = float(norm(residual(x0)))
    while res / bnorm > tol and total < maxiter:
        x, j, res = arnoldi_cycle(x)
        total += j
    return x, total, res / bnorm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("left,restart", [(False, 100), (False, 7),
                                          (True, 7)])
def test_eager_loop_steps_through_arnoldi_step_bit_for_bit(
        monkeypatch, dtype, left, restart):
    K, b = host_poisson_dirichlet(JDomain.structured(3, 6))
    A = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                               device="cpu", dtype=dtype)
    dinv = torch.as_tensor(1.0 / K.diagonal(), dtype=dtype)
    M = lambda r: dinv * r  # noqa: E731
    bt = torch.as_tensor(b, dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    steps = []
    orig = tk.arnoldi_step

    def spy(*a, **k):
        steps.append(a[3])
        return orig(*a, **k)

    monkeypatch.setattr(tk, "arnoldi_step", spy)
    before = _counts()
    x, its, rel, _ = tk.gmres_loop(A.matvec, M, bt, torch.zeros_like(bt),
                                   tol, restart, 200, left=left)
    after = _counts()
    x0, its0, rel0 = _loop_before_the_step_was_factored(
        A.matvec, M, bt, torch.zeros_like(bt), tol, restart, 200, left)
    assert torch.equal(x, x0) and its == its0 and rel == rel0
    assert rel <= tol and len(steps) == its
    if restart < its:  # restarted: each cycle's steps count from 0
        assert steps[restart] == 0
    assert after["krylov.iterations"] - before["krylov.iterations"] == its
    for k in GRAPH_COUNTERS:
        assert after[k] == before[k]


# -- the mixed solve on the CPU ------------------------------------------------

def test_repeated_mixed_solves_on_cpu_match_jax_without_a_plan(
        blas1, monkeypatch):
    """Three solves of one system reuse the cache: on the CPU each runs the
    eager loop (no plan, no capture, no replay), and each matches the JAX
    package's solve — the same refinement passes, inner iterations within
    ±2 (f32 sums in another order), solutions within 1e-7 — and the first
    bit for bit."""
    passes = []
    orig = jref.iterative_refinement

    def spy(*a, **k):
        res = orig(*a, **k)
        passes.append(res.passes)
        return res

    monkeypatch.setattr(jref, "iterative_refinement", spy)
    pj = _laplace(JDomain, JLaplace, JPL, 10, 8)
    it_j = pj.solve()
    u_j = np.asarray(pj.solution[0])
    pt = _laplace(TDomain, TLaplace, TPL, 10, 8, device="cpu")
    before = _counts()
    first = None
    for _ in range(3):
        x, it_t = pt.linear_solver.solve_system(pt, pt.rhs)
        assert isinstance(x, BlockVector)
        u = x[0]
        assert pt.last_relres <= 1e-8 and pt.last_passes == passes[0]
        assert abs(it_t - it_j) <= 2
        assert np.abs(u.numpy() - u_j).max() < 1e-7
        if first is None:
            first = (u, it_t)
        assert torch.equal(u, first[0]) and it_t == first[1]
    after = _counts()
    assert "arnoldi" not in pt._mixed_cache
    for k in GRAPH_COUNTERS:
        assert after[k] == before[k]
    assert after["krylov.iterations"] - before["krylov.iterations"] \
        == 3 * first[1]
