"""The port's spans and counters (feddlib_tpu_torch/utils/timers.py) on the
paths that carry them: the span tree of a two-level mixed Laplace solve and
of one hyperelastic BDF2 step, with ids, parents and roots, the counters
against what the solvers return, the cost-free state without a subscriber,
the `fedd/<name>` ranges under torch.profiler, and the synchronising form
on the card (marker `gpu`).  No JAX: these are properties of the port."""

import gc
import threading

import pytest
import torch

torch.set_num_threads(2)

from feddlib_tpu_torch.fe.domain import Domain  # noqa: E402
from feddlib_tpu_torch.la import _cuda  # noqa: E402
from feddlib_tpu_torch.problems.laplace import Laplace  # noqa: E402
from feddlib_tpu_torch.solvers import krylov  # noqa: E402
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


@pytest.fixture
def records():
    """Every record the registry delivers while the test runs."""
    got = []
    timers.subscribe(got.append)
    try:
        yield got
    finally:
        timers.unsubscribe(got.append)


def _spans(records, name=None):
    return [r for r in records if isinstance(r, timers.Span)
            and (name is None or r.name == name)]


def _count(records, name):
    return sum(r.n for r in records if isinstance(r, timers.CountRecord)
               and r.name == name)


def _check_tree(spans):
    """Ids unique; each parent closed around its child; one root."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.parent is None]
    assert len(roots) == 1 and roots[0].root == roots[0].id
    for s in spans:
        assert s.root == roots[0].id and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.path == p.path + "/" + s.name
    return by_id


def _laplace(n=8, clusters=8):
    pl = ParameterList("P", {"Clusters": clusters,
                             "Use Mixed Precision": True, "TwoLevel": True})
    prob = Laplace(Domain.structured(3, n, device="cpu"), parameter_list=pl,
                   device="cpu")
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


def test_mixed_solve_span_tree_and_counters(records):
    prob = _laplace()
    records.clear()  # the assembly's `fe.pattern` spans: a tree of their own
    its = prob.solve()
    spans = _spans(records)
    by_id = _check_tree(spans)
    parent = {}
    for s in spans:
        parent.setdefault(s.name, set()).add(
            by_id[s.parent].name if s.parent else None)
    assert parent["solve.mixed"] == {None}
    assert parent["refinement.pass"] == {"solve.mixed"}
    assert parent["krylov.gmres"] == {"refinement.pass"}
    assert parent["precond.apply"] == {"krylov.gmres"}
    assert parent["operator.apply"] == {"krylov.gmres"}
    assert parent["krylov.sync"] == {"krylov.gmres"}
    # the cache build: partition, layout and the preconditioner's parts
    for name in ("mixed.partition", "mixed.layout", "prec.setup"):
        assert parent[name] == {"solve.mixed"}
    for name in ("prec.level1", "prec.gdsw", "prec.coarse_layout"):
        assert parent[name] == {"prec.setup"}
    iters = _count(records, "krylov.iterations")
    cycles = _count(records, "krylov.cycles")
    passes = _count(records, "refinement.passes")
    assert its > 0 and iters == its
    assert passes == prob.last_passes >= 1
    assert len(_spans(records, "refinement.pass")) == passes
    assert len(_spans(records, "krylov.gmres")) == passes
    assert len(_spans(records, "krylov.sync")) == iters
    assert len(_spans(records, "precond.apply")) == iters + cycles
    # one A(x) for each pass's first residual, one a restart, one an
    # iteration
    assert len(_spans(records, "operator.apply")) == passes + cycles + iters
    # the preconditioner's timings are its spans' seconds
    prec = prob._mixed_cache["prec"]
    for key, name in (("level1_s", "prec.level1"), ("gdsw_s", "prec.gdsw"),
                      ("coarse_layout_s", "prec.coarse_layout")):
        assert prec.timings[key] == _spans(records, name)[0].seconds > 0
    # a second solve reuses the cache: a new root, no set-up spans
    first = spans[-1].root
    records.clear()
    assert prob.solve() == _count(records, "krylov.iterations")
    spans = _spans(records)
    _check_tree(spans)
    assert spans[-1].root != first
    assert not {"mixed.partition", "mixed.layout", "prec.setup"} & {
        s.name for s in spans}


def test_bdf2_step_span_tree_and_counters(records, monkeypatch):
    from feddlib_tpu_torch.fe import ops
    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary
    from feddlib_tpu_torch.problems import nonlin_elasticity
    from feddlib_tpu_torch.solvers import nonlinear, timestepping

    dom = Domain.structured(3, 3, device="cpu")
    flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
    pl = ParameterList("Parameters", {
        "Material Model": "Neo-Hooke", "E": 1.0, "Poisson Ratio": 0.3,
        "Use Mixed Precision": True, "TwoLevel": True,
        "Null Space Type": "elasticity", "Clusters": 8,
        "Convergence Tolerance": 1e-10})
    prob = nonlin_elasticity.NonLinElasticity(dom, parameter_list=pl,
                                              device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: [0.0, 0.0, 0.0], 2, 0)
    f = ops.assemble_rhs(dom, lambda x: [0.0, 0.0, -0.05], 3)
    records.clear()  # the assembly's `fe.pattern` spans: a tree of their own
    returned = []
    solve = nonlinear.NonLinearSolver.solve

    def spy(self, problem, t=0.0):
        returned.append(solve(self, problem, t))
        return returned[-1]

    monkeypatch.setattr(nonlinear.NonLinearSolver, "solve", spy)
    seen = []

    def observer(t, u):
        seen.append(len(_spans(records, "time.step")))

    drv = timestepping.DAESolverInTime(
        timestepping.TimeProblem(prob), 0.5, 0.5,
        rhs_func=lambda t: BlockVector([f * t]), observer=observer)
    drv.advance_nonlinear_bdf(order=2)
    assert seen == [1]  # the step's span closed before the observer
    spans = _spans(records)
    by_id = _check_tree(spans)
    step = _spans(records, "time.step")[0]
    assert step.parent is None
    (newton,) = _spans(records, "newton.solve")
    assert newton.parent == step.id
    for name in ("newton.residual", "newton.tangent", "newton.linear_solve"):
        assert {by_id[s.parent].name for s in _spans(records, name)} == {
            "newton.solve"}
    assert {by_id[s.parent].name for s in _spans(records, "solve.mixed")} \
        == {"newton.linear_solve"}
    its = _count(records, "newton.iterations")
    assert returned == [its] and its >= 1
    back = _count(records, "newton.backtracks")
    assert len(_spans(records, "newton.residual")) == 1 + its + back
    assert len(_spans(records, "newton.tangent")) == its
    assert len(_spans(records, "newton.linear_solve")) == its


def test_no_subscriber_builds_no_record_and_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("built without a subscriber or a profiler")

    monkeypatch.setattr(timers, "CountRecord", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    timers.reset()
    timers.reset_counters()
    A = torch.diag(torch.arange(1.0, 41.0, dtype=torch.float64))
    b = torch.ones(40, dtype=torch.float64)
    with timers.timer("outer") as outer:
        res = krylov.gmres(lambda x: A @ x, b, M=lambda x: x / A.diagonal(),
                           tol=1e-10)
    assert res.converged and outer.seconds > 0
    # no closed span of the solve is kept
    kept = [o for o in gc.get_objects() if isinstance(o, timers.Span)
            and o is not outer and getattr(o, "root", None) == outer.id]
    assert kept == []
    assert timers.counters()["krylov.iterations"] == res.iters
    # unobserved, the loop opens no span inside an iteration
    assert not timers.observed()
    assert set(timers.totals()) == {"outer", "outer/krylov.gmres"}
    timers.reset()
    timers.reset_counters()


def test_a_profiler_alone_observes_the_iterations():
    from torch.profiler import ProfilerActivity, profile

    A = torch.diag(torch.arange(1.0, 41.0))
    b = torch.ones(40)
    timers.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timers.observed()
        res = krylov.gmres(lambda x: A @ x, b, M=lambda x: x / A.diagonal(),
                           tol=1e-6)
    names = {e.key for e in prof.key_averages()}
    assert {"fedd/krylov.gmres", "fedd/operator.apply", "fedd/precond.apply",
            "fedd/krylov.sync"} <= names
    assert timers._totals["krylov.gmres/krylov.sync"][1] == res.iters
    timers.reset()


def test_spans_are_ranges_under_the_profiler(records):
    """Each span is a host event `fedd/<name>` of the profile that holds
    its child spans' events and the operators it issued."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    A = torch.diag(torch.arange(1.0, 41.0))
    b = torch.ones(40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # aten::addmv in A alone (Gram-Schmidt's products are aten::mv)
        krylov.gmres(lambda x: torch.addmv(b, A, x, beta=0.0), b,
                     M=lambda x: x / A.diagonal(), tol=1e-6)
    spans = _spans(records)
    by_id = _check_tree(spans)
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
    events = {}
    for name, a, z in sorted(host, key=lambda h: h[1]):
        if name.startswith(timers.ANNOTATION_PREFIX):
            events.setdefault(name[len(timers.ANNOTATION_PREFIX):],
                              []).append((a, z))
    assert {k: len(v) for k, v in events.items()} == {
        n: len(_spans(records, n)) for n in {s.name for s in spans}}
    # the k-th span of a name is the k-th range of that name
    where = {}
    for name in events:
        for s, ev in zip(_spans(records, name), events[name]):
            where[s.id] = ev
    for s in spans:
        if s.parent is not None:
            (a, z), (pa, pz) = where[s.id], where[by_id[s.parent].id]
            assert pa <= a and z <= pz
    mvs = [(a, z) for name, a, z in host if name == "aten::addmv"]
    applies = events["operator.apply"]
    assert mvs and all(any(pa <= a and z <= pz for pa, pz in applies)
                       for a, z in mvs)


def test_stacks_are_per_thread(records):
    def work():
        with timers.timer("thread.outer"):
            with timers.timer("thread.inner"):
                pass

    with timers.timer("main.outer"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        timers.count("main.count", 3)
    inner, = _spans(records, "thread.inner")
    outer, = _spans(records, "thread.outer")
    main, = _spans(records, "main.outer")
    assert outer.parent is None and outer.root == outer.id != main.id
    assert inner.parent == outer.id and inner.path == "thread.outer/" \
        "thread.inner"
    count, = [r for r in records if isinstance(r, timers.CountRecord)]
    assert (count.name, count.n) == ("main.count", 3)


def test_launch_counts_read_the_registry():
    _cuda.reset_launch_counts()
    timers.count("other.counter", 2)
    timers.count("kernel.sell_spmv")
    timers.count("kernel.sell_spmv")
    assert _cuda.launch_counts["sell_spmv"] == 2
    assert dict(_cuda.launch_counts) == {k: 2 * (k == "sell_spmv")
                                         for k in _cuda.KERNELS}
    _cuda.reset_launch_counts()
    assert all(v == 0 for v in _cuda.launch_counts.values())
    assert timers.counters()["other.counter"] >= 2
    with pytest.raises(KeyError):
        _cuda.launch_counts["no_such_kernel"]
    timers.reset_counters("other.counter")
    assert "other.counter" not in timers.counters()


@pytest.mark.gpu
def test_sync_span_synchronises_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x = torch.ones(1024, device="cuda")
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a) or real(*a))
    with timers.timer("plain"):
        x.sum()
    assert calls == []
    with timers.timer("synced", sync=True) as span:
        x.sum()
    assert len(calls) == 2 and span.seconds > 0


# -- the set-up spans that replaced the bring-up's `timings` dicts ----------

def _f64_two_level():
    prob = _laplace_with({"Subdomains": 4})
    prob.solve()
    prec = prob.preconditioner.prec
    assert type(prec).__name__ == "TwoLevelSchwarz"
    return [prec, prec.level1]


def _one_level():
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner

    prob = _laplace_with({})
    A = prob.bc_system().get_block(0, 0)
    part = MeshPartition(prob.domains[0].mesh, 4)
    return [SchwarzPreconditioner(A, part.unique_map)]


def _distributed():
    prob = _laplace_with({"Use Distributed Solve": True, "Devices": 4,
                          "Preconditioner Type": "SchwarzTwoLevel"})
    prob.solve()
    cache = prob._dist_cache
    assert "timings" not in cache
    return [cache["dmat"], cache["precond"][0]]


def _pipeline():
    prob = _laplace_with({"Use Distributed Solve": True, "Devices": 4,
                          "Use Device Pipeline": True,
                          "Preconditioner Type": "SchwarzTwoLevel"})
    prob.solve()
    pc, pp = prob._pipe_cache, prob._pipe_prec
    assert "timings" not in pc and "precond_s" not in pp
    return [pc["pipe"], pp["precond"][0]]


def _facsi():
    from feddlib_tpu_torch.precond.facsi import FaCSIPreconditioner
    from feddlib_tpu_torch.problems.fsi import FSI
    from feddlib_tpu_torch.scenarios import two_box

    dom_u, dom_p, dom_d, flag = two_box(3, "cpu")
    prob = FSI(dom_u, dom_p, dom_d, [flag], parameter_list=ParameterList(
        "P", {"dt": 0.02, "Viscosity": 0.5, "E": 5.0}), device="cpu")
    prob.assemble()
    prob.init_vectors()
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 2)
    prob._build_system("Newton", torch.zeros_like(prob.solution[0]),
                       1.0 / prob.dt, 1.0 / (prob.newmark_beta * prob.dt ** 2))
    pre = FaCSIPreconditioner(prob, prob.bc_system(), 2)
    return [pre, pre.solid_prec, pre.fluid_prec]


def _split_dia():
    """An operator whose residue is not node-blocked
    (tests/test_torch_formats.py)."""
    import numpy as np
    import scipy.sparse as sps

    from feddlib_tpu_torch.la.dia import SplitDiaMatrix

    rng = np.random.default_rng(11)
    nn, d = 400, 3
    n = nn * d
    band = sps.diags([np.ones(nn - 1), 2 * np.ones(nn), np.ones(nn - 1)],
                     [-1, 0, 1])
    blocks = sps.kron(band, rng.random((d, d)) + 1).tocsr()
    i = rng.integers(0, nn - 6, 60)
    j = i + rng.integers(2, 6, 60)
    far = sps.csr_matrix((rng.random(60), (i * d, j * d)), (n, n))
    A = (blocks + far + far.T).tocsr()
    A.sort_indices()
    F = SplitDiaMatrix.from_csr(A, dtype=torch.float64, dofs_per_node=d,
                                device="cpu")
    assert isinstance(F, SplitDiaMatrix)
    return [F, F.with_data(torch.as_tensor(A.data))]


def _laplace_with(params, n=6):
    prob = Laplace(Domain.structured(3, n, device="cpu"),
                   parameter_list=ParameterList("P", params), device="cpu")
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


_L1 = {"prec.overlap": "prec.level1", "prec.factor": "prec.level1"}
_DIST_L1 = {"prec.overlap": "prec.level1", "prec.overlap_plan": "prec.level1",
            "prec.blocks": "prec.level1", "prec.factor": "prec.level1",
            "prec.level1": "dist.precond", "prec.gdsw": "dist.precond",
            "prec.phi": "dist.precond", "prec.coarse_solver": "dist.precond",
            "dist.precond": None}
_PIPE = {"pipe." + k: "pipe.finalize" for k in (
    "keys", "patterns", "send", "rounds", "ell", "halo", "geometry",
    "fields")}


@pytest.mark.parametrize("build,tree", [
    (_f64_two_level, dict(_L1, **{"prec.level1": None, "prec.gdsw": None})),
    (_one_level, {"prec.overlap": None, "prec.factor": None}),
    (_distributed, dict(_DIST_L1, **{
        "dist.partition": None, "dist.matrix": None,
        "dist.rows": "dist.matrix", "dist.halo_plan": "dist.matrix",
        "dist.ell": "dist.matrix"})),
    (_pipeline, dict(_DIST_L1, **_PIPE, **{
        "pipe.partition": None, "pipe.finalize": None})),
    (_facsi, {"facsi.solid": None, "facsi.fluid": None,
              "prec.overlap": ("facsi.solid", "facsi.fluid"),
              "prec.factor": ("facsi.solid", "facsi.fluid"),
              "block.merge": "facsi.fluid"}),
    (_split_dia, {"split." + k: None for k in (
        "rcm", "permute", "dia_layout", "sell_layout", "gathers")}),
], ids=["f64_two_level", "one_level", "distributed", "pipeline", "facsi",
        "split_dia"])
def test_setup_spans_replace_the_timings(records, build, tree):
    """A build opens each set-up span of its part once (FaCSI's two
    Schwarz builds each open theirs), synchronised, nested under the span
    of the part it belongs to, and leaves no `timings` attribute: the
    registry is the only measurement (utils/timers.py)."""
    built = build()
    spans = [s for s in _spans(records) if s.name in tree]
    by_id = {s.id: s for s in _spans(records)}
    got = {}
    for s in spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        got.setdefault(s.name, []).append(parent)
        assert s.sync and s.end_ns >= s.start_ns, s.name
    for name, parent in tree.items():
        want = list(parent) if isinstance(parent, tuple) else [parent]
        assert got.get(name) == want, (name, got.get(name))
    assert not [type(o).__name__ for o in built if hasattr(o, "timings")]
