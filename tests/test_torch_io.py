"""The port's output and utility modules against the JAX package's:
feddlib_tpu_torch/io/exporter.py (ParaView HDF5 + XDMF, the text series),
utils/timers.py and utils/reference_compat.py.

Exporter: both packages write the same inputs (numpy, seeded; the port's
as tensors); every HDF5 dataset is bitwise equal and the .xmf text
identical: the tests/test_components.py:21 scenario, a P2 field with
`subsample_p1`, and 3D P1 / P2.  ExporterTxt files are identical.
Timers: the tests/test_tpm_blockprec.py:138 scenario, with the nesting
paths, call counts and report rows equal to JAX's.  reference_compat:
the JAX anchors (tests/test_schwarz.py:160, tests/test_ipou.py:81) read
reference XMLs that are absent, so an XML with the same sublists is
written to tmp_path and both translations must be equal."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import h5py  # noqa: E402
import jax.numpy as jnp  # noqa: E402, F401
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.io.exporter import ExporterParaView as JExp  # noqa: E402
from feddlib_tpu.io.exporter import ExporterTxt as JTxt  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.io import ExporterParaView as TExp  # noqa: E402
from feddlib_tpu_torch.io import ExporterTxt as TTxt  # noqa: E402


def _h5(path):
    with h5py.File(path) as f:
        return {k: f[k][()] for k in f.keys()}


def _same_output(tmp_path, stem, jdom, tdom, variables, steps, **kw):
    """Write `steps` [(t, {var: array})] through both exporters; the
    datasets bitwise equal, the .xmf text identical."""
    outs = {}
    for pkg, cls, dom in (("jax", JExp, jdom), ("torch", TExp, tdom)):
        base = str(tmp_path / pkg / stem)
        exp = cls(dom, base, **kw)
        for v, d in variables:
            exp.add_variable(v, d)
        for t, vals in steps:
            exp.save(t, {k: (v if pkg == "jax" else torch.as_tensor(v))
                         for k, v in vals.items()})
        exp.close()
        with open(base + ".xmf") as f:
            outs[pkg] = (_h5(base + ".h5"), f.read())
    (hj, xj), (ht, xt) = outs["jax"], outs["torch"]
    assert xt == xj
    assert sorted(ht) == sorted(hj)
    for k in hj:
        assert ht[k].dtype == hj[k].dtype and np.array_equal(ht[k], hj[k]), k
    return ht


def test_exporter_paraview_components_scenario(tmp_path):
    """tests/test_components.py:21: a scalar and a 2D vector, two steps."""
    jdom, tdom = JDomain.structured(2, 4), TDomain.structured(2, 4,
                                                              device="cpu")
    u = np.linspace(0, 1, jdom.n_nodes)
    v = np.ones(jdom.n_dofs(2))
    h = _same_output(tmp_path, "out", jdom, tdom, [("u", 1), ("v", 2)],
                     [(0.0, {"u": u, "v": v}), (0.5, {"u": u * 2, "v": v})],
                     name="sol")
    assert h["points"].shape == (jdom.n_nodes, 3)
    assert h["v_0"].shape == (jdom.n_nodes, 3)


@pytest.mark.parametrize("dim,fe,sub", [(2, "P2", True), (2, "P2", False),
                                        (3, "P1", False), (3, "P2", True)])
def test_exporter_paraview_p2_and_3d(tmp_path, dim, fe, sub):
    jdom = JDomain.structured(dim, 3, fe_type=fe)
    tdom = TDomain.structured(dim, 3, fe_type=fe, device="cpu")
    rng = np.random.default_rng(dim * 10 + sub)
    steps = [(t, {"s": rng.standard_normal(jdom.n_nodes),
                  "w": rng.standard_normal(jdom.n_dofs(dim))})
             for t in (0.0, 0.25)]
    h = _same_output(tmp_path, f"f{dim}{fe}{sub}", jdom, tdom,
                     [("s", 1), ("w", dim)], steps, subsample_p1=sub)
    n = (jdom.parent_p1.n_nodes if sub else jdom.n_nodes)
    assert h["s_1"].shape == (n,)


def test_exporter_txt_identical(tmp_path):
    rng = np.random.default_rng(3)
    rows = [(0.02 * i, *rng.standard_normal(3)) for i in range(5)]
    for pkg, cls in (("jax", JTxt), ("torch", TTxt)):
        ext = cls(str(tmp_path / pkg / "obs.txt"))
        for r in rows:
            ext.write(r[0], *(torch.as_tensor(v) if pkg == "torch" else v
                              for v in r[1:]))
        ext.close()
    assert ((tmp_path / "torch" / "obs.txt").read_text()
            == (tmp_path / "jax" / "obs.txt").read_text())


def _timed(timers):
    timers.reset()
    with timers.timer("outer"):
        with timers.timer("inner"):
            sum(range(1000))
        with timers.timer("inner"):
            pass
        with timers.timer("other"):
            with timers.timer("deep"):
                pass
    with timers.timer("second"):
        pass
    tot = timers.totals()
    rows = [ln.rsplit(None, 3)[0] + " " + ln.split()[-2]
            for ln in timers.report().splitlines()]
    timers.reset()
    return tot, rows, timers.report()


def test_timers_match_jax():
    """tests/test_tpm_blockprec.py:138, and the same paths, call counts and
    report rows (names indented by depth, calls) as JAX's registry."""
    from feddlib_tpu.utils import timers as jt
    from feddlib_tpu_torch.utils import timers as tt

    jtot, jrows, jempty = _timed(jt)
    ttot, trows, tempty = _timed(tt)
    assert sorted(ttot) == sorted(jtot) == [
        "outer", "outer/inner", "outer/other", "outer/other/deep", "second"]
    assert ttot["outer"] >= ttot["outer/inner"]
    assert trows == jrows and tempty == jempty == "(no timers)"


def test_profile_trace_writes_annotated_trace(tmp_path):
    """`profile_trace` writes a Chrome trace holding each timer scope as a
    range named `fedd/<name>` (on the CPU here: CPU activity only); once
    the profile has ended, a scope opens no range."""
    from feddlib_tpu_torch.utils import timers

    timers.reset()
    with timers.profile_trace(str(tmp_path)) as prof:
        with timers.timer("solve"):
            with timers.timer("apply"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert {"fedd/solve", "fedd/apply"} <= names
    text = (tmp_path / "trace.json").read_text()
    assert '"fedd/apply"' in text
    assert set(timers.totals()) == {"solve", "solve/apply"}
    assert not torch.autograd._profiler_enabled()
    with timers.timer("after") as span:
        pass
    assert span._ann is None
    timers.reset()


_PREC_XML = """<ParameterList name="Preconditioner">
  <ParameterList name="ThyraPreconditioner">
    <ParameterList name="Preconditioner Types">
      <ParameterList name="FROSch">
        <Parameter name="Overlap" type="int" value="2"/>
        <Parameter name="TwoLevel" type="bool" value="true"/>
        <Parameter name="Level Combination" type="string" value="Multiplicative"/>
        <Parameter name="Null Space Type" type="string" value="Laplace"/>
        <Parameter name="CoarseOperator Type" type="string" value="{cot}"/>
        <ParameterList name="AlgebraicOverlappingOperator">
          <Parameter name="Combine Values in Overlap" type="string" value="Averaging"/>
        </ParameterList>
        <ParameterList name="{cot}">
          <ParameterList name="Distribution">
            <Parameter name="NumProcs" type="int" value="2"/>
            <Parameter name="GatheringSteps" type="int" value="1"/>
          </ParameterList>
          <ParameterList name="CoarseSolver">
            <Parameter name="SolverType" type="string" value="{solver}"/>
          </ParameterList>
          <ParameterList name="Blocks">
            <ParameterList name="1">
              <ParameterList name="InterfacePartitionOfUnity">
                <Parameter name="Type" type="string" value="GDSW"/>
                <ParameterList name="GDSW">
                  <ParameterList name="Custom">
                    <Parameter name="Vertices" type="bool" value="true"/>
                    <Parameter name="Edges" type="bool" value="false"/>
                    <Parameter name="ShortEdges" type="bool" value="true"/>
                    <Parameter name="Faces" type="bool" value="false"/>
                  </ParameterList>
                </ParameterList>
              </ParameterList>
            </ParameterList>
          </ParameterList>
        </ParameterList>
      </ParameterList>
    </ParameterList>
  </ParameterList>
</ParameterList>
"""

_SOLVER_XML = """<ParameterList name="Solver">
  <ParameterList name="ThyraSolver">
    <ParameterList name="Linear Solver Types">
      <ParameterList name="Belos">
        <ParameterList name="Solver Types">
          <ParameterList name="{name}">
            <Parameter name="Convergence Tolerance" type="double" value="1e-9"/>
            <Parameter name="Maximum Iterations" type="int" value="321"/>
            <Parameter name="Num Blocks" type="int" value="55"/>
          </ParameterList>
        </ParameterList>
      </ParameterList>
    </ParameterList>
  </ParameterList>
</ParameterList>
"""

_PROBLEM_XML = """<ParameterList name="Problem">
  <ParameterList name="Parameter">
    <Parameter name="Viscosity" type="double" value="0.01"/>
    <Parameter name="Dimension" type="int" value="2"/>
    <Parameter name="Model" type="string" value="Laplace"/>
    <ParameterList name="Nested">
      <Parameter name="Ignored" type="int" value="1"/>
    </ParameterList>
  </ParameterList>
</ParameterList>
"""


@pytest.mark.parametrize("cot,solver,name", [
    ("GDSWCoarseOperator", "Amesos2", "Block GMRES"),
    ("RGDSWCoarseOperator", "Belos", "Pseudo Block CG"),
    ("IPOUHarmonicCoarseOperator", "Amesos2", "GMRES"),
])
def test_reference_compat_translations_equal(tmp_path, cot, solver, name):
    from feddlib_tpu.utils.reference_compat import \
        load_reference_configs as jload
    from feddlib_tpu_torch.utils.reference_compat import \
        load_reference_configs as tload

    files = {"problem": _PROBLEM_XML,
             "prec": _PREC_XML.format(cot=cot, solver=solver),
             "solver": _SOLVER_XML.format(name=name)}
    paths = {}
    for k, text in files.items():
        paths[k] = str(tmp_path / f"parameters_{k}.xml")
        with open(paths[k], "w") as f:
            f.write(text)
    args = (paths["problem"], paths["prec"], paths["solver"])
    j, t = jload(*args), tload(*args)
    jd, td = dict(j.items()), dict(t.items())
    assert td == jd
    assert [type(v) for v in td.values()] == [type(v) for v in jd.values()]
    assert td["Overlap"] == 2 and td["Maximum Iterations"] == 321
    assert td["Coarse NumProcs"] == 2
    # one file at a time, and flat fallbacks
    assert dict(tload(None, paths["prec"]).items()) == dict(
        jload(None, paths["prec"]).items())
    assert dict(tload().items()) == dict(jload().items()) == {}
