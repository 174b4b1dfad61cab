"""The port's native host library (feddlib_tpu_torch/native) against the
JAX package's and against the port's own numpy versions.

- from_coo: feddlib_tpu_torch.la.csr.SparsityPattern.from_coo (native,
  row-bucketed) against the JAX package's from_coo (native or numpy,
  whichever route it takes) and the port's from_coo_plain: indptr,
  indices and coo_slots bitwise equal, on FE patterns and edge cases.
- read_mesh: the port's (native parser) against the JAX package's and the
  port's read_mesh_plain, P1 and P2, on MEDIT files written to tmp_path;
  a missing and a non-MEDIT file raise the JAX package's exception types.
- rcb: native.rcb against the JAX package's native.rcb and rcb_plain.
- the build: under feddlib_tpu_torch/_build/, nothing next to the source,
  two processes building at once, and a compiler that fails raises
  RuntimeError (no numpy fallback)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from feddlib_tpu import native as jnative  # noqa: E402
from feddlib_tpu.la.csr import SparsityPattern as JPattern  # noqa: E402
from feddlib_tpu.mesh.io import read_mesh as j_read_mesh  # noqa: E402

from feddlib_tpu_torch import native  # noqa: E402
from feddlib_tpu_torch import scenarios  # noqa: E402
from feddlib_tpu_torch.fe.assembly import vector_dof_ids  # noqa: E402
from feddlib_tpu_torch.la.csr import SparsityPattern  # noqa: E402
from feddlib_tpu_torch.mesh.io import read_mesh, read_mesh_plain, write_mesh  # noqa: E402
from feddlib_tpu_torch.mesh.p2 import build_p2_mesh  # noqa: E402
from feddlib_tpu_torch.mesh.structured import build_structured_mesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH_FIELDS = ("points", "point_flags", "elements", "element_flags",
               "surfaces", "surface_flags", "lines", "line_flags",
               "p2_edges")


def _scatter(rdofs, cdofs):
    """The (element, test, trial) COO of an element-matrix scatter."""
    E, nr = rdofs.shape
    nc = cdofs.shape[1]
    return (np.broadcast_to(rdofs[:, :, None], (E, nr, nc)).ravel(),
            np.broadcast_to(cdofs[:, None, :], (E, nr, nc)).ravel())


def _coo_case(name):
    """(rows, cols, n_rows, n_cols) of one case."""
    rng = np.random.default_rng(7)
    if name == "p1_laplace":
        el = build_structured_mesh(3, 8).elements
        n = int(el.max()) + 1
        return (*_scatter(el, el), n, n)
    if name == "p2_elasticity":
        el = build_p2_mesh(build_structured_mesh(3, 4)).elements
        dofs = vector_dof_ids(el, 3)
        n = 3 * (int(el.max()) + 1)
        return (*_scatter(dofs, dofs), n, n)
    if name == "stokes_b":
        m2 = build_p2_mesh(build_structured_mesh(2, 6))
        vel = vector_dof_ids(m2.elements, 2)
        pre = m2.elements[:, :3]
        return (*_scatter(pre, vel), int(pre.max()) + 1,
                2 * (int(m2.elements.max()) + 1))
    if name == "shuffled_duplicates":
        rows = rng.integers(0, 30, 50_000)
        cols = rng.integers(0, 40, 50_000)
        return rows, cols, 30, 40
    if name == "empty_rows":
        rows = 3 * rng.integers(0, 20, 2_000) + 1
        cols = rng.integers(0, 500, 2_000)
        return rows, cols, 64, 500
    if name == "one_entry":
        return np.array([4]), np.array([2]), 5, 3
    if name == "zero_entries":
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 6, 6
    raise KeyError(name)


COO_CASES = ("p1_laplace", "p2_elasticity", "stokes_b", "shuffled_duplicates",
             "empty_rows", "one_entry", "zero_entries")


def _same_pattern(a, b):
    for f in ("indptr", "indices", "coo_slots"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == np.int64 and y.dtype == np.int64, f
        assert x.shape == y.shape and np.array_equal(x, y), f
    assert (a.n_rows, a.n_cols) == (b.n_rows, b.n_cols)


@pytest.mark.parametrize("case", COO_CASES)
def test_from_coo_matches_jax_and_plain(case):
    rows, cols, n_rows, n_cols = _coo_case(case)
    got = SparsityPattern.from_coo(rows, cols, n_rows, n_cols)
    _same_pattern(got, JPattern.from_coo(rows, cols, n_rows, n_cols))
    _same_pattern(got, SparsityPattern.from_coo_plain(rows, cols, n_rows,
                                                      n_cols))
    assert got.indptr[-1] == got.nnz and len(got.coo_slots) == len(rows)


@pytest.mark.parametrize("rows,cols", [([0, 3], [0, 0]), ([0, -1], [0, 0]),
                                       ([0, 1], [0, 2]), ([0, 1], [-1, 0])])
def test_coo_to_csr_rejects_entries_outside(rows, cols):
    with pytest.raises(ValueError, match="outside"):
        native.coo_to_csr(np.array(rows), np.array(cols), 3, 2)


_HAND_3D = """MeshVersionFormatted 1
Dimension 3
Vertices
5
0 0 0 1
1 0 0 2
0 1 0 3
0 0 1 4
1 1 1 5
Tetrahedra
2
1 2 3 4 10
2 3 4 5 11
Triangles
3
1 2 3 21
2 3 5 22
1 3 4 23
Edges
2
1 2 31
4 5 32
End
"""


def _write_case(tmp_path, name):
    path = str(tmp_path / f"{name}.mesh")
    if name == "2d_edges":
        mesh = build_structured_mesh(2, (5, 3), lower=[0.0, -1.0],
                                     upper=[2.0, 0.5])
        assert mesh.surfaces is not None and len(mesh.surfaces)
        write_mesh(mesh, path)
    elif name == "3d_triangles":
        mesh = build_structured_mesh(3, 3)
        assert mesh.surfaces is not None and len(mesh.surfaces)
        write_mesh(mesh, path)
    elif name == "3d_hand_edges":
        with open(path, "w") as f:
            f.write(_HAND_3D)
    elif name == "channel":
        scenarios.write_channel_mesh(path)
    else:
        raise KeyError(name)
    return path


def _same_mesh(a, b):
    assert (a.dim, a.fe_type) == (b.dim, b.fe_type)
    for f in MESH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("fe_type", ["P1", "P2"])
@pytest.mark.parametrize("name", ["2d_edges", "3d_triangles", "3d_hand_edges",
                                  "channel"])
def test_read_mesh_matches_jax_and_plain(tmp_path, name, fe_type):
    path = _write_case(tmp_path, name)
    r = native.read_medit(path)
    assert r is not None and r["dim"] in (2, 3)
    got = read_mesh(path, fe_type)
    _same_mesh(got, j_read_mesh(path, fe_type))
    _same_mesh(got, read_mesh_plain(path, fe_type))
    if name == "3d_hand_edges":
        assert np.array_equal(got.lines, [[0, 1], [3, 4]])
        assert np.array_equal(got.line_flags, [31, 32])


@pytest.mark.parametrize("name", ["missing", "not_medit"])
def test_read_mesh_errors_match_jax(tmp_path, name):
    path = str(tmp_path / "x.mesh")
    if name == "not_medit":
        with open(path, "w") as f:
            f.write("solid cube\n facet normal 0 0 1\nendsolid\n")
    with pytest.raises(Exception) as ej:
        j_read_mesh(path)
    with pytest.raises(Exception) as et:
        read_mesh(path)
    assert type(et.value) is type(ej.value)
    assert isinstance(et.value, (FileNotFoundError if name == "missing"
                                 else ValueError))


def _rcb_points(n, dim, seed):
    """Points with many tied coordinates (a coarse lattice) and some
    spread ones, so the (coordinate, id) order and the split rank both
    matter."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 4, (n, dim)) / 3.0
    pts[::3] = rng.random((len(pts[::3]), dim))
    return pts


@pytest.mark.parametrize("n_parts", [2, 3, 4, 8])
def test_rcb_matches_jax_native(n_parts):
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load here "
                    "(feddlib_tpu.native.available() is False)")
    for n in range(16, 60):
        for dim in (2, 3):
            pts = _rcb_points(n, dim, 100 * n + dim)
            got = native.rcb(pts, n_parts)
            assert got.dtype == np.int32
            assert np.array_equal(got, jnative.rcb(pts, n_parts)), (n, dim)


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 8, 512])
def test_rcb_matches_plain(n_parts):
    for n in (0, 1, 5, 16, 37, 59, 1000):
        for dim in (1, 2, 3):
            pts = _rcb_points(n, dim, 7 * n + dim)
            got = native.rcb(pts, n_parts)
            assert np.array_equal(got, native.rcb_plain(pts, n_parts)), \
                (n, dim)
            if n >= n_parts:
                assert np.array_equal(np.unique(got), np.arange(n_parts))


def test_library_built_under_build_dir():
    native.get_lib()
    path = native.lib_path()
    build_dir = os.path.join(str(REPO), "feddlib_tpu_torch", "_build")
    assert path.startswith(build_dir + os.sep) and os.path.exists(path)
    src_dir = REPO / "feddlib_tpu_torch" / "native"
    assert sorted(p.name for p in src_dir.iterdir()
                  if p.name != "__pycache__") == ["__init__.py",
                                                  "fedd_native.cpp"]


def test_two_processes_build_at_once(tmp_path):
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from feddlib_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "ip, ix, sl = native.coo_to_csr(np.array([2, 0, 2]), "
        "np.array([1, 0, 1]), 3, 2)\n"
        "print(ip.tolist(), ix.tolist(), sl.tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
        assert out.strip() == "[0, 1, 1, 2] [0, 1] [1, 0, 1]"
    files = sorted(p.name for p in tmp_path.rglob("*") if p.is_file())
    assert files == [native.LIB_NAME], files


@pytest.mark.parametrize("fault", ["bad_flag", "no_compiler"])
def test_failed_build_raises(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    if fault == "bad_flag":
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ("-fno-such-option-here",))
        match = "no-such-option-here"
    else:
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "no-such-g\\+\\+"
    assert native.available() is False
    with pytest.raises(RuntimeError, match=match):
        SparsityPattern.from_coo(np.array([0]), np.array([0]), 1, 1)
    path = _write_case(tmp_path, "3d_hand_edges")
    with pytest.raises(RuntimeError, match=match):
        read_mesh(path)
    assert not [p for p in tmp_path.rglob("*.so*")]


def test_read_mesh_repeated_block_takes_plain(tmp_path):
    """A block repeated with more rows than its last count overruns no
    buffer: the native parse declines and the numpy parser reads it."""
    extra = "Vertices\n6\n" + "0 0 0 0\n" * 6
    path = tmp_path / "repeated.mesh"
    path.write_text(_HAND_3D.replace("Dimension 3\n", "Dimension 3\n" + extra))
    assert native.read_medit(str(path)) is None
    _same_mesh(read_mesh(str(path)), read_mesh_plain(str(path)))
