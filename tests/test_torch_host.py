"""Host layers of the PyTorch port (feddlib_tpu_torch) against the JAX
package: the numpy copies must give identical arrays, the state converters
must round-trip, and the port must never import jax or feddlib_tpu."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import feddlib_tpu.fe.host_assembly as jha  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.mesh.partition import partition_points as j_pp  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

import feddlib_tpu_torch.fe.host_assembly as tha  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.mesh.io import read_mesh, write_mesh  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart  # noqa: E402
from feddlib_tpu_torch.mesh.partition import partition_points as t_pp  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "feddlib_tpu_torch"
MESH_FIELDS = ("points", "elements", "point_flags", "element_flags",
               "surfaces", "surface_flags", "p2_edges")


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dim,n,fe", [(3, 6, "P1"), (3, 6, "P2"),
                                      (2, 5, "P1"), (2, 5, "P2")])
def test_structured_mesh_identical(dim, n, fe):
    mj = JDomain.structured(dim, n, fe_type=fe).mesh
    mt = TDomain.structured(dim, n, fe_type=fe, device="cpu").mesh
    assert mj.fe_type == mt.fe_type and mj.dim == mt.dim
    for f in MESH_FIELDS:
        assert _same(getattr(mj, f), getattr(mt, f)), f


@pytest.mark.parametrize("n_parts", [1, 7, 8, 32])
def test_partition_points_identical(n_parts):
    pts = JDomain.structured(3, 6).mesh.points
    assert np.array_equal(j_pp(pts, n_parts), t_pp(pts.copy(), n_parts))


@pytest.mark.parametrize("n_parts", [4, 8])
def test_mesh_partition_maps_identical(n_parts):
    mj = JDomain.structured(3, 6).mesh
    mt = TDomain.structured(3, 6, device="cpu").mesh
    pj, pt = JPart(mj, n_parts), TPart(mt, n_parts)
    assert np.array_equal(pj.elem_part, pt.elem_part)
    for name in ("repeated_map", "unique_map", "element_map"):
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.n_global == b.n_global
        for x, y in zip(a.partition_indices, b.partition_indices):
            assert np.array_equal(x, y)
    vj = pj.unique_map.build_vec_field_map(3)
    vt = pt.unique_map.build_vec_field_map(3)
    for x, y in zip(vj.partition_indices, vt.partition_indices):
        assert np.array_equal(x, y)
    assert np.array_equal(pj.unique_map.owner_of(), pt.unique_map.owner_of())


@pytest.mark.parametrize("dim,n", [(3, 6), (2, 9)])
def test_host_assembly_identical(dim, n):
    Kj, bj = jha.host_poisson_dirichlet(JDomain.structured(dim, n))
    Kt, bt = tha.host_poisson_dirichlet(
        TDomain.structured(dim, n, device="cpu"))
    assert np.array_equal(Kj.indptr, Kt.indptr)
    assert np.array_equal(Kj.indices, Kt.indices)
    assert np.array_equal(Kj.data, Kt.data)
    assert np.array_equal(bj, bt)


def test_mesh_io_roundtrip(tmp_path):
    mesh = TDomain.structured(3, 3, device="cpu").mesh
    path = str(tmp_path / "cube.mesh")
    write_mesh(mesh, path)
    back = read_mesh(path)
    assert np.allclose(back.points, mesh.points, atol=1e-9)
    for f in ("elements", "point_flags", "element_flags", "surfaces",
              "surface_flags"):
        assert np.array_equal(getattr(back, f), getattr(mesh, f)), f


def test_parameter_list_matches(tmp_path):
    items = {"Clusters": 8, "Use Mixed Precision": True,
             "Convergence Tolerance": 1e-8, "Name": "x"}
    pj, pt = JPL("P", items), TPL("P", items)
    assert dict(pj.items()) == dict(pt.items())
    path = str(tmp_path / "p.xml")
    pt.write_xml(path)
    from feddlib_tpu.utils.config import load_xml_parameters as jload
    from feddlib_tpu_torch.utils.config import load_xml_parameters as tload

    assert dict(jload(path).items()) == dict(tload(path).items())


def test_convert_round_trip():
    mj = JDomain.structured(3, 4).mesh
    mt = convert.mesh_from_numpy(mj.points, mj.elements, mj.point_flags,
                                 mj.element_flags, surfaces=mj.surfaces,
                                 surface_flags=mj.surface_flags)
    for f in ("points", "elements", "point_flags", "element_flags"):
        assert np.array_equal(getattr(mj, f), getattr(mt, f))
    pj = JPart(mj, 4)
    pt = convert.partition_from_numpy(mt, pj.elem_part)
    for x, y in zip(pj.unique_map.partition_indices,
                    pt.unique_map.partition_indices):
        assert np.array_equal(x, y)
    K, _ = jha.host_poisson_dirichlet(JDomain.structured(3, 4))
    A = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                               device="cpu")
    assert A.data.dtype == torch.float64 and A.device.type == "cpu"
    assert (A.to_scipy() != K).nnz == 0


def test_port_imports_no_jax():
    """A fresh interpreter imports the port and every submodule without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import feddlib_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'feddlib_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'feddlib_tpu' or m.startswith('feddlib_tpu.')]\n"
        "assert len(mods) > 20, mods\n"
        "assert not bad, bad\n"
        "print('OK', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_native_runs_where_jax_cannot_import():
    """The native host library builds, loads and runs from_coo in a process
    where importing jax or the JAX package fails."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'feddlib_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from feddlib_tpu_torch import native\n"
        "from feddlib_tpu_torch.la.csr import SparsityPattern\n"
        "p = SparsityPattern.from_coo(np.array([1, 0, 1]), "
        "np.array([2, 0, 2]), 2, 3)\n"
        "assert p.indptr.tolist() == [0, 1, 2], p.indptr\n"
        "assert p.indices.tolist() == [0, 2], p.indices\n"
        "assert p.coo_slots.tolist() == [1, 0, 1], p.coo_slots\n"
        "assert native.available()\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+feddlib_tpu\b"
                     r"|from\s+feddlib_tpu\b|import\s+feddlib_tpu\.|"
                     r"from\s+feddlib_tpu\.)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f
