"""ctypes bindings of the native host library (fedd_native.cpp).

Counterpart of feddlib_tpu/native: the same public names, signatures and
return values (`get_lib`, `available`, `coo_to_csr`, `read_medit`, `rcb`).
The library is compiled at first use with the host C++ compiler into
`feddlib_tpu_torch/_build/native-<key>/`, under a key of the source's
content, the flags, the compiler's version line and the machine type, so
a tree copied to another host builds its own.  Nothing is built when the
module is imported, nothing is written next to the source, and no binary
is committed.  Several processes may build at once: each compiles to a
temporary name in the build directory and renames it into place.

Unlike the JAX package, there is no quiet numpy fallback: if the library
cannot be built or loaded, `get_lib` (and every caller) raises
RuntimeError with the compiler's output.  `available()` says whether it
loads and never raises.  The numpy versions of the three functions
(`SparsityPattern.from_coo_plain`, `mesh.io.read_mesh_plain`,
`rcb_plain` here) are kept as the references that the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fedd_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
#: the host C++ compiler and its flags (no -march=native: the key names the
#: machine type, not the CPU model)
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "libfedd_native.so"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def compiler_version() -> str:
    """First line of `CXX --version`; RuntimeError if it does not run."""
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native library: the C++ compiler {CXX!r} "
                           f"does not run: {e}") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"native library: {CXX} --version failed "
                           f"(exit {out.returncode}):\n{out.stderr}")
    return out.stdout.strip().splitlines()[0]


def lib_path() -> str:
    """Where the library of this source, flags and compiler lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    for part in (CXX, *CXX_FLAGS, compiler_version(), platform.machine()):
        h.update(b"\0" + part.encode())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}", LIB_NAME)


def build() -> str:
    """Compile the library unless a build of the same key exists; returns
    its path.  RuntimeError with the compiler's output if it fails."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [CXX, *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native library: {' '.join(cmd)} did not "
                           f"run: {e}") from e
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"native library: {' '.join(cmd)} failed (exit "
                           f"{out.returncode}):\n{out.stderr}{out.stdout}")
    os.replace(tmp, path)
    return path


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.medit_sizes.argtypes = [ctypes.c_char_p, i64p]
    lib.medit_sizes.restype = ctypes.c_int
    lib.medit_read.argtypes = [ctypes.c_char_p, i64p, f64p, i32p, i64p,
                               i32p, i64p, i32p, i64p, i32p]
    lib.medit_read.restype = ctypes.c_int
    lib.coo_to_csr.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, i64p, i64p, i64p]
    lib.coo_to_csr.restype = ctypes.c_int64
    lib.rcb_partition.argtypes = [f64p, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, i32p]
    lib.rcb_partition.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first call; RuntimeError if it cannot
    be built or loaded (the JAX package returns None there)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _declare(ctypes.CDLL(path))
            except OSError as e:
                raise RuntimeError(f"native library: cannot load {path}: "
                                   f"{e}") from e
    return _lib


def available() -> bool:
    """True if the library builds and loads; never raises."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


# -- high-level wrappers ------------------------------------------------------


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, n_rows: int,
               n_cols: int):
    """Symbolic fillComplete: (indptr [n_rows + 1], indices [nnz] sorted
    within each row, slot_of_coo [n_coo]), all int64, equal to the JAX
    package's.  ValueError if an entry lies outside the matrix."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int64).ravel()
    cols = np.ascontiguousarray(cols, dtype=np.int64).ravel()
    if rows.shape != cols.shape:
        raise ValueError(f"rows {rows.shape} and cols {cols.shape} differ")
    if n_rows < 0 or n_cols < 0:
        raise ValueError(f"coo_to_csr: a {n_rows} x {n_cols} matrix")
    n = len(rows)
    indptr = np.empty(int(n_rows) + 1, dtype=np.int64)
    indices = np.empty(n, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    nnz = lib.coo_to_csr(rows, cols, n, int(n_rows), int(n_cols), indptr,
                         indices, slot)
    if nnz < 0:
        what = "row" if nnz == -1 else "column"
        raise ValueError(f"coo_to_csr: a {what} index lies outside the "
                         f"{n_rows} x {n_cols} matrix")
    return indptr, indices[:nnz].copy(), slot


def read_medit(path) -> Optional[dict]:
    """Native .mesh parse: a dict of arrays, or None if the file cannot be
    opened or a block is malformed (read_mesh then takes the numpy
    parser, whose error is the caller's)."""
    lib = get_lib()
    bpath = os.fsencode(path)
    sizes = np.zeros(5, dtype=np.int64)
    if lib.medit_sizes(bpath, sizes) != 0:
        return None
    dim, nv, ne, nt, ntet = (int(s) for s in sizes)
    if min(nv, ne, nt, ntet) < 0:
        return None
    verts = np.zeros((max(nv, 1), 3))
    vflags = np.zeros(max(nv, 1), dtype=np.int32)
    edges = np.zeros((max(ne, 1), 2), dtype=np.int64)
    eflags = np.zeros(max(ne, 1), dtype=np.int32)
    tris = np.zeros((max(nt, 1), 3), dtype=np.int64)
    tflags = np.zeros(max(nt, 1), dtype=np.int32)
    tets = np.zeros((max(ntet, 1), 4), dtype=np.int64)
    tetflags = np.zeros(max(ntet, 1), dtype=np.int32)
    rc = lib.medit_read(bpath, sizes, verts.ravel(), vflags, edges.ravel(),
                        eflags, tris.ravel(), tflags, tets.ravel(), tetflags)
    if rc != 0:
        return None
    return {
        "dim": dim,
        "vertices": verts[:nv], "vertex_flags": vflags[:nv],
        "edges": edges[:ne], "edge_flags": eflags[:ne],
        "triangles": tris[:nt], "triangle_flags": tflags[:nt],
        "tetrahedra": tets[:ntet], "tetrahedra_flags": tetflags[:ntet],
    }


def rcb(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection of the points [n, dim] (dim 1..3)
    into n_parts: the int32 part of each point."""
    lib = get_lib()
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    if c.ndim != 2 or not 1 <= c.shape[1] <= 3 or n_parts < 1:
        raise ValueError(f"rcb: centroids {c.shape} must be [n, 1..3] and "
                         f"n_parts {n_parts} >= 1")
    out = np.zeros(len(c), dtype=np.int32)
    if lib.rcb_partition(c.ravel(), len(c), c.shape[1], int(n_parts),
                         out) != 0:
        raise RuntimeError("rcb_partition failed")
    return out


def rcb_plain(centroids: np.ndarray, n_parts: int) -> np.ndarray:
    """The numpy version of `rcb`, by the library's rule (the split rank
    rounds half up; `mesh.partition._rcb` rounds half to even, as the JAX
    package's does)."""
    c = np.asarray(centroids, dtype=np.float64)
    if c.ndim != 2 or not 1 <= c.shape[1] <= 3 or n_parts < 1:
        raise ValueError(f"rcb_plain: centroids {c.shape} must be "
                         f"[n, 1..3] and n_parts {n_parts} >= 1")
    out = np.zeros(len(c), dtype=np.int32)
    stack = [(np.arange(len(c), dtype=np.int64), int(n_parts), 0)]
    while stack:
        ids, n_p, base = stack.pop()
        if n_p == 1:
            out[ids] = base
            continue
        nl = n_p // 2
        ax = 0
        if len(ids):
            ext = c[ids].max(0) - c[ids].min(0)
            for d in range(1, c.shape[1]):
                if ext[d] > ext[ax]:
                    ax = d
        ids = ids[np.lexsort((ids, c[ids, ax]))]
        k = int(float(len(ids)) * nl / n_p + 0.5)
        stack.append((ids[k:], n_p - nl, base + nl))
        stack.append((ids[:k], nl, base))
    return out
