"""Build, load and launch the hand-written Hopper kernels (csrc/*.cu).

The kernels are compiled at first use with `nvcc` for `sm_90a` into one
shared library with a plain C interface, loaded with ctypes.  Nothing is
built or loaded when a module is imported, so the package imports on a
machine without CUDA.  Each source compiles in its own `nvcc` process, all
started together, then one link step joins the objects; the library lives
under `feddlib_tpu_torch/_build/<content hash>/` and is reused while the
sources are unchanged.

Every C entry launches on the caller's stream and returns
`cudaGetLastError()`; `check()` raises on a non-zero code.  Each wrapper
adds one to its counter `kernel.<name>` of `utils/timers.py` where it
launches its kernel; `launch_counts` reads those six counters.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Mapping

import torch

from feddlib_tpu_torch.utils import timers

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("permute.cu", "sell.cu", "dense_gemv.cu", "block_sell.cu",
           "hyperelastic.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("permute_gather", "sell_spmv", "dense_gemv_f32",
           "dense_gemv_bf16", "block_sell_spmv", "neo_hooke_p1")


class _LaunchCounts(Mapping):
    """Launches per kernel since the last reset_launch_counts(): the
    registry's counters `kernel.<name>`, read where they are kept."""

    def __getitem__(self, name: str) -> int:
        if name not in KERNELS:
            raise KeyError(name)
        return timers.counters().get("kernel." + name, 0)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)


launch_counts = _LaunchCounts()

_P = ctypes.c_void_p
_SIGNATURES = {
    "fedd_permute_gather_f32": [_P, _P, _P, ctypes.c_longlong, _P],
    "fedd_sell_spmv_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_int, _P],
    "fedd_block_sell_slices_f32": [_P, _P, _P, _P, _P, _P,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_longlong, _P],
    "fedd_dense_gemv_f32": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _P],
    "fedd_dense_gemv_bf16": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _P],
    "fedd_neo_hooke_p1_f64": [_P, _P, _P, _P, ctypes.c_longlong,
                              ctypes.c_double, ctypes.c_double, ctypes.c_int,
                              _P],
}

_lib = None
_lock = threading.Lock()
build_log = ""


def reset_launch_counts() -> None:
    timers.reset_counters(*("kernel." + k for k in KERNELS))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source_hash(csrc_dir: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(csrc_dir)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(csrc_dir, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build(csrc_dir: str = CSRC_DIR) -> str:
    """Compile the kernels (one nvcc per source, in parallel) and link
    them into one library; returns its path.  Reuses an existing build of
    the same sources.  `csrc_dir` builds another version of the sources
    (with the same C entries), as `kernel_ab.py` does to compare two of
    them on one card."""
    global build_log
    out_dir = os.path.join(BUILD_DIR, _source_hash(csrc_dir))
    lib_path = os.path.join(out_dir, "libfeddlib_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = os.path.join(out_dir, src.replace(".cu", f".{os.getpid()}.o"))
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(csrc_dir, src),
               "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== nvcc {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_log += f"\n== link\n{link.stdout}"
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{build_log}")
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(build_log)
    return lib_path


def load(path: str, signatures=None) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entries: those of
    `_SIGNATURES` and of `signatures` (name -> argtypes) that it has (an
    older build may lack some, or have others)."""
    handle = ctypes.CDLL(path)
    for name, argtypes in {**_SIGNATURES, **(signatures or {})}.items():
        fn = getattr(handle, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
    return _lib


def use(handle: ctypes.CDLL) -> None:
    """Make the wrappers launch from `handle`, a library from
    `load(build(csrc_dir))`, from now on."""
    global _lib
    with _lock:
        _lib = handle


def require_hopper(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device of capability 9.x."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"vs {dev}")
    major, minor = torch.cuda.get_device_capability(dev)
    if major != 9:
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {dev} has compute "
            f"capability {major}.{minor}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
