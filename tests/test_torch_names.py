"""Every public name of the JAX package exists in the port, by an AST walk
of both source trees (no module is imported).

For each module feddlib_tpu/<path>.py, every public top-level name (a
function, class or assignment; in an __init__.py also the names it
re-exports) and every public member of its classes (private classes
included) must exist in feddlib_tpu_torch/<path>.py, as a definition or
an import there.  The exceptions are JAX mechanisms with no meaning in
torch, in JAX_ONLY, each mapped to the port's counterpart; the
counterparts must exist, and every exception must still be one."""

import ast
import functools
import os
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "feddlib_tpu"
PORT_PKG = REPO / "feddlib_tpu_torch"

#: "<module path>:<name>" of the JAX package → the port's counterpart,
#: "<module path>:<name>" under feddlib_tpu_torch/
JAX_ONLY = {
    # a jitted solver program: the eager solve over the same (fn, operands)
    "solvers/krylov.py:solve_jit": "solvers/krylov.py:solve",
    # three f32 scatter-sets (a TPU workaround): the exact duplication plan
    "la/csr.py:assemble_csr_data_tri": "la/csr.py:assemble_planned",
    # the (pure_fn, operands) operator() protocol: padded_operator() /
    # operands() with dense_block_padded_op and permute_op
    "la/dense_blocks.py:DenseBlockSpMV.operator":
        "la/dense_blocks.py:DenseBlockSpMV.padded_operator",
    "la/dense_blocks.py:dense_block_op": "la/dense_blocks.py:dense_block_padded_op",
    "la/permute.py:PermutationGather.operator":
        "la/permute.py:PermutationGather.operands",
    # the Pallas kernels and the Pallas-or-XLA switches: the Hopper kernels'
    # wrappers, which launch on a CUDA tensor and run the plain version on
    # the CPU
    "la/sell.py:use_pallas_sell": "la/sell.py:sell_spmv",
    "la/pallas_kernels.py:dense_block_mv_pallas": "la/dense_kernels.py:dense_block_mv",
    "la/pallas_kernels.py:dense_block_mv_lowp_pallas":
        "la/dense_kernels.py:dense_block_mv_lowp",
    "la/pallas_kernels.py:use_pallas_dense": "la/dense_kernels.py:dense_block_mv",
    "la/pallas_kernels.py:use_pallas_lowp": "la/dense_kernels.py:dense_block_mv_lowp",
    "la/pallas_kernels.py:pallas_available": "la/_cuda.py:lib",
    # the shard_map mesh and its axis name: collectives on the stacked
    # [n_local, ...] shards of a DeviceAxis on one device
    "parallel/spmd.py:AXIS": "parallel/spmd.py:DeviceAxis",
    "parallel/spmd.py:DeviceAxis.mesh": "parallel/spmd.py:DeviceAxis.device",
    "parallel/spmd.py:DeviceAxis.shard_map": "parallel/spmd.py:DeviceAxis.ppermute",
    # the jnp.float64 alias: the f64 values of the torch fast path
    "fe/fast_assembly.py:f64": "fe/fast_assembly.py:assemble_fast",
    # the switch that opens TraceAnnotations: every span opens its
    # record_function whenever a torch.profiler profile runs
    "utils/timers.py:enable_profiler_annotations": "utils/timers.py:Span",
}


def _members(cls: ast.ClassDef) -> set:
    out = set()
    for b in cls.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(b.name)
        elif isinstance(b, ast.Assign):
            out.update(t.id for t in b.targets if isinstance(t, ast.Name))
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            out.add(b.target.id)
    return out


def _top_statements(body):
    """The module's statements, with those of top-level if / try blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_statements(node.body + node.orelse
                                       + node.finalbody
                                       + [s for h in node.handlers
                                          for s in h.body])
        else:
            yield node


@functools.lru_cache(maxsize=None)
def _names(path: pathlib.Path, imports: bool) -> dict:
    """{top-level name: set of class members, or None for a non-class}."""
    names = {}
    tree = ast.parse(path.read_text())
    for node in _top_statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = None
        elif isinstance(node, ast.ClassDef):
            names[node.name] = _members(node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                names.update((n.id, None) for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names[node.target.id] = None
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update(((a.asname or a.name).split(".")[0], None)
                         for a in node.names)
    return names


def _public(name: str) -> bool:
    return not name.startswith("_")


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _required(rel: str):
    """The "<module>:<name>" / "<module>:<Class>.<member>" keys the port
    must have for JAX module `rel`."""
    path = JAX_PKG / rel
    for name, members in _names(path, imports=path.name == "__init__.py"
                                ).items():
        if _public(name):
            yield f"{rel}:{name}"
        for m in sorted(members or ()):
            if _public(m):
                yield f"{rel}:{name}.{m}"


def _exists_in_port(key: str) -> bool:
    rel, name = key.split(":")
    path = PORT_PKG / rel
    if not path.exists():
        return False
    names = _names(path, imports=True)
    top, _, member = name.partition(".")
    if top not in names:
        return False
    return not member or member in (names[top] or ())


def _groups():
    return sorted({r.split(os.sep)[0] if os.sep in r else "." for r in
                   _jax_modules()})


@pytest.mark.parametrize("group", _groups())
def test_port_has_every_public_name(group):
    mods = [r for r in _jax_modules()
            if (r.split(os.sep)[0] if os.sep in r else ".") == group]
    assert mods
    missing = [k for r in mods for k in _required(r)
               if k not in JAX_ONLY and not _exists_in_port(k)]
    assert not missing, missing


def test_jax_only_counterparts_exist():
    absent = [v for v in JAX_ONLY.values() if not _exists_in_port(v)]
    assert not absent, absent


def test_jax_only_names_are_jax_only():
    """Each exception is a public JAX name that the port lacks, so the
    list cannot go stale."""
    required = {k for r in _jax_modules() for k in _required(r)}
    stale = [k for k in JAX_ONLY if k not in required or _exists_in_port(k)]
    assert not stale, stale
