"""Global assembly operations: Domain → CsrMatrix / vectors.

Counterpart of feddlib_tpu/fe/ops.py for scalar simplex Laplace and the
volume rhs, through the chunked element path (ops.py:48-91 of the JAX
package) on every device.  The JAX package switches to its element-last
fast assembly (fe/fast_assembly.py) on accelerators; that module is not
ported yet (ROADMAP.md, slice 2).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.csr import CsrMatrix

# elements per chunk of the element kernels: bounds the [E, nq, nb, dim]
# temporaries on the device
_CHUNK = 32768


def _assemble_chunked(domain: Domain, pattern, kernel) -> CsrMatrix:
    vc = domain.vert_coords()
    vals = [kernel(vc[s:s + _CHUNK]).reshape(-1)
            for s in range(0, vc.shape[0], _CHUNK)]
    m = CsrMatrix(pattern, device=domain.device)
    m.assemble(torch.cat(vals))
    return m


def _square_pattern(domain: Domain, dofs_per_node: int):
    def build():
        dofs = domain.elem_dofs(dofs_per_node)
        n = domain.n_dofs(dofs_per_node)
        return asm.scatter_pattern(dofs, dofs, n, n)

    return domain.pattern(("square", dofs_per_node), build)


def _require_simplex(domain: Domain) -> None:
    if domain.is_hex:
        raise NotImplementedError(
            "quad/hex spaces are not ported yet (ROADMAP.md A7, fe/hex.py)")


def assemble_laplace(domain: Domain) -> CsrMatrix:
    """Scalar Laplace stiffness (FE::assemblyLaplace) on P1/P2 simplices."""
    _require_simplex(domain)
    return _assemble_chunked(
        domain, _square_pattern(domain, 1),
        lambda vc: asm.elem_laplace(vc, domain.dim, domain.fe_type))


def assemble_rhs(domain: Domain, f: Callable, dofs_per_node: int = 1,
                 degree: Optional[int] = None) -> torch.Tensor:
    """Volume source term (FE::assemblyRHS) of a scalar field.  f(x) takes
    the quadrature points component-first (x[0] is the first coordinate)
    and returns a scalar or a tensor broadcastable to the points (see
    assembly.elem_rhs)."""
    _require_simplex(domain)
    if dofs_per_node != 1:
        raise NotImplementedError(
            "vector sources are not ported yet (ROADMAP.md A8)")
    vec = asm.elem_rhs(domain.vert_coords(), domain.dim, domain.fe_type,
                       f, degree=degree)
    return asm.assemble_vector(domain.elem_nodes(), vec, domain.n_dofs())
