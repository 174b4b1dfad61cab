"""Element-last assembly: the fast path of scalar P1/P2 Laplace and mass
and of the two advection operators, and the scatter as a SELL SpMV.

Counterpart of feddlib_tpu/fe/fast_assembly.py.  The element kernels keep
the element axis LAST: every intermediate is an [E]-vector, combined by
unrolled Python loops over (q, a, b, i), so a kernel is a chain of
elementwise torch ops on [E]-vectors.  The flat output is ordered (a, b, E)
(or (a, b, i, E), (a, b, i, j, E) for the vector operators), and
`pattern_abe` / `pattern_vec_*_abe` build the matching COO→slot plans, so
the CSR result has the same structure as the chunked path's (same
deduplicated pattern) and equal values up to summation order.

The JAX package takes this path on an accelerator because the TPU's
(8, 128) tiling pads the element-first [E, nb, nb] tensors 32x; `use_fast`
takes it for a CUDA domain, where it is a plain alternative to the
chunked einsums (fe/ops.py), kept for parity and timed against them.

`sell_assembly_plans` / `sell_assemble` apply the assembly as CSR data =
P @ raw values with P the 0/1 plan matrix, through the windowed SELL
operator of la/sell.py — on the card the B2 kernel (csrc/sell.cu).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps
import torch

from feddlib_tpu_torch.fe import reference as ref
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern


def supported(dim: int, fe_type: str) -> bool:
    return fe_type in ("P1", "P2") and dim in (2, 3)


def use_fast(device=None) -> bool:
    """True for a CUDA device, false on the CPU; FEDD_FAST_ASSEMBLY="0"
    turns it off and "1" on (the CPU included), as in the JAX package."""
    flag = os.environ.get("FEDD_FAST_ASSEMBLY")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return device is not None and torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# element-last geometry helpers: nested-list tensors of [E] vectors
# ---------------------------------------------------------------------------


def _vrows(vc, dim):
    """Row access get(v, i) → [E] over vertex coords [E, nv, dim]
    (element-first) or [nv*dim, E] (Domain.vert_coords_T, element-last)."""
    if vc.dim() == 2:
        return lambda v, i: vc[v * dim + i]
    vT = vc.permute(1, 2, 0)  # [nv, dim, E]
    return lambda v, i: vT[v, i]


def _edges_T(vc, dim=None):
    """B columns as lists: B[i][k] = [E] (column k = edge v_{k+1}-v_0,
    component i).  vc: [E, nv, dim] or [nv*dim, E] (see _vrows)."""
    if dim is None:
        if vc.dim() != 3:
            raise ValueError("dim required for [nv*dim, E] layout")
        dim = vc.shape[2]
    g = _vrows(vc, dim)
    return [[g(k + 1, i) - g(0, i) for k in range(dim)] for i in range(dim)]


def _det_T(B, dim):
    if dim == 2:
        return B[0][0] * B[1][1] - B[0][1] * B[1][0]
    return (B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[2][1])
            - B[0][1] * (B[1][0] * B[2][2] - B[1][2] * B[2][0])
            + B[0][2] * (B[1][0] * B[2][1] - B[1][1] * B[2][0]))


def _inv_T(B, det, dim):
    """Binv[k][i] = [E] (cofactor formula)."""
    if dim == 2:
        return [[B[1][1] / det, -B[0][1] / det],
                [-B[1][0] / det, B[0][0] / det]]
    c = [[None] * 3 for _ in range(3)]
    c[0][0] = B[1][1] * B[2][2] - B[1][2] * B[2][1]
    c[0][1] = B[0][2] * B[2][1] - B[0][1] * B[2][2]
    c[0][2] = B[0][1] * B[1][2] - B[0][2] * B[1][1]
    c[1][0] = B[1][2] * B[2][0] - B[1][0] * B[2][2]
    c[1][1] = B[0][0] * B[2][2] - B[0][2] * B[2][0]
    c[1][2] = B[0][2] * B[1][0] - B[0][0] * B[1][2]
    c[2][0] = B[1][0] * B[2][1] - B[1][1] * B[2][0]
    c[2][1] = B[0][1] * B[2][0] - B[0][0] * B[2][1]
    c[2][2] = B[0][0] * B[1][1] - B[0][1] * B[1][0]
    return [[c[k][i] / det for i in range(3)] for k in range(3)]


def elem_laplace_flat_T(vc, dim, fe_type):
    """Stiffness ∫∇φa·∇φb, element-last → flat [nb*nb*E] in (a,b,E) order.
    Affine simplices (geometry from the first dim+1 vertices)."""
    B = _edges_T(vc, dim)
    det = _det_T(B, dim)
    adet = det.abs()
    Binv = _inv_T(B, det, dim)
    qp, qw = ref.quadrature(dim, ref.determine_degree(dim, fe_type, "grad"))
    dphi = ref.eval_grad_phi(dim, fe_type, qp)  # [nq, nb, dim] numpy
    nq, nb, _ = dphi.shape
    K = [[None] * nb for _ in range(nb)]
    for q in range(nq):
        # physical gradients gT[a][i] = Σ_k Binv[k][i] dphi[q,a,k]
        gT = [[sum(Binv[k][i] * float(dphi[q, a, k]) for k in range(dim))
               for i in range(dim)] for a in range(nb)]
        w = float(qw[q])
        for a in range(nb):
            for b in range(a, nb):
                contrib = w * sum(gT[a][i] * gT[b][i] for i in range(dim))
                K[a][b] = contrib if K[a][b] is None else K[a][b] + contrib
    rows = []
    for a in range(nb):
        for b in range(nb):
            kab = K[a][b] if b >= a else K[b][a]
            rows.append(kab * adet)
    return torch.stack(rows).reshape(-1)


def elem_mass_flat_T(vc, dim, fe_type):
    """Mass ∫φa φb, element-last → flat [nb*nb*E] in (a,b,E) order."""
    B = _edges_T(vc, dim)
    adet = _det_T(B, dim).abs()
    qp, qw = ref.quadrature(dim, ref.determine_degree(dim, fe_type, "phi"))
    phi = ref.eval_phi(dim, fe_type, qp)  # [nq, nb] numpy
    nq, nb = phi.shape
    # Mref[a,b] = Σ_q w_q φa φb — pure scalars
    Mref = np.einsum("q,qa,qb->ab", np.asarray(qw), phi, phi)
    rows = []
    for a in range(nb):
        for b in range(nb):
            rows.append(float(Mref[a, b]) * adet)
    return torch.stack(rows).reshape(-1)


_KERNELS = {"laplace": elem_laplace_flat_T, "mass": elem_mass_flat_T}


def elem_advection_flat_T(vc, ue, dim, fe_type):
    """Convection N(u): ∫ φa (u·∇φb), expanded to vector dofs as N⊗I —
    only the i==j dof entries are emitted, ordered (a, b, i, E) to match
    pattern_vec_diag_abe.  ue [E, nb, dim] (repeated-form velocity)."""
    B = _edges_T(vc, dim)
    det = _det_T(B, dim)
    adet = det.abs()
    Binv = _inv_T(B, det, dim)
    qp, qw = ref.quadrature(dim, ref.determine_degree(dim, fe_type, "conv"))
    phi = ref.eval_phi(dim, fe_type, qp)
    dphi = ref.eval_grad_phi(dim, fe_type, qp)
    nq, nb = phi.shape
    u = ue.permute(1, 2, 0)  # [nb, dim, E]
    N = [[None] * nb for _ in range(nb)]
    for q in range(nq):
        uq = [sum(float(phi[q, c]) * u[c][i] for c in range(nb))
              for i in range(dim)]
        gT = [[sum(Binv[k][i] * float(dphi[q, b, k]) for k in range(dim))
               for i in range(dim)] for b in range(nb)]
        w = float(qw[q])
        for a in range(nb):
            pa = w * float(phi[q, a])
            for b in range(nb):
                c = pa * sum(uq[i] * gT[b][i] for i in range(dim))
                N[a][b] = c if N[a][b] is None else N[a][b] + c
    rows = []
    for a in range(nb):
        for b in range(nb):
            v = N[a][b] * adet
            for _i in range(dim):
                rows.append(v)
    return torch.stack(rows).reshape(-1)


def elem_advection_in_u_flat_T(vc, ue, dim, fe_type):
    """Newton linearization W(u): ∫ φa φb ∂u_i/∂x_j — full dim×dim dof
    blocks, ordered (a, b, i, j, E) to match pattern_vec_full_abe."""
    B = _edges_T(vc, dim)
    det = _det_T(B, dim)
    adet = det.abs()
    Binv = _inv_T(B, det, dim)
    qp, qw = ref.quadrature(dim, ref.determine_degree(dim, fe_type, "conv"))
    phi = ref.eval_phi(dim, fe_type, qp)
    dphi = ref.eval_grad_phi(dim, fe_type, qp)
    nq, nb = phi.shape
    u = ue.permute(1, 2, 0)  # [nb, dim, E]
    # W[a][b][i][j] = Σ_q w φa φb G[i][j](q),  G[i][j] = Σ_c u[c][i] gT_c[j]
    W = [[[[None] * dim for _ in range(dim)]
          for _ in range(nb)] for _ in range(nb)]
    for q in range(nq):
        gT = [[sum(Binv[k][j] * float(dphi[q, c, k]) for k in range(dim))
               for j in range(dim)] for c in range(nb)]
        G = [[sum(u[c][i] * gT[c][j] for c in range(nb))
              for j in range(dim)] for i in range(dim)]
        w = float(qw[q])
        for a in range(nb):
            for b in range(nb):
                pab = w * float(phi[q, a]) * float(phi[q, b])
                for i in range(dim):
                    for j in range(dim):
                        c = pab * G[i][j]
                        cur = W[a][b][i][j]
                        W[a][b][i][j] = c if cur is None else cur + c
    rows = []
    for a in range(nb):
        for b in range(nb):
            for i in range(dim):
                for j in range(dim):
                    rows.append(W[a][b][i][j] * adet)
    return torch.stack(rows).reshape(-1)


def pattern_vec_diag_abe(domain, dim: int) -> SparsityPattern:
    """Dof-level pattern for N⊗I: entries (dof(a,i), dof(b,i)) ordered
    (a, b, i, E)."""
    def build():
        conn = domain.elem_nodes()
        E, nb = conn.shape
        n = domain.n_dofs(dim)
        cT = conn.T  # [nb, E]
        rows = np.empty((nb, nb, dim, E), np.int64)
        cols = np.empty((nb, nb, dim, E), np.int64)
        for i in range(dim):
            rows[:, :, i, :] = (cT * dim + i)[:, None, :]
            cols[:, :, i, :] = (cT * dim + i)[None, :, :]
        return SparsityPattern.from_coo(rows.reshape(-1), cols.reshape(-1),
                                        n, n)

    return domain.pattern(("vec_diag_abe", dim), build)


def pattern_vec_full_abe(domain, dim: int) -> SparsityPattern:
    """Dof-level pattern for full dim×dim blocks: (dof(a,i), dof(b,j))
    ordered (a, b, i, j, E)."""
    def build():
        conn = domain.elem_nodes()
        E, nb = conn.shape
        n = domain.n_dofs(dim)
        cT = conn.T
        rows = np.empty((nb, nb, dim, dim, E), np.int64)
        cols = np.empty((nb, nb, dim, dim, E), np.int64)
        for i in range(dim):
            for j in range(dim):
                rows[:, :, i, j, :] = (cT * dim + i)[:, None, :]
                cols[:, :, i, j, :] = (cT * dim + j)[None, :, :]
        return SparsityPattern.from_coo(rows.reshape(-1), cols.reshape(-1),
                                        n, n)

    return domain.pattern(("vec_full_abe", dim), build)


def _assembled(domain, pat, flat) -> CsrMatrix:
    m = CsrMatrix(pat, device=domain.device)
    m.assemble(flat)
    return m


def assemble_advection_fast(domain, ue) -> CsrMatrix:
    flat = elem_advection_flat_T(domain.vert_coords_T(), ue, domain.dim,
                                 domain.fe_type)
    return _assembled(domain, pattern_vec_diag_abe(domain, domain.dim), flat)


def assemble_advection_in_u_fast(domain, ue) -> CsrMatrix:
    flat = elem_advection_in_u_flat_T(domain.vert_coords_T(), ue,
                                      domain.dim, domain.fe_type)
    return _assembled(domain, pattern_vec_full_abe(domain, domain.dim), flat)


# ---------------------------------------------------------------------------
# (a, b, E)-ordered scatter pattern
# ---------------------------------------------------------------------------


def pattern_abe(domain, dofs_per_node: int = 1) -> SparsityPattern:
    """Square scatter pattern whose COO plan is ordered (a, b, E) to match
    the element-last kernels' flat output.  The deduplicated CSR structure
    equals the classic element-major pattern."""
    def build():
        dofs = domain.elem_dofs(dofs_per_node)  # [E, nloc]
        E, nloc = dofs.shape
        n = domain.n_dofs(dofs_per_node)
        dT = dofs.T  # [nloc, E]
        rows = np.ascontiguousarray(np.broadcast_to(
            dT[:, None, :], (nloc, nloc, E))).reshape(-1)
        cols = np.ascontiguousarray(np.broadcast_to(
            dT[None, :, :], (nloc, nloc, E))).reshape(-1)
        return SparsityPattern.from_coo(rows, cols, n, n)

    return domain.pattern(("square_abe", dofs_per_node), build)


def assemble_fast(domain, op: str) -> CsrMatrix:
    """Assemble a scalar operator ("laplace" | "mass") on the fast path
    (callers gate on use_fast() and supported())."""
    flat = _KERNELS[op](domain.vert_coords_T(), domain.dim, domain.fe_type)
    return _assembled(domain, pattern_abe(domain, 1), flat)


# ---------------------------------------------------------------------------
# Scatter-assembly as a SELL SpMV: CSR data = P @ raw_values with P the 0/1
# plan matrix, applied by the windowed SELL operator (la/sell.py; on the
# card kernel B2).
#
# Layout (as in the JAX package): raw contributions are grouped
# ELEMENT-MAJOR (column of split h: e_local*S + s for section s of element
# e) so each CSR row's contributions sit in neighboring column windows, and
# the elements are dealt ROUND-ROBIN over n_splits sub-plans, so a node's
# incident elements split evenly and per-row slot counts stay small.  The
# default n_splits is the JAX package's: each split's x within 6.5 MB, the
# TPU kernel's VMEM budget for it.
# ---------------------------------------------------------------------------


def sell_assembly_plans(pattern, n_elements: int, dtype=torch.float32,
                        n_splits: int | None = None, device="cuda"):
    """Element-major round-robin SELL form of the assembly plan.
    pattern.coo_slots maps raw position (s*n_elements + e, section-major)
    → CSR slot, in the (a, b, E) order of `pattern_abe`.  The summed
    applies equal the segment-sum assembly (in `dtype`)."""
    from feddlib_tpu_torch.la.sell import SellMatrix

    slots = pattern.coo_slots
    n_raw = len(slots)
    if n_raw % n_elements:
        raise ValueError("plan length is not a multiple of n_elements")
    S = n_raw // n_elements
    if n_splits is None:
        # per-split x capped at ~6.5 MB (dtype-aware), the JAX rule
        isz = torch.empty(0, dtype=dtype).element_size()
        n_splits = max(1, -(-n_raw * isz // (6_500_000)))
    mats = []
    for h in range(n_splits):
        sel = np.arange(h, n_elements, n_splits)
        w = len(sel)
        raw = np.arange(S)[:, None] * n_elements + sel[None, :]   # [S, w]
        cols = np.arange(w)[None, :] * S + np.arange(S)[:, None]  # [S, w]
        P = sps.csr_matrix(
            (np.ones(S * w, np.float32),
             (slots[raw.ravel()], cols.ravel())),
            shape=(pattern.nnz, w * S))
        mats.append(SellMatrix.from_csr(P, dtype=dtype, device=device))
    return _InterleavedPlans(tuple(mats), S, n_splits, n_elements)


class _InterleavedPlans:
    def __init__(self, mats, S, H, n_elements):
        self.mats = mats
        self.S = S
        self.H = H
        self.n_elements = n_elements


def sell_assemble(plans, flat_vals, ops_list=None):
    """Apply the SELL assembly: [n_raw] raw element values (section-major,
    as produced by elem_*_flat_T) → [nnz] CSR data.  ops_list: optionally
    the per-split operand tuples (`sell_assembly_ops(plans)`)."""
    S, H, nE = plans.S, plans.H, plans.n_elements
    f2 = flat_vals.reshape(S, nE)
    out = None
    for h, sm in enumerate(plans.mats):
        fn, ops = sm.operator()
        if ops_list is not None:
            ops = ops_list[h]
        x = f2[:, h::H].T.reshape(-1)   # element-major split vector
        y = fn(ops, x)
        out = y if out is None else out + y
    return out


def sell_assembly_ops(plans):
    """Operand tuples for `sell_assemble(..., ops_list=...)`."""
    return tuple(sm.operands() for sm in plans.mats)
