"""Block preconditioners for saddle-point systems — the Teko / PrecBlock2x2
equivalents.  Counterpart of feddlib_tpu/precond/block_prec.py.

The operators act on the merged monolithic vector (u ++ p), so they drive
the same GMRES as the monolithic Schwarz path.  The velocity inverse Ã⁻¹
and the pressure Schur inverse S̃⁻¹ are pluggable applies — typically a
Schwarz apply on A and a scaled pressure-mass Jacobi (S ≈ −(1/ν) Mp for
Stokes)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix


def _inv_or(d: torch.Tensor, fill: float) -> torch.Tensor:
    """1/d where d ≠ 0, `fill` elsewhere."""
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d),
                       torch.full_like(d, fill))


class BlockDiagonalPreconditioner:
    """z = diag(Ã⁻¹, S̃⁻¹) r."""

    def __init__(self, n_u: int, inv_A: Callable, inv_S: Callable):
        self.n_u = n_u
        self.inv_A = inv_A
        self.inv_S = inv_S

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        ru, rp = r[: self.n_u], r[self.n_u:]
        return torch.cat([self.inv_A(ru), self.inv_S(rp)])

    __call__ = apply


class BlockTriangularPreconditioner:
    """Upper triangular: z_p = S̃⁻¹ r_p;  z_u = Ã⁻¹ (r_u − Bᵀ z_p)."""

    def __init__(self, n_u: int, inv_A: Callable, inv_S: Callable,
                 BT: CsrMatrix):
        self.n_u = n_u
        self.inv_A = inv_A
        self.inv_S = inv_S
        self.BT = BT

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        ru, rp = r[: self.n_u], r[self.n_u:]
        zp = self.inv_S(rp)
        zu = self.inv_A(ru - self.BT.matvec(zp))
        return torch.cat([zu, zp])

    __call__ = apply


class SimplePreconditioner:
    """SIMPLE(-C) block factorization:
        predictor: u* = Ã⁻¹ r_u
        corrector: δp = S̃⁻¹ (r_p − B u*),  S̃ ≈ B diag(A)⁻¹ Bᵀ
        update:    u  = u* − α diag(A)⁻¹ Bᵀ δp,  p = α δp
    """

    def __init__(self, n_u: int, inv_A: Callable, inv_S: Callable,
                 B: CsrMatrix, BT: CsrMatrix, diagA_inv: torch.Tensor,
                 alpha: float = 1.0):
        self.n_u = n_u
        self.inv_A = inv_A
        self.inv_S = inv_S
        self.B = B
        self.BT = BT
        self.dAi = diagA_inv
        self.alpha = alpha

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        ru, rp = r[: self.n_u], r[self.n_u:]
        u_star = self.inv_A(ru)
        dp = self.inv_S(rp - self.B.matvec(u_star))
        u = u_star - self.alpha * self.dAi * self.BT.matvec(dp)
        return torch.cat([u, self.alpha * dp])

    __call__ = apply


def pressure_mass_inverse(Mp: CsrMatrix, viscosity: float = 1.0,
                          lumped: bool = True) -> Callable:
    """S̃⁻¹ r = ν · (lumped or diagonal pressure mass)⁻¹ r (the sign is
    folded into the caller's convention)."""
    if lumped:  # row-sum lumping
        d = Mp.matvec(torch.ones(Mp.shape[0], dtype=Mp.dtype,
                                 device=Mp.device))
    else:
        d = Mp.diagonal()
    dinv = _inv_or(d, 0.0)
    return lambda r: viscosity * dinv * r


def schur_diag_inverse(A: CsrMatrix, B: CsrMatrix, BT: CsrMatrix) -> Callable:
    """The SIMPLE Schur complement S̃ = B diag(A)⁻¹ Bᵀ, inverted by Jacobi
    on its exact diagonal S_ii = Σ_k B_ik² / A_kk (assembly-free apply)."""
    dAi = _inv_or(A.diagonal(), 0.0)
    Bs = B.to_scipy()
    dS = torch.as_tensor(np.asarray(Bs.multiply(Bs) @ dAi.cpu().numpy()),
                         device=A.device)
    dSi = _inv_or(dS, 1.0)
    return lambda r: dSi * r
