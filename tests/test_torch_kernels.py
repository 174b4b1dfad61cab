"""The port's four kernels (feddlib_tpu_torch, B1–B4) against the JAX
package's functions on the same numpy inputs.  On the CPU each wrapper runs
its plain PyTorch version; tests/test_torch_gpu.py holds the CUDA kernels
against those plain versions on the card.

Tolerances: B1 is a pure gather, so bit-exact.  B2–B4 sum in another order
than XLA's einsum/reductions: B2 ≤ 1e-6 relative to max|y|, B3 and B4 ≤ 1e-5
relative (f32 sums over a few hundred to a thousand terms)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.la import dense_blocks as jdb  # noqa: E402
from feddlib_tpu.la import sell as jsell  # noqa: E402
from feddlib_tpu.la.permute import PermutationGather as JPG  # noqa: E402

from feddlib_tpu_torch.la import _cuda  # noqa: E402
from feddlib_tpu_torch.la import dense_kernels as tdk  # noqa: E402
from feddlib_tpu_torch.la import sell as tsell  # noqa: E402
from feddlib_tpu_torch.la.permute import (PermutationGather as TPG,  # noqa: E402
                                          permute_gather)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _perm_case(kind, n_in, n_out, seed):
    rng = np.random.default_rng(seed)
    if kind == "local":  # cluster-ghost-like: short runs, few windows
        idx = np.sort(rng.integers(0, n_in, n_out))
    else:                 # scattered: many windows per chunk, plan spills
        idx = rng.integers(0, n_in, n_out)
    idx[rng.random(n_out) < 0.1] = -1
    x = rng.standard_normal(n_in).astype(np.float32)
    return idx.astype(np.int64), x


# -- B1 permutation gather -----------------------------------------------------

@pytest.mark.parametrize("kind,n_in,n_out,seed", [
    ("local", 3000, 2000, 0), ("random", 5000, 3000, 1),
    ("random", 200, 1000, 2), ("local", 700, 129, 3),
    # n_out % 4 = 1, 2, 3: the card kernel's ragged end after whole vectors
    ("random", 5000, 3001, 4), ("local", 3000, 2002, 5),
    ("random", 200, 1003, 6)])
def test_b1_permute_bit_exact(kind, n_in, n_out, seed):
    idx, x = _perm_case(kind, n_in, n_out, seed)
    pj = JPG(idx, n_in)
    if kind == "random" and n_in > 1000:
        assert pj.n_spill > 0  # the JAX plan's scatter tail is exercised
    yj = np.asarray(pj(jnp.asarray(x)))
    it = torch.as_tensor(idx.astype(np.int32))
    yt = permute_gather(torch.as_tensor(x), it)
    assert yt.dtype == torch.float32
    assert np.array_equal(yt.numpy(), yj)
    assert np.array_equal(TPG(idx, n_in, device="cpu")(torch.as_tensor(x)),
                          yj)
    # f64 vectors take the plain gather, as the JAX package's XLA path
    x64 = x.astype(np.float64)
    y64 = TPG(idx, n_in, device="cpu")(torch.as_tensor(x64))
    assert y64.dtype == torch.float64
    assert np.array_equal(y64.numpy(), np.asarray(pj(jnp.asarray(x64))))


def test_b1_rejects_out_of_range():
    with pytest.raises(ValueError):
        TPG(np.array([0, 5]), 5, device="cpu")


# -- B2 SELL SpMV --------------------------------------------------------------

def _sell_cases():
    rng = np.random.default_rng(0)
    n = 1000
    diags = [rng.standard_normal(n) for _ in range(7)]
    banded = sps.diags(diags, [-300, -4, -1, 0, 1, 4, 300], (n, n)).tocsr()
    rnd = sps.random(700, 900, density=0.02, random_state=1,
                     format="csr")
    from feddlib_tpu.fe.domain import Domain
    from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet

    fem, _ = host_poisson_dirichlet(Domain.structured(3, 7))
    return {"banded": (banded, None), "random_spill": (rnd, 4),
            "fem": (fem, None)}


_SELL = _sell_cases()


@pytest.mark.parametrize("case", sorted(_SELL))
def test_b2_sell_matches_xla_and_interpret(case):
    from jax.experimental.pallas import tpu as pltpu

    sp, K = _SELL[case]
    Aj = jsell.SellMatrix.from_csr(sp, dtype=jnp.float32, K=K)
    At = tsell.SellMatrix.from_csr(sp, dtype=torch.float32, K=K,
                                   device="cpu")
    # the port lays out the same planes as the JAX package
    assert (At.E, At.K) == (Aj.E, Aj.K)
    assert np.array_equal(At.vals.numpy(), np.asarray(Aj.vals))
    assert np.array_equal(At.pidx.numpy(), np.asarray(Aj.pidx))
    assert np.array_equal(At.bids.numpy(), np.asarray(Aj.bids))
    if K == 4:
        assert At.spill_rows is not None
    x = np.random.default_rng(3).standard_normal(sp.shape[1]).astype(
        np.float32)
    nx2 = (sp.shape[1] + 127) // 128
    x2d = np.zeros(nx2 * 128, np.float32)
    x2d[: sp.shape[1]] = x
    x2d = x2d.reshape(nx2, 128)
    y_xla = np.asarray(jsell._sell_mv_xla(Aj.vals, Aj.pidx, Aj.bids,
                                          jnp.asarray(x2d), Aj.E))
    with pltpu.force_tpu_interpret_mode():
        y_pal = np.asarray(jsell._sell_mv_pallas(Aj.vals, Aj.pidx, Aj.bids,
                                                 jnp.asarray(x2d), Aj.E))
    y_t = tsell.sell_spmv(At.vals, At.pidx, At.bids, torch.as_tensor(x2d),
                          At.E).numpy()
    assert _rel(y_t, y_xla) < 1e-6
    assert _rel(y_t[: len(y_pal)], y_pal) < 1e-6
    # whole operator, spill tail included
    assert _rel(At.matvec(torch.as_tensor(x)).numpy(),
                Aj.matvec(jnp.asarray(x))) < 1e-6


def test_b2_with_data_matches():
    sp, _ = _SELL["fem"]
    Aj = jsell.SellMatrix.from_csr(sp, dtype=jnp.float32)
    At = tsell.SellMatrix.from_csr(sp, dtype=torch.float32, device="cpu")
    d = np.random.default_rng(4).standard_normal(sp.nnz)
    Bj = Aj.with_data(jnp.asarray(d))
    Bt = At.with_data(torch.as_tensor(d))
    assert np.array_equal(Bt.vals.numpy(), np.asarray(Bj.vals))


# -- B3 / B4 batched dense-block GEMV -----------------------------------------

def _gemv_case(P, R, W, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P, R, W)).astype(np.float32),
            rng.standard_normal((P, W)).astype(np.float32))


@pytest.mark.parametrize("P,R,W", [(8, 48, 136), (3, 40, 1000),
                                   (5, 17, 33)])
def test_b3_gemv_matches_einsum(P, R, W):
    blocks, xs = _gemv_case(P, R, W, P + R)
    yj = np.asarray(jdb._batched_gemv(jnp.asarray(blocks), jnp.asarray(xs)))
    yt = tdk.dense_block_mv(torch.as_tensor(blocks), torch.as_tensor(xs))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (P, R)
    assert _rel(yt.numpy(), yj) < 1e-5


@pytest.mark.parametrize("P,R,W", [(8, 48, 136), (4, 136, 360),
                                   (2, 9, 31)])
def test_b4_gemv_bf16_matches_einsum(P, R, W):
    blocks, xs = _gemv_case(P, R, W, 7 * P + R)
    bj = jnp.asarray(blocks, jnp.bfloat16)
    bt = torch.as_tensor(blocks).to(torch.bfloat16)
    # both round the store to nearest even
    assert np.array_equal(bt.to(torch.float32).numpy(),
                          np.asarray(bj.astype(jnp.float32)))
    yj = np.asarray(jnp.einsum("prw,pw->pr", bj,
                               jnp.asarray(xs).astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32))
    yt = tdk.dense_block_mv_lowp(bt, torch.as_tensor(xs))
    assert yt.dtype == torch.float32
    assert _rel(yt.numpy(), yj) < 1e-5


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    _cuda.reset_launch_counts()
    x = torch.ones(10)
    permute_gather(x, torch.arange(10, dtype=torch.int32))
    tdk.dense_block_mv(torch.ones(2, 8, 16), torch.ones(2, 16))
    assert all(v == 0 for v in _cuda.launch_counts.values())
