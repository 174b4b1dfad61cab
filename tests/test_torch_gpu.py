"""The CUDA kernels of feddlib_tpu_torch against their plain PyTorch
versions on the card (marker `gpu`; skipped without a Hopper card).  This
file imports neither jax nor the JAX package, so it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: B1 bit-exact (a gather); B2 and B5 1e-6 and B3/B4 1e-5 relative
to max|y| (f32 sums in another order).  B3 stores reach 2.7 GB."""

import numpy as np
import pytest
import torch

from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.fe.host_assembly import host_poisson_dirichlet
from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.la import dense_kernels as dk
from feddlib_tpu_torch.la import sell
from feddlib_tpu_torch.la.permute import permute_gather, permute_gather_plain


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _hold_b1(x, it):
    before = _cuda.launch_counts["permute_gather"]
    y = permute_gather(x, it)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["permute_gather"] == before + 1
    assert y.shape == it.shape and y.dtype == torch.float32
    assert torch.equal(y, permute_gather_plain(x, it))
    return y


def _b1_case(device, n_in, n_out, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, n_in, n_out).astype(np.int32)
    x = rng.standard_normal(n_in).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(idx, device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("n_in,n_out", [
    (5000, 3000), (128, 1), (1, 0),
    # n_out % 4 = 1, 2, 3 and a last warp tile of outputs cut short
    (5000, 2), (5000, 3), (5000, 5), (5000, 6), (5000, 7), (5000, 4001),
    (5000, 4002), (5000, 4003), (823875, 823875),
    # more warp tiles than one wave of CTAs holds: the grid-stride loop
    (1_000_000, 3_000_003)])
def test_b1_permute_on_card(hopper, n_in, n_out):
    x, it = _b1_case(hopper, n_in, n_out, n_in + n_out)
    _hold_b1(x, it)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_b1_unaligned_plan_on_card(hopper, offset):
    """An idx view off 16-byte alignment (4, 8, 12 bytes)."""
    x, buf = _b1_case(hopper, 5000, offset + 3001, offset)
    it = buf[offset:]
    assert it.data_ptr() % 16 != 0
    _hold_b1(x, it)


@pytest.mark.gpu
def test_b1_unaligned_output_on_card(hopper):
    """A y off 16-byte alignment, through the C entry (the wrapper always
    allocates y itself); the element before y is not written."""
    x, it = _b1_case(hopper, 5000, 4003, 7)
    ybuf = torch.full((4004,), float("nan"), device=hopper)
    y = ybuf[1:]
    assert y.data_ptr() % 16 != 0
    _cuda.check(_cuda.lib().fedd_permute_gather_f32(
        x.data_ptr(), it.data_ptr(), y.data_ptr(), it.numel(),
        _cuda.stream_of(x)), "permute_gather")
    torch.cuda.synchronize()
    assert torch.equal(y, permute_gather_plain(x, it))
    assert torch.isnan(ybuf[0])


@pytest.mark.gpu
def test_b1_all_masked_on_card(hopper):
    """idx = -1 everywhere gives zeros and reads no x (x is all NaN)."""
    x = torch.full((1000,), float("nan"), device=hopper)
    it = torch.full((4099,), -1, dtype=torch.int32, device=hopper)
    y = _hold_b1(x, it)
    assert not bool(y.any())



@pytest.mark.gpu
@pytest.mark.parametrize("n,K", [(7, None), (12, 3)])
def test_b2_sell_on_card(hopper, n, K):
    K_sp, _ = host_poisson_dirichlet(Domain.structured(3, n, device="cpu"))
    A = sell.SellMatrix.from_csr(K_sp, dtype=torch.float32, K=K,
                                 device=hopper)
    nx2 = (K_sp.shape[1] + 127) // 128
    x2d = torch.randn(nx2, 128, device=hopper)
    y = sell.sell_spmv(A.vals, A.pidx, A.bids, x2d, A.E)
    y0 = sell.sell_spmv_plain(A.vals, A.pidx, A.bids, x2d, A.E)
    assert _rel(y, y0) < 1e-6
    x = torch.randn(K_sp.shape[1], device=hopper)
    ref = torch.as_tensor(K_sp @ x.cpu().double().numpy(), device=hopper)
    assert _rel(A.matvec(x).double(), ref) < 1e-5


def _random_sell(nchunks, E, K, nx2, seed, device, offset=0):
    """Random SELL planes: every slot reads some column of K random windows.
    `offset` > 0 starts vals and pidx that many elements into their buffers,
    so their data is not 16/8-byte aligned."""
    rng = np.random.default_rng(seed)
    n = nchunks * 8 * 128
    v = torch.as_tensor(rng.standard_normal(offset + n).astype(np.float32),
                        device=device)
    q = torch.as_tensor(rng.integers(0, K * 128, offset + n).astype(np.int16),
                        device=device)
    vals = v[offset:].view(nchunks, 8, 128)
    pidx = q[offset:].view(nchunks, 8, 128)
    bids = torch.as_tensor(rng.integers(0, nx2, (nchunks, K)).astype(
        np.int32), device=device)
    x2d = torch.as_tensor(rng.standard_normal((nx2, 128)).astype(np.float32),
                          device=device)
    return vals, pidx, bids, x2d


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 3, 16])
@pytest.mark.parametrize("E", [1, 2, 4, 8, 16, 32, 64, 128])
def test_b2_sell_every_E_and_K_on_card(hopper, E, K):
    vals, pidx, bids, x2d = _random_sell(37, E, K, 50, E * 100 + K, hopper)
    before = _cuda.launch_counts["sell_spmv"]
    y = sell.sell_spmv(vals, pidx, bids, x2d, E)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["sell_spmv"] == before + 1
    y0 = sell.sell_spmv_plain(vals, pidx, bids, x2d, E)
    assert y.shape == y0.shape == (37 * 1024 // E,)
    assert _rel(y, y0) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("E", [2, 16])
def test_b2_sell_unaligned_planes_on_card(hopper, E):
    vals, pidx, bids, x2d = _random_sell(300, E, 5, 40, E, hopper, offset=1)
    assert vals.is_contiguous() and vals.data_ptr() % 16 != 0
    y = sell.sell_spmv(vals, pidx, bids, x2d, E)
    assert _rel(y, sell.sell_spmv_plain(vals, pidx, bids, x2d, E)) < 1e-6


def _long_sell_matrix(n_chunks, E, seed):
    """Random banded CSR with E-slot rows filling `n_chunks` chunks: rows of
    1-3 entries, every 997th row 12 long, so that it spills past E = 8."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    n = n_chunks * 8 * (128 // E) - 5
    lens = rng.integers(1, 4, n)
    lens[::997] = 12
    rows = np.repeat(np.arange(n), lens)
    cols = np.clip(rows + rng.integers(-200, 201, rows.size), 0, n - 1)
    A = sps.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                       shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["20,000 chunks", "Laplace, K = 1"])
def test_b2_sell_many_chunks_spill_with_data_on_card(hopper, case):
    """More chunks than the persistent grid holds CTAs, rows that spill to
    the COO tail, and a with_data refill, against scipy in f64."""
    if case == "20,000 chunks":
        A = _long_sell_matrix(20_000, 8, seed=3)
        S = sell.SellMatrix.from_csr(A, dtype=torch.float32, E=8,
                                     device=hopper)
        assert S.vals.shape[0] >= 20_000
    else:
        A, _ = host_poisson_dirichlet(Domain.structured(3, 12, device="cpu"))
        S = sell.SellMatrix.from_csr(A, dtype=torch.float32, K=1,
                                     device=hopper)
    assert S.spill_rows is not None
    nx2 = (A.shape[1] + 127) // 128
    x2d = torch.randn(nx2, 128, device=hopper)
    before = _cuda.launch_counts["sell_spmv"]
    y = sell.sell_spmv(S.vals, S.pidx, S.bids, x2d, S.E)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["sell_spmv"] == before + 1
    assert _rel(y, sell.sell_spmv_plain(S.vals, S.pidx, S.bids, x2d, S.E)) \
        < 1e-6
    x = torch.randn(A.shape[1], device=hopper)
    ref = torch.as_tensor(A @ x.cpu().double().numpy(), device=hopper)
    assert _rel(S.matvec(x).double(), ref) < 1e-5
    S2 = S.with_data(torch.as_tensor(A.data * 2.0, device=hopper))
    assert _rel(S2.matvec(x).double(), 2.0 * ref) < 1e-5


def _block_matrix(nn, d, per_row, seed):
    """Random d x d node-blocked CSR: `per_row` node columns within a band
    around each node row."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nn), per_row)
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, nn - 1)
    P = sps.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(nn, nn))
    P.data[:] = 1.0
    A = sps.kron(P, np.ones((d, d))).tocsr()
    A.sort_indices()
    A.data = rng.standard_normal(A.nnz)
    return A


def _hold_b5(B, x2d):
    """B5 on the sliced layout against its plain version (1e-6 of max|y|)
    and against the plain version on the planes; one launch."""
    lay, pl, d = B.layout, B.plan, B.d
    nn = B.shape[0] // d
    x = x2d.reshape(d, -1)
    before = _cuda.launch_counts["block_sell_spmv"]
    y = sell.block_sell_slices(B.hvals, pl.hcols, pl.slice_ptr, pl.row_of, x,
                               nn)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["block_sell_spmv"] == before + 1
    y0 = sell.block_sell_slices_plain(B.hvals, pl.hcols, pl.slice_ptr,
                                      pl.row_of, x, nn)
    assert y.shape == y0.shape == (d, nn)
    assert _rel(y, y0) < 1e-6
    yp = sell.block_sell_spmv_plain(B.vals, lay.pidx, lay.bids, x2d, lay.E, d)
    assert _rel(y, yp[:, :nn]) < 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("d,E,nn,per_row,K", [
    (3, 16, 3000, 9, None),
    (2, 16, 140000, 5, None),    # 2,188 chunks: above the TPU's launch limit
    (3, 64, 20000, 40, None),
    (2, 128, 20000, 70, None),   # rows up to 70 slots
    (3, 64, 5000, 40, 2),        # spill through a small K
    (2, 16, 5000, 9, 1),         # spill, d = 2
    (4, 32, 2000, 20, None),     # d outside the unrolled cases
    (5, 8, 700, 6, 3),
])
def test_b5_block_sell_on_card(hopper, d, E, nn, per_row, K):
    A = _block_matrix(nn, d, per_row, seed=d * 1000 + E)
    B = sell.BlockSellMatrix.from_csr(A, d, dtype=torch.float32, E=E, K=K,
                                      device=hopper)
    assert B is not None and B.layout.E == E
    assert (B.spill_rows is not None) == (K is not None)
    nx2 = (nn + 127) // 128
    _hold_b5(B, torch.randn(d * nx2, 128, device=hopper))
    x = torch.randn(A.shape[0], device=hopper)
    ref = torch.as_tensor(A @ x.cpu().double().numpy(), device=hopper)
    assert _rel(B.matvec(x).double(), ref) < 1e-5
    B2 = B.with_data(torch.as_tensor(A.data * 2.0, device=hopper))
    assert _rel(B2.matvec(x).double(), 2.0 * ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("d,nn", [(3, 1001), (2, 77), (3, 5)])
def test_b5_ragged_slices_and_empty_rows_on_card(hopper, d, nn):
    """Row counts that are not a multiple of 32, rows with no entries (and
    a last slice of zero width), against scipy in f64."""
    import scipy.sparse as sps

    rng = np.random.default_rng(nn)
    lens = rng.integers(0, 12, nn)
    lens[::7] = 0
    lens[-min(nn, 40):] = 0
    rows = np.repeat(np.arange(nn), lens)
    cols = np.clip(rows + rng.integers(-50, 51, rows.size), 0, nn - 1)
    P = sps.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(nn, nn))
    A = sps.kron(P, np.ones((d, d))).tocsr()
    A.sort_indices()
    A.data = rng.standard_normal(A.nnz)
    B = sell.BlockSellMatrix.from_csr(A, d, dtype=torch.float32,
                                      device=hopper)
    widths = B.plan.slice_ptr.diff()
    assert int(widths[-1]) == 0 and B.plan.row_of.numel() % 32 != 0
    nx2 = (nn + 127) // 128
    _hold_b5(B, torch.randn(d * nx2, 128, device=hopper))
    x = torch.randn(A.shape[0], device=hopper)
    ref = torch.as_tensor(A @ x.cpu().double().numpy(), device=hopper)
    y = B.matvec(x)
    assert _rel(y.double(), ref) < 1e-5
    empty = np.flatnonzero(np.diff(A.indptr) == 0)
    assert len(empty) and float(y[torch.as_tensor(empty)].abs().max()) == 0


@pytest.mark.gpu
def test_auto_spmv_split_runs_b1_and_b5_on_card(hopper):
    """P2 elasticity on the card: auto_spmv gives the RCM split with a
    block-SELL residue, and one apply launches B5 once and B1 twice."""
    from feddlib_tpu_torch.fe import ops
    from feddlib_tpu_torch.la.dia import SplitDiaMatrix, auto_spmv

    dom = Domain.structured(3, 4, device=hopper).p2_domain()
    K = ops.assemble_lin_elasticity(dom, 1.0, 1.5)
    F = auto_spmv(K, dtype=torch.float32, dofs_per_node=3)
    assert isinstance(F, SplitDiaMatrix)
    assert isinstance(F.sell, sell.BlockSellMatrix)
    x = torch.randn(K.shape[0], device=hopper)
    _cuda.reset_launch_counts()
    y = F.matvec(x)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["block_sell_spmv"] == 1
    assert _cuda.launch_counts["permute_gather"] == 2
    ref = torch.as_tensor(K.to_scipy() @ x.cpu().double().numpy(),
                          device=hopper)
    assert _rel(y.double(), ref) < 1e-5


@pytest.mark.gpu
def test_f64_krylov_takes_block_dia_on_card(hopper):
    """LinElas with Jacobi on the card: the f64 branch applies A through a
    BlockDiaMatrix ('SpMV Format': 'auto') and agrees with the CPU solve."""
    from feddlib_tpu_torch.la.dia import BlockDiaMatrix
    from feddlib_tpu_torch.problems import LinElas
    from feddlib_tpu_torch.utils.config import ParameterList

    sol = {}
    for dev in ("cpu", hopper):
        pl = ParameterList("P", {"Preconditioner Type": "Jacobi"})
        p = LinElas(Domain.structured(3, 6, device=dev), parameter_list=pl,
                    device=dev)
        p.assemble()
        p.assemble_source(lambda x: [0.0, 0.0, -0.1])
        p.add_bc(lambda x, t: 0.0, 1, 0)
        p.set_boundaries_rhs()
        its = p.solve()
        assert p.last_relres <= 1e-8
        sol[str(dev)] = (its, p.solution[0].cpu())
        if dev != "cpu":
            assert isinstance(p._autofmt["fmt"], BlockDiaMatrix)
    assert abs(sol["cpu"][0] - sol[str(hopper)][0]) <= 2
    assert _rel(sol[str(hopper)][1], sol["cpu"][1]) < 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("P,R,W", [(8, 48, 136), (3, 40, 1001), (2, 9, 31)])
def test_b3_b4_gemv_on_card(hopper, P, R, W):
    g = torch.Generator(device=hopper).manual_seed(P + R + W)
    b = torch.randn(P, R, W, generator=g, device=hopper)
    x = torch.randn(P, W, generator=g, device=hopper)
    assert _rel(dk.dense_block_mv(b, x), dk.dense_block_mv_plain(b, x)) < 1e-5
    bb = b.to(torch.bfloat16)
    assert _rel(dk.dense_block_mv_lowp(bb, x),
                dk.dense_block_mv_lowp_plain(bb, x)) < 1e-5
    torch.cuda.synchronize()


# B3 at R x W, P the largest of 512, 128 and 1 whose store stays under
# 3 GB, and at P = 1
_B3_CASES = sorted({(P, R, W) for R in (1, 9, 544, 1624)
                    for W in (4, 1064, 3256, 4104)
                    for P in (1, next(p for p in (512, 128, 1)
                                      if 4 * p * R * W < 3e9))})


def _hold_b3(blocks, xs):
    before = _cuda.launch_counts["dense_gemv_f32"]
    y = dk.dense_block_mv(blocks, xs)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["dense_gemv_f32"] == before + 1
    y0 = dk.dense_block_mv_plain(blocks, xs)
    assert y.shape == y0.shape == blocks.shape[:2]
    assert _rel(y, y0) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("P,R,W", _B3_CASES)
def test_b3_gemv_rows_and_widths_on_card(hopper, P, R, W):
    g = torch.Generator(device=hopper).manual_seed(P * 31 + R * 7919 + W)
    _hold_b3(torch.randn(P, R, W, generator=g, device=hopper),
             torch.randn(P, W, generator=g, device=hopper))


@pytest.mark.gpu
@pytest.mark.parametrize("P,R,W,offset,x_offset", [
    (4, 40, 1001, 0, 0),     # W % 4 != 0: the general kernel
    (3, 9, 31, 0, 0),
    (4, 136, 376, 1, 0),     # a store 4 bytes past a 16-byte boundary
    (2, 544, 1064, 2, 0),
    (4, 136, 376, 0, 1),     # x 4 bytes past a 16-byte boundary
    (1, 20000, 16000, 0, 0),  # rows too long for the ring's stages
])
def test_b3_gemv_general_kernel_on_card(hopper, P, R, W, offset, x_offset):
    g = torch.Generator(device=hopper).manual_seed(P + R + W + offset)
    buf = torch.randn(offset + P * R * W, generator=g, device=hopper)
    blocks = buf[offset:].view(P, R, W)
    xbuf = torch.randn(x_offset + P * W, generator=g, device=hopper)
    xs = xbuf[x_offset:].view(P, W)
    assert (blocks.data_ptr() % 16 != 0) == (offset > 0)
    assert (xs.data_ptr() % 16 != 0) == (x_offset > 0)
    _hold_b3(blocks, xs)


def _hold_b4(blocks, xs):
    before = _cuda.launch_counts["dense_gemv_bf16"]
    y = dk.dense_block_mv_lowp(blocks, xs)
    torch.cuda.synchronize()
    assert _cuda.launch_counts["dense_gemv_bf16"] == before + 1
    y0 = dk.dense_block_mv_lowp_plain(blocks, xs)
    assert y.shape == y0.shape == blocks.shape[:2]
    assert _rel(y, y0) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 31, 376, 1001, 1064])
@pytest.mark.parametrize("R", [1, 9, 136, 544])
def test_b4_gemv_rows_and_widths_on_card(hopper, R, W):
    g = torch.Generator(device=hopper).manual_seed(R * 7919 + W)
    blocks = torch.randn(3, R, W, generator=g, device=hopper)
    _hold_b4(blocks.to(torch.bfloat16),
             torch.randn(3, W, generator=g, device=hopper))


@pytest.mark.gpu
@pytest.mark.parametrize("P,R,W,offset", [
    (1, 544, 1064, 0),     # one cluster: the rows spread over many CTAs
    (512, 136, 376, 0),    # the bench chain's level 1
    (4, 136, 376, 1),      # a view 2 bytes past a 16-byte boundary
    (4, 40, 64, 3),
    (2, 7, 4104, 0),       # rows longer than one pass of 8 pieces a lane
])
def test_b4_gemv_batch_and_alignment_on_card(hopper, P, R, W, offset):
    g = torch.Generator(device=hopper).manual_seed(P + R + W + offset)
    buf = torch.randn(offset + P * R * W, generator=g,
                      device=hopper).to(torch.bfloat16)
    blocks = buf[offset:].view(P, R, W)
    assert blocks.is_contiguous()
    assert (blocks.data_ptr() % 16 != 0) == (offset > 0)
    _hold_b4(blocks, torch.randn(P, W, generator=g, device=hopper))


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(hopper):
    x = torch.randn(10, device=hopper)
    with pytest.raises(TypeError):
        permute_gather(x.double(), torch.zeros(3, dtype=torch.int32,
                                               device=hopper))
    with pytest.raises(ValueError):
        dk.dense_block_mv(torch.randn(2, 3, 4, device=hopper),
                          torch.randn(2, 5, device=hopper))
    hvals = torch.zeros(2, 9, 32, device=hopper)
    hcols = torch.zeros(2, 32, dtype=torch.int32, device=hopper)
    ptr = torch.tensor([0, 2], device=hopper)
    row_of = torch.arange(20, dtype=torch.int32, device=hopper)
    with pytest.raises(ValueError):  # 9 block entries are d = 3, not 2
        sell.block_sell_slices(hvals, hcols, ptr, row_of,
                               torch.zeros(2, 128, device=hopper), 20)
    with pytest.raises(TypeError):
        sell.block_sell_slices(hvals.double(), hcols, ptr, row_of,
                               torch.zeros(3, 128, device=hopper), 20)
    with pytest.raises(ValueError):  # 40 rows need two slices
        sell.block_sell_slices(hvals, hcols, ptr, row_of.repeat(2),
                               torch.zeros(3, 128, device=hopper), 40)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_dense_block_schwarz_device_factor_on_card(hopper, symmetric):
    """The card's f32 factorization (Cholesky for symmetric matrices, else
    the batched LU solve, as Problem.solve's row-masked matrices take)
    matches the host f64 LU; 1e-3 relative covers the f32 factor and its
    1e-6 diagonal guard."""
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.la.dense_blocks import (DenseBlockSchwarz,
                                                   DenseBlockSpMV,
                                                   _blocks_symmetric)
    from feddlib_tpu_torch.mesh.partition import partition_points

    dom = Domain.structured(3, 8, device="cpu")
    K, _ = host_poisson_dirichlet(dom)
    if not symmetric:
        K = K.tolil()
        K[0, 1] = -0.25
        K = K.tocsr()
    cl = partition_points(dom.mesh.points, 8)
    out = {}
    for dev in ("cpu", hopper):
        A = CsrMatrix.from_scipy(K, device=dev)
        assert _blocks_symmetric(A) == symmetric
        db = DenseBlockSpMV.from_csr(A, cl, dtype=torch.float32)
        out[str(dev)] = DenseBlockSchwarz(A, db).inv.cpu()
    assert _rel(out[str(hopper)], out["cpu"]) < 1e-3


# -- the f64 Schwarz types and the two-field mixed path ----------------------

def _poisson_csr(device, n=8):
    dom = Domain.structured(3, n, device="cpu")
    K, b = host_poisson_dirichlet(dom)
    from feddlib_tpu_torch.la.csr import CsrMatrix

    return dom, K, CsrMatrix.from_scipy(K, device=device), b


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["one-level", "one-level-sparse",
                                  "Additive", "Multiplicative"])
def test_f64_schwarz_on_card_matches_cpu(hopper, kind):
    """SchwarzPreconditioner and TwoLevelSchwarz (f64, host inverses, the
    card's batched einsum and index_add) against the same on the CPU,
    within 1e-10 relative."""
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.gdsw import TwoLevelSchwarz
    from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner

    dom, K, _, _ = _poisson_csr("cpu")
    part = MeshPartition(dom.mesh, 8)
    mask = np.asarray(dom.mesh.point_flags) == 1
    r = np.random.default_rng(4).standard_normal(K.shape[0])
    z = {}
    for dev in ("cpu", hopper):
        _, _, A, _ = _poisson_csr(dev)
        if kind.startswith("one-level"):
            M = SchwarzPreconditioner(
                A, part.unique_map, combine="Averaging",
                solver="sparse" if kind.endswith("sparse") else "dense")
            assert (M.inv if M.slu is None else M.slu.L[0][2]).dtype \
                == torch.float64
        else:
            M = TwoLevelSchwarz(A, part.unique_map,
                                part.repeated_map.partition_indices,
                                dom.mesh.points, 1, dirichlet_mask=mask,
                                level_combination=kind)
        fn, ops = M.operator()
        z[str(dev)] = fn(ops, torch.as_tensor(r, device=dev)).cpu()
    assert _rel(z[str(hopper)], z["cpu"]) < 1e-10


@pytest.mark.gpu
def test_f32_schwarz_device_factor_on_card(hopper):
    """The f32 SchwarzPreconditioner factors its blocks on the card (the
    slot-carrying scatter and a batched inverse) and applies within 1e-4
    of the host f64 inverses (f32 roundoff and its 1e-6 diagonal guard)."""
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner

    dom, K, A, _ = _poisson_csr(hopper)
    part = MeshPartition(dom.mesh, 8)
    M32 = SchwarzPreconditioner(A, part.unique_map, dtype=torch.float32)
    assert M32.inv.dtype == torch.float32 and M32.inv.is_cuda
    M64 = SchwarzPreconditioner(_poisson_csr("cpu")[2], part.unique_map)
    r = np.random.default_rng(5).standard_normal(K.shape[0])
    z32 = M32.apply(torch.as_tensor(r, dtype=torch.float32, device=hopper))
    z64 = M64.apply(torch.as_tensor(r))
    assert _rel(z32.cpu().double(), z64) < 1e-4


@pytest.mark.gpu
def test_batched_sparse_lu_on_card(hopper):
    """The wavefront sweeps of BatchedSparseLU on the card against the CPU
    (and spsolve), padding lanes zero."""
    import scipy.sparse as sps

    from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU

    rng = np.random.default_rng(0)
    blocks = []
    for n in (40, 57, 64, 200):
        A = sps.random(n, n, density=0.05, random_state=int(rng.integers(1 << 30)),
                       format="csr")
        blocks.append((A + A.T + 10 * sps.identity(n)).tocsr())
    S = 200
    r = np.zeros((len(blocks), S))
    for i, b in enumerate(blocks):
        r[i, : b.shape[0]] = rng.standard_normal(b.shape[0])
    x = {}
    for dev in ("cpu", hopper):
        slu = BatchedSparseLU(blocks, S, device=dev)
        x[str(dev)] = slu.solve(torch.as_tensor(r, device=dev)).cpu()
    assert _rel(x[str(hopper)], x["cpu"]) < 1e-12
    for i, A in enumerate(blocks):
        n = A.shape[0]
        xe = sps.linalg.spsolve(A.tocsc(), r[i, :n])
        assert np.abs(x[str(hopper)][i, :n].numpy() - xe).max() < 1e-10
        if n < S:  # padding lanes stay zero
            assert float(x[str(hopper)][i, n:].abs().max()) == 0.0


@pytest.mark.gpu
def test_two_field_mixed_path_runs_b123_on_card(hopper):
    """A small P2/P1 cavity through Newton with 'Use Mixed Precision' and
    'SchwarzOneLevel': the balance=True dof-map clusters, B1, B2 and B3
    launched and each equal to its plain version at the solve's shapes,
    and the Newton iterate within 1e-6 of the CPU's (the pressure up to
    its constant: no pressure dof is pinned)."""
    from feddlib_tpu_torch.problems import NavierStokes
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver
    from feddlib_tpu_torch.utils.config import ParameterList

    def lid(x, t):
        on = x[2] > 1 - 1e-9
        return torch.stack([on.double(), 0.0 * x[0], 0.0 * x[0]])

    out = {}
    for dev in ("cpu", hopper):
        dom_p = Domain.structured(3, 3, device=dev)
        prob = NavierStokes(dom_p.p2_domain(), dom_p, parameter_list=(
            ParameterList("P", {"Viscosity": 0.1, "Use Mixed Precision": True,
                                "Preconditioner Type": "SchwarzOneLevel",
                                "Clusters": 8, "relNonLinTol": 1e-8})),
            device=dev)
        prob.assemble()
        prob.add_bc(lid, 1, 0)
        _cuda.reset_launch_counts()
        its = NonLinearSolver("Newton").solve(prob)
        u, p = (v.cpu() for v in prob.solution.blocks)
        out[str(dev)] = (its, torch.cat([u, p - p.mean()]))
    counts = dict(_cuda.launch_counts)
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        assert counts[k] > 0, counts
    assert out["cpu"][0] == out[str(hopper)][0]
    assert float((out["cpu"][1] - out[str(hopper)][1]).abs().max()) < 1e-6
    cache = prob._mixed_cache
    db, Ac, inv = cache["db32"], cache["sell"].Ac, cache["prec"].inv
    xp = torch.randn(db.P * db.R, device=hopper)
    _hold_b1(xp, db.ghost_plan[0])
    xg = torch.cat([xp, permute_gather(xp, db.ghost_plan[0])])
    nx2 = (Ac.shape[1] + 127) // 128
    x2d = torch.zeros(nx2 * 128, device=hopper)
    x2d[: Ac.shape[1]] = xg
    x2d = x2d.reshape(nx2, 128)
    y = sell.sell_spmv(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
    yp = sell.sell_spmv_plain(Ac.vals, Ac.pidx, Ac.bids, x2d, Ac.E)
    assert _rel(y, yp) < 1e-6
    xs = torch.randn(inv.shape[0], inv.shape[2], device=hopper)
    assert _rel(dk.dense_block_mv(inv, xs), dk.dense_block_mv_plain(inv, xs)) \
        < 1e-5


# -- deterministic assembly, the fast path, B2 as the scatter, hyperelasticity --

@pytest.mark.gpu
def test_csr_assembly_bitwise_repeatable_on_card(hopper):
    """CsrMatrix.assemble on a CUDA tensor takes the duplication plan's
    scatter-set (never index_add_'s atomics): two assemblies of one
    pattern are bitwise equal and equal the CPU assembly within 1e-14
    relative; so is the sorted segmented sum of a pattern whose plan is
    None, and la.csr.scatter_sum (the load vectors)."""
    from feddlib_tpu_torch.fe import fast_assembly as fa
    from feddlib_tpu_torch.la.csr import CsrMatrix, scatter_sum

    pat = fa.pattern_abe(Domain.structured(3, 12, device=hopper), 1)
    vals = np.random.default_rng(0).standard_normal(len(pat.coo_slots))
    ref = CsrMatrix(pat, device="cpu")
    ref.assemble(torch.as_tensor(vals))
    for force_sorted in (False, True):
        if force_sorted:
            object.__setattr__(pat, "_dup_plan", (None, 0))
            object.__setattr__(pat, "_dev_plans", {})
        got = []
        for _ in range(2):
            m = CsrMatrix(pat, device=hopper)
            m.assemble(torch.as_tensor(vals, device=hopper))
            got.append(m.data)
        assert pat._dev_plans[hopper][0] == ("sorted" if force_sorted
                                            else "set")
        assert torch.equal(got[0], got[1])
        assert _rel(got[0].cpu(), ref.data) < 1e-14
    v = torch.as_tensor(vals, device=hopper)
    idx = torch.as_tensor(pat.coo_slots, device=hopper)
    a, b = scatter_sum(v, idx, pat.nnz), scatter_sum(v, idx, pat.nnz)
    assert torch.equal(a, b) and _rel(a.cpu(), ref.data) < 1e-14


@pytest.mark.gpu
@pytest.mark.parametrize("fe", ["P1", "P2"])
def test_fast_assembly_matches_chunked_on_card(hopper, fe):
    """The element-last Laplace and mass (the card's default) against the
    chunked path on the card and against the CPU: same CSR structure,
    values within 1e-13 of max |data|; the advection operators too."""
    import os

    from feddlib_tpu_torch.fe import fast_assembly as fa
    from feddlib_tpu_torch.fe import ops

    dom = Domain.structured(3, 6, fe_type=fe, device=hopper)
    cpu = Domain.structured(3, 6, fe_type=fe, device="cpu")
    assert fa.use_fast(dom.device) and not fa.use_fast(cpu.device)
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(
        dom.n_dofs(3)))
    fast = [ops.assemble_laplace(dom), ops.assemble_mass(dom),
            ops.assemble_advection(dom, u.to(hopper)),
            ops.assemble_advection_in_u(dom, u.to(hopper))]
    os.environ["FEDD_FAST_ASSEMBLY"] = "0"
    try:
        dom2 = Domain.structured(3, 6, fe_type=fe, device=hopper)
        chunked = [ops.assemble_laplace(dom2), ops.assemble_mass(dom2),
                   ops.assemble_advection(dom2, u.to(hopper)),
                   ops.assemble_advection_in_u(dom2, u.to(hopper))]
    finally:
        os.environ.pop("FEDD_FAST_ASSEMBLY", None)
    host = [ops.assemble_laplace(cpu), ops.assemble_mass(cpu)]
    for i, (f, c) in enumerate(zip(fast, chunked)):
        scale = float(c.data.abs().max())
        assert abs(f.to_scipy() - c.to_scipy()).max() <= 1e-13 * scale
        if i < 2:
            assert np.array_equal(f.pattern.indices, c.pattern.indices)
            assert _rel(f.data.cpu(), host[i].data) < 1e-13


@pytest.mark.gpu
def test_sell_assemble_b2_on_card(hopper):
    """sell_assemble on the P1 Laplace plan of Domain.structured(3, 8) in
    f32, 3 splits: B2 launches once a split and its result is within
    1e-6 of max |y| of the plain SELL version (the same plans on the CPU),
    and within 1e-5 relative of the f64 assembly."""
    from feddlib_tpu_torch.fe import fast_assembly as fa

    dom = Domain.structured(3, 8, device=hopper)
    pat = fa.pattern_abe(dom, 1)
    flat = fa.elem_laplace_flat_T(dom.vert_coords_T(), 3, "P1")
    plans = fa.sell_assembly_plans(pat, dom.n_elements, n_splits=3,
                                   device=hopper)
    plans_cpu = fa.sell_assembly_plans(pat, dom.n_elements, n_splits=3,
                                       device="cpu")
    before = _cuda.launch_counts["sell_spmv"]
    y = fa.sell_assemble(plans, flat.float())
    torch.cuda.synchronize()
    assert _cuda.launch_counts["sell_spmv"] == before + 3
    y_p = fa.sell_assemble(plans_cpu, flat.float().cpu())
    assert float((y.cpu() - y_p).abs().max()) <= 1e-6 * float(
        y_p.abs().max())
    ref = fa.assemble_fast(dom, "laplace").data
    assert _rel(y.double(), ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("material", ["StVK", "Neo-Hooke", "Mooney-Rivlin"])
def test_hyperelastic_tangent_on_card_matches_cpu(hopper, material):
    """elem_hyper_residual_tangent (torch.func on the card) against the
    same call on the CPU, within 1e-12 relative."""
    from feddlib_tpu_torch.fe.hyperelastic import elem_hyper_residual_tangent

    params = {"StVK": (0.4, 0.6), "Neo-Hooke": (0.4, 0.6),
              "Mooney-Rivlin": (0.1, 0.1, 0.8)}[material]
    for fe in ("P1", "P2"):
        dom = Domain.structured(3, 4, fe_type=fe, device="cpu")
        # small enough that no element inverts (ln J of Neo-Hooke)
        de = 0.002 * np.random.default_rng(5).standard_normal(
            (dom.n_elements, dom.n_basis(), 3))
        vc = dom.vert_coords()
        R, K = elem_hyper_residual_tangent(vc, torch.as_tensor(de), 3, fe,
                                           material, params)
        Rg, Kg = elem_hyper_residual_tangent(
            vc.to(hopper), torch.as_tensor(de, device=hopper), 3, fe,
            material, params)
        assert _rel(Rg.cpu(), R) < 1e-12 and _rel(Kg.cpu(), K) < 1e-12


@pytest.mark.gpu
def test_unsteady_hyperelastic_on_card_matches_cpu(hopper):
    """Three BDF2 steps of NonLinElasticity (Neo-Hooke, f64 Jacobi-GMRES)
    on the card against the CPU, within 1e-8 relative; on the card the
    mixed-precision two-level path runs the same steps with B1-B3."""
    from feddlib_tpu_torch.fe import ops
    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary
    from feddlib_tpu_torch.problems import NonLinElasticity
    from feddlib_tpu_torch.solvers.timestepping import (DAESolverInTime,
                                                        TimeProblem)
    from feddlib_tpu_torch.utils.config import ParameterList

    def run(device, params):
        dom = Domain.structured(3, 4, device=device)
        flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
        prob = NonLinElasticity(dom, parameter_list=ParameterList("P", {
            "Material Model": "Neo-Hooke", **params}), device=device)
        prob.assemble()
        prob.add_bc(lambda x, t: [0.0, 0.0, 0.0], 2, 0)
        f = ops.assemble_rhs(dom, lambda x: [0.0, 0.0, -0.05], 3)
        drv = DAESolverInTime(TimeProblem(prob), 0.5, 1.5,
                              rhs_func=lambda t: BlockVector([f * t]))
        drv.advance_nonlinear_bdf(order=2)
        return prob.solution[0].cpu()

    f64 = {"Preconditioner Type": "Jacobi", "Maximum Iterations": 4000,
           "Convergence Tolerance": 1e-10}
    d_cpu, d_gpu = run("cpu", f64), run(hopper, f64)
    assert _rel(d_gpu, d_cpu) < 1e-8
    _cuda.reset_launch_counts()
    d_mixed = run(hopper, {"Use Mixed Precision": True, "TwoLevel": True,
                           "Null Space Type": "elasticity", "Clusters": 8,
                           "Convergence Tolerance": 1e-10})
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        assert _cuda.launch_counts[k] > 0
    assert _rel(d_mixed, d_cpu) < 1e-6


def _fsi_two_box(device, n, params):
    """The 2D two-box FSI of tests/test_fsi.py:24 (lid-driven fluid over a
    clamped elastic slab, the interface y = 0.5 flagged 9)."""
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh
    from feddlib_tpu_torch.problems import FSI
    from feddlib_tpu_torch.utils.config import ParameterList

    meshes = [build_structured_mesh(2, (n, n), lower=[0, 0.5], upper=[1, 1]),
              build_structured_mesh(2, (n, n), lower=[0, 0], upper=[1, 0.5])]
    for mesh in meshes:
        mesh.point_flags[np.isclose(mesh.points[:, 1], 0.5)] = 9
        on = np.all(np.isclose(mesh.points[mesh.surfaces][:, :, 1], 0.5),
                    axis=1)
        mesh.surface_flags[on] = 9
    dom_fp = Domain(meshes[0], device=device)
    prob = FSI(dom_fp.p2_domain(), dom_fp,
               Domain(meshes[1], device=device).p2_domain(), [9],
               parameter_list=ParameterList("P", {
                   "Viscosity": 0.1, "E": 50.0, "Poisson Ratio": 0.3,
                   "dt": 0.02, "MaxNonLinIts": 12, **params}),
               device=device)
    prob.assemble()

    def lid(x, t):
        on = torch.isclose(x[1], torch.ones((), dtype=x.dtype,
                                            device=x.device))
        return torch.stack([0.5 * on.double(), 0.0 * x[0]])

    prob.add_bc(lid, 1, 0)
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 2)
    return prob


@pytest.mark.gpu
@pytest.mark.parametrize("dim,fe", [(2, "P2"), (3, "P1"), (3, "P2")])
def test_ale_divergence_on_card_matches_cpu(hopper, dim, fe):
    """The ALE divergence operator assembled on the card against the CPU,
    within 1e-13 of max |data|."""
    from feddlib_tpu_torch.fe import ops

    dom_c = Domain.structured(dim, 3, fe_type=fe, device="cpu")
    dom_g = Domain.structured(dim, 3, fe_type=fe, device=hopper)
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(
        dom_c.n_dofs(dim)))
    D_c = ops.assemble_ale_divergence(dom_c, w)
    D_g = ops.assemble_ale_divergence(dom_g, w.to(hopper))
    assert np.array_equal(D_c.pattern.indices, D_g.pattern.indices)
    assert _rel(D_g.data.cpu(), D_c.data) < 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
def test_shape_derivative_blocks_on_card_match_cpu(hopper, dim):
    """D_ug, D_pg (torch.func.jacfwd inside vmap) on the card against the
    CPU, within 1e-12 of max |data|."""
    from feddlib_tpu_torch.fe.shape_derivatives import \
        assemble_shape_derivative_blocks

    out = []
    for device in ("cpu", hopper):
        dom_p = Domain.structured(dim, 3, device=device)
        dom_u = dom_p.p2_domain()
        rng = np.random.default_rng(8)
        n_u = dom_u.n_dofs(dim)
        out.append(assemble_shape_derivative_blocks(
            dom_u, dom_p, 0.1 * rng.standard_normal(n_u),
            rng.standard_normal(dom_p.n_nodes),
            0.01 * rng.standard_normal(n_u), 0.01 * rng.standard_normal(n_u),
            0.1 * rng.standard_normal(n_u), 0.7, 1.3, 0.05, 20.0))
    for a, b in zip(out[0], out[1]):
        assert _rel(b.data.cpu(), a.data) < 1e-12


@pytest.mark.gpu
def test_fsi_ge_step_on_card_matches_cpu(hopper):
    """One GE step of the 2D two-box FSI with FaCSI on the card against
    the CPU (equal GMRES counts, solution within 1e-8 relative); with mixed
    precision the four-field system runs B1-B3 on the card and reaches the
    same solution within 1e-6."""
    facsi = {"Preconditioner Type": "FaCSI", "Subdomains": 4,
             "Maximum Iterations": 8000, "Convergence Tolerance": 1e-9}
    runs = []
    for device in ("cpu", hopper):
        prob = _fsi_two_box(device, 4, facsi)
        prob.advance(t_end=0.02)
        runs.append((prob.nonlinear_solver.linear_iters,
                     prob.solution.concat().cpu()))
    assert runs[0][0] == runs[1][0]
    assert _rel(runs[1][1], runs[0][1]) < 1e-8
    _cuda.reset_launch_counts()
    prob = _fsi_two_box(hopper, 4, {
        "Use Mixed Precision": True, "Preconditioner Type": "SchwarzOneLevel",
        "Clusters": 4, "Convergence Tolerance": 1e-9})
    prob.advance(t_end=0.02)
    for k in ("permute_gather", "sell_spmv", "dense_gemv_f32"):
        assert _cuda.launch_counts[k] > 0
    assert _rel(prob.solution.concat().cpu(), runs[0][1]) < 1e-6


def _dist_plan(device):
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.spmd import DistributedCsr

    dom = Domain.structured(2, 16, device="cpu")
    K, _ = host_poisson_dirichlet(dom)
    part = MeshPartition(dom.mesh, 8)
    return dom, part, DistributedCsr(CsrMatrix.from_scipy(K, device=device),
                                     part.unique_map)


@pytest.mark.gpu
def test_stacked_collectives_on_card_match_cpu(hopper):
    """The shard-axis collectives (ppermute, psum, all_gather) and the halo
    exchanges built on them (the rounds' importer and exporter, the
    all_gather import) on the card equal the same calls on the CPU bit for
    bit; the all_gather export (a fixed-order scatter_sum on the card) and
    the ELL matvec (sums in another order) within 1e-14 relative.  psum's
    input is integer-valued, so any summation order is exact."""
    from feddlib_tpu_torch.parallel import spmd

    rng = np.random.default_rng(7)
    xg = None
    out = {}
    for dev in ("cpu", hopper):
        dom, part, dm = _dist_plan(dev)
        p = dm.plan
        if xg is None:
            xg = rng.standard_normal(dom.n_nodes)
            y_col = rng.standard_normal((8, p.N_o + p.G))
            ints = rng.integers(-1000, 1000, (8, 5000)).astype(np.float64)
        ax = spmd.DeviceAxis.make(8, device=dev)
        x = spmd.distribute_vector(xg, part.unique_map, p.N_o, device=dev)
        y = torch.as_tensor(y_col, device=dev)
        k = torch.as_tensor(ints, device=dev)
        out[str(dev)] = [
            ax.ppermute(y, [(0, 3), (3, 0), (5, 6)]),
            ax.psum(k), ax.all_gather(k),
            p.importer()(x, p.import_arrays),
            p.exporter()(y, p.export_arrays),
            spmd.import_ghosts(x, p.send_idx, p.ghost_src),
            spmd.export_add(y, p.N_o, p.recv_src, p.recv_dst),
            spmd.DistributedCsr.local_matvec(
                dm.ell_data, dm.ell_cols, p.importer()(x, p.import_arrays))]
    for i, (a, b) in enumerate(zip(out["cpu"], out[str(hopper)])):
        b = b.cpu()
        if i >= 6:
            assert _rel(b, a) < 1e-14
        else:
            assert torch.equal(a, b), i


def _dist_laplace(device, prec):
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    prob = Laplace(Domain.structured(2, 16, device=device),
                   parameter_list=ParameterList("P", {
                       "Use Distributed Solve": True, "Devices": 8,
                       "Preconditioner Type": prec}), device=device)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["SchwarzOneLevel", "SchwarzTwoLevel"])
def test_distributed_solve_on_card_matches_cpu(hopper, prec):
    """Problem.solve() with 'Use Distributed Solve' over 8 shards stacked
    on the card: the CPU's GMRES count, x within 1e-9 of max |x|, and
    every tensor of the shards on the card."""
    runs = []
    for dev in ("cpu", hopper):
        prob = _dist_laplace(dev, prec)
        runs.append((prob.solve(), prob.solution[0].cpu()))
    cache = prob._dist_cache
    assert cache["dmat"].ell_data.device.type == "cuda"
    assert cache["precond"][1][0].device.type == "cuda"
    assert runs[0][0] == runs[1][0]
    assert _rel(runs[1][1], runs[0][1]) < 1e-9


@pytest.mark.gpu
def test_distributed_solve_bitwise_repeatable_on_card(hopper):
    """Two distributed two-level solves on the card (fresh problems, fresh
    plans) give bitwise-equal iterates: no atomics over real duplicate
    contributions on the shard axis."""
    xs = []
    for _ in range(2):
        prob = _dist_laplace(hopper, "SchwarzTwoLevel")
        it = prob.solve()
        xs.append((it, prob.solution[0].clone()))
    assert xs[0][0] == xs[1][0]
    assert torch.equal(xs[0][1], xs[1][1])


def _ns_pipeline(device, n_parts=8):
    """A P2/P1 Navier–Stokes pipeline (vector Laplace, N(u), W(u), the
    divergence pair) on Domain.structured(3, 4) with a volume RHS, and a
    seeded merged solution on its shards."""
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline
    from feddlib_tpu_torch.parallel.spmd import DeviceAxis

    dom_p = Domain.structured(3, 4, device=device)
    dom_u = dom_p.p2_domain()
    pipe = DistributedPipeline(MeshPartition(dom_p.mesh, n_parts),
                               [(dom_u, 3), (dom_p, 1)])
    for i, j, kind, prm in [(0, 0, "laplace_vec", {"viscosity": 0.01}),
                            (0, 0, "advection", {}),
                            (0, 0, "advection_in_u", {}),
                            (0, 1, "divergence_T", {}),
                            (1, 0, "divergence", {})]:
        pipe.add_block(i, j, kind, **prm)
    pipe.add_rhs(0, lambda x, t: torch.stack(
        [torch.sin(x[0]) + t, x[1] * x[2], 0.0 * x[0]]))
    pipe.finalize(DeviceAxis.make(n_parts, device))
    x = np.random.default_rng(5).standard_normal(int(pipe.offsets[-1]))
    return pipe, pipe.distribute(x)


@pytest.mark.gpu
def test_pipeline_assembly_bitwise_repeatable_on_card(hopper):
    """Two assemblies on the card — the same pipeline twice, and a fresh
    pipeline — give bitwise-equal shards and device RHS: both segment sums
    take a fixed order, no atomics over real duplicates."""
    pipe, x = _ns_pipeline(hopper)
    a, b = pipe.assemble(x=x), pipe.assemble(x=x)
    assert a.ell_data.device.type == "cuda"
    assert torch.equal(a.ell_data, b.ell_data)
    pipe2, x2 = _ns_pipeline(hopper)
    assert torch.equal(a.ell_data, pipe2.assemble(x=x2).ell_data)
    assert torch.equal(pipe.assemble_rhs_device(0.3),
                       pipe2.assemble_rhs_device(0.3))


@pytest.mark.gpu
def test_pipeline_assembly_on_card_matches_cpu(hopper):
    """The card's pipeline shards and device RHS against the CPU's within
    1e-13 of max |a| (element sums in another order); the plans equal."""
    cpu, x_c = _ns_pipeline("cpu")
    card, x_g = _ns_pipeline(hopper)
    for k in ("seg_ids", "ell_src", "ell_cols"):
        assert torch.equal(getattr(cpu, k), getattr(card, k).cpu())
    a, b = cpu.assemble(x=x_c).ell_data, card.assemble(x=x_g).ell_data
    assert _rel(b.cpu(), a) < 1e-13
    assert _rel(card.assemble_rhs_device(0.3).cpu(),
                cpu.assemble_rhs_device(0.3)) < 1e-13


@pytest.mark.gpu
def test_fsi_distributed_facsi_on_card_matches_cpu(hopper):
    """Two GE time steps of the 2D two-box with 'Use Distributed Solve'
    (the multi-mesh pipeline and distributed FaCSI, 6 shards of which 2
    solid) on the card: the CPU's GMRES counts, the solution within 1e-8
    relative."""
    dist = {"Use Distributed Solve": True, "Devices": 6, "Solid Devices": 2,
            "Convergence Tolerance": 1e-10, "relNonLinTol": 1e-9}
    runs = []
    for device in ("cpu", hopper):
        prob = _fsi_two_box(device, 3, dist)
        prob.advance(t_end=0.04)
        runs.append((prob.nonlinear_solver.linear_iters,
                     prob.solution.concat().cpu()))
    assert prob._pipe_ge["pipe"].ell_src.device.type == "cuda"
    assert runs[0][0] == runs[1][0]
    assert _rel(runs[1][1], runs[0][1]) < 1e-8


# -- shards on several processes and AMR (parallel/multihost.py,
# mesh/refine.py); the scenarios are tests/test_torch_multihost.py's ----------


def _card_ranks_main():
    """A rank on the card: the collectives, the distributed CG and the
    pipeline + two-level GDSW GMRES on this rank's shards."""
    from test_torch_multihost import N_SHARDS, _cg, _collectives, _pipeline

    from feddlib_tpu_torch.parallel import multihost

    dev = multihost.local_device("cuda")
    torch.cuda.set_device(dev)
    axis = multihost.global_device_axis(N_SHARDS, dev)
    return {"backend": axis.backend, "slice": (axis.lo, axis.hi),
            "collectives": _collectives(axis), "cg": _cg(axis),
            "pipeline": _pipeline(axis)}


def _card_stacked(dev):
    from test_torch_multihost import N_SHARDS, _cg, _collectives, _pipeline

    from feddlib_tpu_torch.parallel.spmd import DeviceAxis

    axis = DeviceAxis.make(N_SHARDS, dev)
    return {"collectives": _collectives(axis), "cg": _cg(axis),
            "pipeline": _pipeline(axis)}


@pytest.mark.gpu
def test_two_gloo_ranks_on_card_match_stacked(hopper):
    """Two gloo ranks on the one card (device tensors staged through pinned
    host buffers) against the same shards stacked on the card: ppermute,
    all_gather and the gathered matrix bitwise, counts equal, x within
    1e-12."""
    from feddlib_tpu_torch.parallel import multihost

    two = multihost.launch(_card_ranks_main, 2, backend="gloo",
                           timeout=240)
    ref = _card_stacked(hopper)
    assert [r["slice"] for r in two] == [(0, 2), (2, 4)]
    for k in range(len(ref["collectives"]["ppermute"])):
        got = np.concatenate([r["collectives"]["ppermute"][k] for r in two])
        assert np.array_equal(got, ref["collectives"]["ppermute"][k])
    for r in two:
        assert r["backend"] == "gloo"
        assert np.array_equal(r["collectives"]["all_gather"],
                              ref["collectives"]["all_gather"])
        for stage in ("cg", "pipeline"):
            got, want = r[stage], ref[stage]
            assert got["iters"] == want["iters"]
            assert np.array_equal(got["ell"], want["ell"])
            rel = np.abs(got["x"] - want["x"]).max() / np.abs(
                want["x"]).max()
            assert rel <= 1e-12


@pytest.mark.gpu
def test_one_nccl_rank_on_card_bitwise_stacked(hopper):
    """World size 1 over NCCL: the collectives run through the process
    group and every result is bitwise the stacked run's."""
    from feddlib_tpu_torch.parallel import multihost

    (one,) = multihost.launch(_card_ranks_main, 1, backend="nccl",
                              timeout=240)
    ref = _card_stacked(hopper)
    assert one["backend"] == "nccl" and one["slice"] == (0, 4)
    for k, want in enumerate(ref["collectives"]["ppermute"]):
        assert np.array_equal(one["collectives"]["ppermute"][k], want)
    assert np.array_equal(one["collectives"]["psum"],
                          ref["collectives"]["psum"])
    for stage in ("cg", "pipeline"):
        assert one[stage]["iters"] == ref[stage]["iters"]
        assert np.array_equal(one[stage]["x"], ref[stage]["x"])
        assert np.array_equal(one[stage]["ell"], ref[stage]["ell"])


def _mesh_key(mesh):
    """The mesh's geometry, blind to point and element numbering."""
    pts = np.round(mesh.points, 12)
    uniq, rank = np.unique(pts, axis=0, return_inverse=True)
    el = np.sort(rank.reshape(-1)[mesh.elements[:, : mesh.dim + 1]], axis=1)
    return uniq.tobytes() + el[np.lexsort(el.T[::-1])].tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("mixed", [False, True])
def test_amr_cycles_on_card_match_cpu(hopper, mixed):
    """Two cycles of adaptive_solve_cycles (the distributed pipeline, or
    the mixed-precision solve; solves to 1e-12) on the card against the
    CPU: the same first mesh, and eta within rtol 1e-8 on every mesh the
    two runs share (the Dörfler cut may fall inside a group of exactly
    tied indicators on this symmetric mesh, which the last bits of u
    split)."""
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh
    from feddlib_tpu_torch.solvers.refinement import adaptive_solve_cycles
    from feddlib_tpu_torch.utils.config import ParameterList

    opts = ({"Use Mixed Precision": True, "TwoLevel": True, "Clusters": 8}
            if mixed else {"Use Distributed Solve": True, "Devices": 4,
                           "Use Device Pipeline": True})
    opts["Convergence Tolerance"] = 1e-12

    def f_t(x):
        return torch.exp(-100 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    def f_np(x):
        return float(np.exp(-100 * ((x[0] - .5) ** 2 + (x[1] - .5) ** 2)))

    out, keys = {}, {}
    for d in (hopper, torch.device("cpu")):
        keys[d.type] = []
        out[d.type] = adaptive_solve_cycles(
            build_structured_mesh(2, 16), f_t, cycles=2, theta=0.6,
            params=ParameterList("P", dict(opts)), source_np=f_np, device=d,
            callback=lambda c, prob, rec, k=keys[d.type]: k.append(
                _mesh_key(prob.domains[0].mesh)))
    assert keys["cuda"][0] == keys["cpu"][0]
    for a, b, ka, kb in zip(out["cuda"], out["cpu"], keys["cuda"],
                            keys["cpu"]):
        if ka != kb:
            break
        assert abs(a["eta"] - b["eta"]) <= 1e-8 * b["eta"]
