"""The CUDA kernels (``potrf_inv``, ``lu_panel``, ``qr_panel``) against
their plain versions, and the LU solve, QR least squares, the generalized
eigensolver and the SVD through them, on the card.

Marked ``gpu``: on a machine without a card every test skips (the check is
made inside the test, so every worker collects the same tests).  On the
card: ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(``tests/conftest.py`` sets up JAX, which this file does not need).
``potrf_inv``'s bounds are those of ``tests/test_torch_chol_panel.py``,
scaled with w / 256 above w = 256; ``lu_panel``'s are those of
``tests/test_torch_lu_panel.py`` (identical pivots; ``||P[perm] - L U||
/ ||P||`` below 1e-5 at float32 and 1e-12 at float64), scaled with
M / 256 above M = 256; ``qr_panel``'s are those of
``tests/test_torch_qr_panel.py`` (``||F - Q R|| / ||F||`` and ``||Q^T Q -
I|| / sqrt(M)`` below 3e-6 at float32 and 1e-12 at float64, T equal to
``_larft(V, tau)`` of the kernel's own output), scaled with M / 256 above
M = 256 and, for T, with k / 64 above k = 64.  ``herm_gen_def_eig`` is
held to ``chip_smoke.py`` phase 3d's three gates (each ratio over N eps
below 16) and to the same call on the CPU; ``tridiag_eig`` on the card
to the same call on the CPU (float64 eigenvalues to 1e-10).  ``svd`` is
held to ``chip_smoke.py`` phase 3e's four gates and its launch counts at
float32, and ``svd``, ``polar``, ``herk`` and ``bidiag`` to the same
calls on the CPU.  ``ldl`` (one CUDA graph of its column) is held to the
same call on the CPU and ``symmetric_solve`` to ``chip_smoke.py`` phase
3g's gates; ``determinant``, ``glm``, ``ridge`` and ``riccati`` launch
their kernels as often as the drivers' blocking says.  The guarded
``lu`` / ``cholesky`` / ``qr`` recover from a one-shot fault with one
more launch of their kernel and a factor bit-equal to the clean guarded
run's, and ``certified_solve``'s compute-target escalation certifies at
'abft' (n = 4096, as ``chip_smoke.py`` phase 3j does at full width).
The serving executor's entries are captured graphs for 'hpd' and
'lstsq' and eager for 'lu', each bit-equal to the eager batched call;
the async front's donated double buffer is bit-equal to the sync pass;
warm geometries capture nothing; escalations launch their kernel N / nb
times; a fleet captures beside another member's eager LU (``-k
serve``).  The sparse SpMV pair is bit-equal run to run and within 1e-13
of the CPU; the sparse IPM's CG, one captured CUDA graph of masked
chunks, is bit-equal to the same chunks run eagerly; ``lp`` launches
``potrf_inv`` ceil(m / nb) times a factorization of its normal matrix
(``-k "spmv or pcg or lp_"``).  The static analysis: a registry
driver's comm plan with the kernels on the card is byte-equal to the
plain panels' on the CPU, the memory meter's peak is the allocator's,
and lint EL007's 'gpu' row is the card's (``-k analysis``).  The examples
and perf tools (``elemental_tpu_torch.examples`` / ``.perf``): the kernel
rows of ``ab_harness panel`` in float32 and float64 held against the plain
versions by ``chip_smoke.py`` phase 3p (b)'s checks, the float64 examples
launching their kernels, ``perf.kernels smoke`` and ``redist_bench
--smoke`` exiting 0 (``-k "harness or example or perf"``).  The device
grid (``Grid(2, 2, devices=["cuda:0"] * 4)``): at N = 1024 float64 its
tiles are bit-equal to the virtual 2x2 grid's storage for every move of
the ``hpd_solve`` path, ``hpd_solve`` matches ``torch.linalg.solve`` to
1e-10 with ``potrf_inv`` launched four times the virtual grid's count,
and with two or more cards the ranks' tiles sit on distinct cards (``-k
device_grid``); ``lu`` (classic and CALU), ``lu_solve`` and
``least_squares`` on it at n = 1024 float64 match the virtual grid's and
``torch.linalg`` with ``lu_panel`` / ``qr_panel`` launched four times the
virtual grid's count, and two ranks replaying one CALU sweep graph on a
card get pivot tensors of their own."""
import sys

import numpy as np
import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu_torch.kernels import (lu_panel, lu_panel_reference,
                                         potrf_inv, potrf_inv_reference,
                                         qr_panel, qr_panel_reference)
from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_v
from chip_smoke import (DEVICE_GRID_MOVES, eig_gates, panel_routes,
                        potrf_check, potrf_routes, qr_residuals, same_tiles)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 3e-6, torch.float64: 1e-12}
#: (w, bs): the CPU ladder, then the edges of the kernel's blocking (one
#: column; below, at and past a 32-column diagonal block and a 64-row
#: tile; blocks that do not divide w; a sub-block cap that does not divide
#: the block)
LADDER = [(48, 16), (96, 32), (16, 512), (128, 64), (512, 512), (2048, 512),
          (1, 512), (31, 512), (33, 512), (100, 512), (129, 512), (300, 7),
          (1000, 512)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _spd(w, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + w)
    G = torch.randn(w, w, generator=gen, device="cuda", dtype=dtype)
    return G @ G.T / w + w * torch.eye(w, device="cuda", dtype=dtype)


def _residual(L, Li, D):
    w = D.shape[0]
    eye = torch.eye(w, dtype=D.dtype, device=D.device)
    return max(float(torch.linalg.norm(L @ L.T - D) / torch.linalg.norm(D)),
               float(torch.linalg.norm(Li @ L - eye) / w ** 0.5))


@pytest.mark.parametrize("w,bs", LADDER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernel_matches_plain_version(w, bs, dtype):
    _need_card()
    D = _spd(w, dtype)
    before = potrf_inv.launches
    L, Li = potrf_inv(D, bs=bs)
    torch.cuda.synchronize()
    assert potrf_inv.launches == before + 1
    Lp, Lip = potrf_inv_reference(D, bs=bs)
    tol = TOL[dtype] * max(1.0, w / 256)
    rk, rp = _residual(L, Li, D), _residual(Lp, Lip, D)
    assert rk < tol and rk < 10 * rp + tol
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))


def test_kernel_reads_lower_triangle_of_a_strided_view():
    _need_card()
    big = _spd(96, torch.float64)
    junk = big + torch.triu(torch.ones_like(big), 1)
    L1, Li1 = potrf_inv(junk[:64, :64], bs=32)     # leading dimension 96
    L2, Li2 = potrf_inv(big[:64, :64].contiguous(), bs=32)
    torch.cuda.synchronize()
    assert torch.equal(L1, L2) and torch.equal(Li1, Li2)


#: the float64 route's edges: one column, below / at / past a 16-column
#: sub-block, a 64-column diagonal block and a 64-row tile, blocks that do
#: not divide w
F64_EDGES = [1, 17, 31, 33, 64, 65, 100, 129, 300, 1000]


@pytest.mark.parametrize("bs", [1, 16, 32])
@pytest.mark.parametrize("w", F64_EDGES)
def test_f64_route_matches_plain_version(w, bs):
    """The float64 route (DMMA products, 64-column blocks, 16-column base)
    against the plain version at its edges and under each sub-block cap:
    ``chip_smoke.py`` phase 2's check (residuals within RES_TOL float64
    scaled with w / 256, elementwise within ELEM_TOL), one launch, zero
    above the diagonal."""
    _need_card()
    D = _spd(w, torch.float64)
    before = potrf_inv.launches
    L, Li = potrf_inv(D, bs=bs)
    torch.cuda.synchronize()
    assert potrf_inv.launches == before + 1
    potrf_check(D, L, Li)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernel_gives_nans_on_a_block_that_is_not_positive_definite(dtype):
    """A negative pivot in the third diagonal block: the kernel's factor
    holds NaNs, as the plain version's does."""
    _need_card()
    D = _spd(100, dtype)
    D[70, 70] = -1e6
    L, Li = potrf_inv(D)
    torch.cuda.synchronize()
    Lp, _ = potrf_inv_reference(D)
    assert torch.isnan(L).any() and torch.isnan(Lp).any()
    assert torch.isfinite(L[:64, :64]).all()


def test_f64_route_reads_lower_triangle_of_a_strided_view():
    """The float64 route reads the lower triangle of a view of leading
    dimension 301, at an even width (16-byte rows of L and L^-1: operands
    staged by cp.async) and an odd one (staged element by element):
    bit-equal to the contiguous block's result."""
    _need_card()
    big = _spd(301, torch.float64)
    junk = big + torch.triu(torch.ones_like(big), 1)
    for w in (300, 129):
        L1, Li1 = potrf_inv(junk[:w, :w])
        L2, Li2 = potrf_inv(big[:w, :w].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(L1, L2) and torch.equal(Li1, Li2)


def test_f64_route_issues_dmma_and_f32_none():
    """The built library's SASS (``cuobjdump -sass``): DMMA in the float64
    kernel, none in the float32 one (``chip_smoke.potrf_routes``)."""
    _need_card()
    from elemental_tpu_torch.kernels import common
    got = potrf_routes(common.build(["potrf_inv"])["potrf_inv"])
    assert got["float64"]["DMMA"] > 0 and got["float32"]["DMMA"] == 0
    assert got["float32"]["FFMA"] > 0


def test_kernel_refuses_complex():
    _need_card()
    with pytest.raises(ValueError, match="real-only"):
        potrf_inv(torch.eye(8, dtype=torch.complex64, device="cuda"))


LU_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: (M, nbw, inner): the CPU ladder and panels of the 2x2 check's widths;
#: then the edges of the 128-column outer block (127, 128, 129 and 257
#: columns, ragged 48-column chunks) and M just below and above the slab
#: grain of 132 CTAs x 64 rows (past it the last CTAs' slabs are empty)
LU_LADDER = [(64, 16, 8), (33, 7, 4), (96, 64, 16), (200, 64, 64),
             (1024, 128, 64), (600, 160, 48), (1000, 127, 64),
             (1000, 128, 48), (1000, 129, 64), (2000, 257, 48),
             (8447, 300, 64), (8449, 300, 48)]


def _lu_residual(P, packed, perm):
    M, w = P.shape
    L = torch.tril(packed, -1) + torch.eye(M, w, dtype=P.dtype,
                                           device=P.device)
    U = torch.triu(packed[:w])
    return float(torch.linalg.norm(P[perm] - L @ U) / torch.linalg.norm(P))


@pytest.mark.parametrize("M,nbw,inner", LU_LADDER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_lu_panel_matches_plain_version(M, nbw, inner, dtype):
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + nbw)
    P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dtype)
    before = lu_panel.launches
    packed, perm = lu_panel(P, nbw, inner=inner)
    torch.cuda.synchronize()
    assert lu_panel.launches == before + 1
    ref, rperm = lu_panel_reference(P, nbw, inner)
    assert torch.equal(perm, rperm)
    tol = LU_TOL[dtype] * max(1.0, M / 256)
    assert _lu_residual(P, packed, perm) < tol
    assert float(torch.tril(packed, -1).abs().max()) <= 1.0


@pytest.mark.parametrize("M,nbw,inner,dtype", [
    (120000, 64, 16, torch.float32), (60000, 96, 64, torch.float64)],
    ids=["float32", "float64"])
def test_lu_panel_slab_too_large_for_shared_memory(M, nbw, inner, dtype):
    """Past ~117k rows (float) or ~58k (double) a thread block's slab of
    the chunk no longer fits shared memory and the kernel works on it in
    place in device memory: same pivots, same bound."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M)
    P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dtype)
    packed, perm = lu_panel(P, nbw, inner=inner)
    ref, rperm = lu_panel_reference(P, nbw, inner)
    assert torch.equal(perm, rperm)
    assert _lu_residual(P, packed, perm) < LU_TOL[dtype] * M / 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["nan", "zero"])
def test_lu_panel_nan_and_zero_columns(case, dtype):
    """A column with two NaNs (NaN ranks above every number and two NaNs
    tie, so the lower row is the pivot) and an all-zero column (every |v|
    ties at 0, so the first row is): the same pivots as the plain
    version, past an outer block."""
    _need_card()
    M, nbw, inner = 700, 200, 48
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dtype)
    if case == "nan":
        P[650, 150] = P[500, 150] = float("nan")
    else:
        P[:, 150] = 0.0
    packed, perm = lu_panel(P, nbw, inner=inner)
    ref, rperm = lu_panel_reference(P, nbw, inner)
    torch.cuda.synchronize()
    assert torch.equal(perm, rperm)
    # before the special column the factor is finite and bounded
    assert bool(torch.isfinite(packed[:, :150]).all())
    assert float(torch.tril(packed[:, :150], -1).abs().max()) <= 1.0


@pytest.mark.parametrize("M,nbw,inner,dtype", [
    (8449, 300, 48, torch.float32), (120000, 64, 16, torch.float32),
    (700, 200, 48, torch.float64), (16384, 256, 64, torch.float64)],
    ids=["float32", "float32-in-place", "float64", "float64-132-ctas"])
def test_lu_panel_repeats_bit_for_bit(M, nbw, inner, dtype):
    """The pivot key's maximum and the products do not depend on the
    order in which thread blocks arrive, so repeated calls agree bit for
    bit: a read that overtook its barrier would show here."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M + 3 * nbw)
    P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dtype)
    first, fperm = lu_panel(P, nbw, inner=inner)
    for _ in range(20):
        packed, perm = lu_panel(P, nbw, inner=inner)
        assert torch.equal(packed, first) and torch.equal(perm, fperm)


def test_lu_panel_ties_and_strided_view():
    _need_card()
    m, w = 32, 8
    rng = np.random.default_rng(3)
    T = np.zeros((m, w), dtype=np.float32)
    for j in range(w):
        T[:, j] = rng.integers(1, 4, size=m).astype(np.float32)
        T[j::5, j] = 3.0
        T[:, j] *= np.sign(rng.normal(size=m)) + 0.5
    P = torch.from_numpy(T).cuda()
    packed, perm = lu_panel(P, w, inner=4)
    ref, rperm = lu_panel_reference(P, w, 4)
    assert torch.equal(perm, rperm)
    # a strided view (leading dimension 96) gives the contiguous copy's
    # result, and the caller's tensor is not written
    big = torch.randn(300, 96, device="cuda", dtype=torch.float64)
    keep = big.clone()
    a, pa = lu_panel(big[40:, 16:48], 32, inner=16)
    b, pb = lu_panel(big[40:, 16:48].contiguous(), 32, inner=16)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert torch.equal(big, keep)


def test_lu_panel_f64_tie_panel():
    """The tie panel in float64: every pivot search meets equal |values|,
    which the 128-bit key gives to the lower row, as the plain version."""
    _need_card()
    from chip_smoke import _tie_panel
    P = _tie_panel(torch.float64)
    packed, perm = lu_panel(P, 8, inner=4)
    ref, rperm = lu_panel_reference(P, 8, 4)
    torch.cuda.synchronize()
    assert torch.equal(perm, rperm)
    assert float((packed - ref).abs().max()) < 1e-14


@pytest.mark.parametrize("name", ["lu_panel", "qr_panel"])
def test_panel_f64_products_issue_dmma_and_f32_none(name):
    """The built library's SASS: DMMA in every float64 product kernel of
    the panel kernel, none in its float32 products, and no float64 FMA
    product left (``chip_smoke.panel_routes``)."""
    _need_card()
    from elemental_tpu_torch.kernels import common
    got = panel_routes(common.build([name])[name], name)
    assert all(got["float64"].values()) and not any(got["float32"].values())


def test_lu_panel_refuses_what_the_kernel_does_not_take():
    _need_card()
    with pytest.raises(ValueError, match="real-only"):
        lu_panel(torch.ones(16, 4, dtype=torch.complex64, device="cuda"), 4,
                 inner=2)
    with pytest.raises(ValueError, match="inner"):
        lu_panel(torch.ones(16, 4, device="cuda"), 4, inner=0)
    with pytest.raises(ValueError, match="inner"):
        lu_panel(torch.ones(200, 100, device="cuda"), 100, inner=128)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_lu_solve_runs_through_the_kernel(grid):
    _need_card()
    n, nb = 512, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    A = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    B = torch.randn(n, 3, generator=gen, device="cuda", dtype=torch.float64)
    g = et.Grid(*grid)
    before = lu_panel.launches
    X = et.lu_solve(et.from_global(A, et.MC, et.MR, g),
                    et.from_global(B, et.MC, et.MR, g), nb=nb)
    x = et.to_global(X)
    torch.cuda.synchronize()
    launches = lu_panel.launches - before
    assert launches == n // nb if grid == (1, 1) else launches >= 1
    ref = torch.linalg.solve(A, B)
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) < 1e-10


QR_TOL = {torch.float32: 3e-6, torch.float64: 1e-12}
T_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: (M, k): k below, at and past the 32-column inner chunk and the
#: 128-column outer block, M off the slab grain; then M = k, M just below
#: and above the slab grain of 132 CTAs x 64 rows, and k not a multiple of
#: either block
QR_LADDER = [(33, 7), (64, 16), (200, 64), (1000, 100), (600, 130),
             (4097, 257), (300, 300), (8447, 300), (8449, 300), (2048, 130)]


def _panel_on_card(M, k, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(M * 7 + k + seed)
    return torch.randn(M, k, generator=gen, device="cuda", dtype=dtype)


def _check_qr_panel(F, dtype):
    M, k = F.shape
    before = qr_panel.launches
    packed, tau, T = qr_panel(F)
    torch.cuda.synchronize()
    assert qr_panel.launches == before + 1
    tol = QR_TOL[dtype] * max(1.0, M / 256)
    res, orth, _ = qr_residuals(F, packed, tau, T)
    assert res < tol and orth < tol
    Tl = _larft(_panel_v(packed), tau)
    terr = float(torch.linalg.norm(T - Tl) / torch.linalg.norm(Tl))
    assert terr < T_TOL[dtype] * max(1.0, k / 64)
    assert torch.equal(torch.tril(T, -1), torch.zeros_like(T))
    return packed, tau, T


@pytest.mark.parametrize("M,k", QR_LADDER)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_qr_panel_matches_plain_version(M, k, dtype):
    _need_card()
    F = _panel_on_card(M, k, dtype)
    packed, tau, T = _check_qr_panel(F, dtype)
    pp, ptau, pT = qr_panel_reference(F)
    tol = QR_TOL[dtype] * max(1.0, M / 256)
    rp, op, _ = qr_residuals(F, pp, ptau, pT)
    assert rp < tol and op < tol
    if dtype == torch.float64:
        scale = float(pp.abs().max())
        assert float((packed - pp).abs().max()) < 1e-10 * scale
        assert float((tau - ptau).abs().max()) < 1e-10


@pytest.mark.parametrize("M,k,dtype", [
    (70000, 96, torch.float32), (120000, 96, torch.float64)],
    ids=["float32-shared", "float64-in-place"])
def test_qr_panel_slab_paths(M, k, dtype):
    """A thread block's slab of a 32-column chunk in shared memory
    (float32 at 70000 rows) and, past ~113k rows in double, in place in
    device memory."""
    _need_card()
    _check_qr_panel(_panel_on_card(M, k, dtype), dtype)


def test_qr_panel_special_panels_and_strided_view():
    _need_card()
    # a zero column: tau = 0 exactly, beta = 0
    F = _panel_on_card(300, 70, torch.float32, seed=1)
    F[:, 66] = 0.0
    packed, tau, _ = _check_qr_panel(F, torch.float32)
    assert float(tau[66]) == 0.0 and float(packed[66:, 66].abs().max()) == 0.0
    # graded columns over 10 decades (float64)
    G = _panel_on_card(500, 80, torch.float64, seed=2)
    G *= torch.logspace(0, -10, 80, device="cuda", dtype=torch.float64)
    _check_qr_panel(G, torch.float64)
    # a strided view gives the contiguous copy's result, input unwritten
    big = _panel_on_card(400, 160, torch.float64, seed=3)
    keep = big.clone()
    a = qr_panel(big[40:, 16:96])
    b = qr_panel(big[40:, 16:96].contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(big, keep)


@pytest.mark.parametrize("M,k", [(4097, 257), (32768, 128)])
def test_qr_panel_f64_repeats_bit_for_bit(M, k):
    """The float64 route's partials are summed in a fixed order and its
    counting barriers let no read overtake them, so repeated calls agree
    bit for bit."""
    _need_card()
    F = _panel_on_card(M, k, torch.float64, seed=5)
    first = qr_panel(F)
    for _ in range(20):
        again = qr_panel(F)
        assert all(torch.equal(x, y) for x, y in zip(again, first))


def test_qr_panel_refuses_what_the_kernel_does_not_take():
    _need_card()
    with pytest.raises(ValueError, match="real-only"):
        qr_panel(torch.ones(16, 4, dtype=torch.complex64, device="cuda"))
    with pytest.raises(ValueError, match="M >= k"):
        qr_panel(torch.ones(3, 4, device="cuda"))


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_least_squares_runs_through_the_kernel(grid):
    _need_card()
    m, n, nb = 1024, 512, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    A = torch.randn(m, n, generator=gen, device="cuda", dtype=torch.float64)
    B = torch.randn(m, 3, generator=gen, device="cuda", dtype=torch.float64)
    g = et.Grid(*grid)
    before = qr_panel.launches
    X = et.least_squares(et.from_global(A, et.MC, et.MR, g),
                         et.from_global(B, et.MC, et.MR, g), nb=nb)
    x = et.to_global(X)
    torch.cuda.synchronize()
    assert qr_panel.launches - before == n // nb
    ref = torch.linalg.lstsq(A, B).solution
    assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) < 1e-10


def test_herm_gen_def_eig_runs_through_the_kernel_and_meets_the_gates():
    _need_card()
    n, nb = 1024, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    G = torch.randn(n, n, generator=gen, device="cuda")
    A = (G + G.T) / 2
    G = torch.randn(n, n, generator=gen, device="cuda")
    B = G @ G.T / n + n * torch.eye(n, device="cuda")
    g = et.Grid()
    before = potrf_inv.launches
    w, X = et.herm_gen_def_eig(et.from_global(A, et.MC, et.MR, g),
                               et.from_global(B, et.MC, et.MR, g), nb=nb)
    torch.cuda.synchronize()
    assert potrf_inv.launches - before == n // nb
    L = et.cholesky(et.from_global(B, et.MC, et.MR, g), nb=nb)
    C = et.two_sided_trsm("L", et.from_global(A, et.MC, et.MR, g), L, nb=nb)
    w_ref = torch.linalg.eigvalsh(C.local.double())
    res, orth, lam = eig_gates(A, B, X.local, w, w_ref)
    assert res < 16 and orth < 16 and lam < 16, (res, orth, lam)
    # the same call on the CPU (the plain potrf_inv): eigenvalues within
    # the gate of each other
    gc = et.Grid(device="cpu")
    wc, Xc = et.herm_gen_def_eig(et.from_global(A.cpu(), et.MC, et.MR, gc),
                                 et.from_global(B.cpu(), et.MC, et.MR, gc),
                                 nb=nb)
    neps = n * torch.finfo(torch.float32).eps
    assert float((w.cpu().double() - wc.double()).abs().max()
                 / w_ref.abs().max().cpu()) / neps < 16
    _, orth_c, _ = eig_gates(A.cpu(), B.cpu(), Xc.local, wc, w_ref.cpu())
    assert orth_c < 16


@pytest.mark.parametrize("branch", [dict(), dict(leaf_max=16, repl_max=64)],
                         ids=["default", "distributed"])
def test_tridiag_eig_on_the_card_matches_the_cpu(branch):
    """Eigenvalues to 1e-10 of the largest; the eigenvectors are held to
    the residual and orthogonality bounds of the JAX package's test of its
    distributed D&C (``tests/lapack/test_tridiag_eig.py:83-88``, 1e-9: a
    random tridiagonal has near-equal eigenvalues, whose eigenvectors two
    roundings may rotate apart, and the D&C's residual on this input is
    ~1.2e-10 on the CPU too)."""
    _need_card()
    n = 1024
    rng = np.random.default_rng(8)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    w, Z = et.tridiag_eig(torch.as_tensor(d, device="cuda"),
                          torch.as_tensor(e, device="cuda"), grid=et.Grid(),
                          **branch)
    wc, Zc = et.tridiag_eig(torch.as_tensor(d), torch.as_tensor(e),
                            grid=et.Grid(device="cpu"), **branch)
    assert w.is_cuda and Z.local.is_cuda
    np.testing.assert_allclose(w.cpu().numpy(), wc.numpy(), rtol=0,
                               atol=1e-10 * float(wc.abs().max()))
    z = et.to_global(Z).cpu().numpy()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.linalg.norm(T @ z - z * w.cpu().numpy()[None, :]) \
        / np.linalg.norm(T) < 1e-9
    assert np.linalg.norm(z.T @ z - np.eye(n)) < 1e-9 * n


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128],
                         ids=["f64", "c128"])
def test_hermitian_tridiag_on_the_card_matches_the_cpu(dtype):
    """The card replays one CUDA graph a column; the CPU runs the same
    column eagerly: d, e, tau and the packed storage to 1e-10 of their
    largest entry (n = 64, nb = 16: a ragged last panel; a wrong replay
    gives errors of order one, and the two devices' sums round apart by
    ~1e-11 at this n)."""
    _need_card()
    n, nb = 64, 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    G = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    F = (G + G.mH) / 2
    out = et.hermitian_tridiag(et.from_global(F, et.MC, et.MR, et.Grid()),
                               nb=nb)
    ref = et.hermitian_tridiag(et.from_global(F.cpu(), et.MC, et.MR,
                                              et.Grid(device="cpu")), nb=nb)
    for got, want in zip((out[0].local,) + out[1:],
                         (ref[0].local,) + ref[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * float(want.abs().max()))


def _align(Z, Zref):
    s = np.sign(np.real(np.sum(Z.conj() * Zref, axis=0)))
    s[s == 0] = 1
    return Z * s


def _qdwh_launches(n, nb, dtype):
    """(qr_panel, potrf_inv) launches of one ``polar`` of a tall (m, n)
    matrix on the 1x1 grid, from the QDWH schedule."""
    from elemental_tpu_torch.lapack import funcs
    eps = funcs._eps_of(dtype)
    sched = funcs._qdwh_schedule(eps, 10 * eps)
    n_qr = sum(1 for (_, _, c) in sched if c > 100.0)
    return n_qr * (n // nb), (len(sched) - n_qr) * (n // nb)


def test_svd_runs_through_the_kernels_and_meets_the_gates():
    """The Chan route at m = 2048, n = 1024 float32, nb = 128: Chan's qr
    and each QR step's qr launch qr_panel n / nb times, each Cholesky
    step's cholesky potrf_inv n / nb times; chip_smoke.py phase 3e's four
    gates (each ratio over n eps below 16)."""
    from chip_smoke import _svd_matrix, svd_gates
    _need_card()
    m, n, nb = 2048, 1024, 128
    A, s0 = _svd_matrix(m, n, seed=3)
    want_qr, want_potrf = _qdwh_launches(n, nb, torch.float32)
    before = (qr_panel.launches, potrf_inv.launches, lu_panel.launches)
    U, s, V = et.svd(et.from_global(A, et.MC, et.MR, et.Grid()), nb=nb)
    torch.cuda.synchronize()
    assert (qr_panel.launches - before[0], potrf_inv.launches - before[1],
            lu_panel.launches - before[2]) == (want_qr + n // nb,
                                               want_potrf, 0)
    assert max(svd_gates(A, U.local, s, V.local, s0)) < 16


@pytest.mark.parametrize("route", ["chan", "polar", "golub"])
def test_svd_on_the_card_matches_the_cpu(route):
    """float64, m = 512, n = 256, nb = 64 (the Chan route's R takes the
    polar route, n > 128): singular values to 1e-12 of the largest, U and
    V to 1e-9 after each column's sign is aligned."""
    _need_card()
    m, n, nb = (512, 256, 64) if route != "polar" else (256, 256, 64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    F = torch.randn(m, n, generator=gen, device="cuda", dtype=torch.float64)
    U, s, V = et.svd(et.from_global(F, et.MC, et.MR, et.Grid()), nb=nb,
                     approach=route)
    Uc, sc, Vc = et.svd(et.from_global(F.cpu(), et.MC, et.MR,
                                       et.Grid(device="cpu")), nb=nb,
                        approach=route)
    assert U.local.is_cuda and s.is_cuda
    np.testing.assert_allclose(s.cpu().numpy(), sc.numpy(), rtol=0,
                               atol=1e-12 * float(sc.max()))
    for got, want in ((U, Uc), (V, Vc)):
        g, w = et.to_global(got).cpu().numpy(), et.to_global(want).numpy()
        np.testing.assert_allclose(_align(g, w), w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape", [(384, 256), (256, 256), (256, 384)],
                         ids=["tall", "square", "wide"])
def test_polar_on_the_card_matches_the_cpu(shape):
    """float64, nb = 64: U and H to 1e-10 of the CPU's; the launches the
    QDWH schedule predicts (the wide case factors the adjoint)."""
    _need_card()
    nb = 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    F = torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float64)
    want_qr, want_potrf = _qdwh_launches(min(shape), nb, torch.float64)
    before = (qr_panel.launches, potrf_inv.launches)
    U, H = et.polar(et.from_global(F, et.MC, et.MR, et.Grid()), nb=nb)
    torch.cuda.synchronize()
    assert (qr_panel.launches - before[0],
            potrf_inv.launches - before[1]) == (want_qr, want_potrf)
    Uc, Hc = et.polar(et.from_global(F.cpu(), et.MC, et.MR,
                                     et.Grid(device="cpu")), nb=nb)
    for got, want in ((U, Uc), (H, Hc)):
        np.testing.assert_allclose(et.to_global(got).cpu().numpy(),
                                   et.to_global(want).numpy(), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_herk_on_the_card_matches_the_cpu(grid, dtype):
    """Both triangles and orientations, with and without C: the updated
    triangle to 1e-5 (f32) / 1e-12 (f64) of its largest entry, the other
    triangle C's bit for bit."""
    _need_card()
    m, k = 300, 200
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    X = torch.randn(m, k, generator=gen, device="cuda", dtype=dtype)
    C0 = torch.randn(m, m, generator=gen, device="cuda", dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for uplo in ("L", "U"):
        strict = (lambda x: torch.triu(x, 1)) if uplo == "L" \
            else (lambda x: torch.tril(x, -1))
        for orient, Xo in (("N", X), ("C", X.T.contiguous())):
            for C in (None, C0):
                outs = []
                for dev in ("cuda", "cpu"):
                    g = et.Grid(*grid, device=dev)
                    kw = {} if C is None else {
                        "alpha": 2.0, "beta": 0.5,
                        "C": et.from_global(C.to(dev), et.MC, et.MR, g)}
                    outs.append(et.to_global(et.herk(
                        uplo, et.from_global(Xo.to(dev), et.MC, et.MR, g),
                        orient=orient, nb=64, **kw)).cpu())
                got, want = outs
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=0, atol=tol * float(
                                               want.abs().max()))
                other = torch.zeros_like(got) if C is None else C0.cpu()
                assert torch.equal(strict(got), strict(other))


def test_bidiag_on_the_card_matches_the_cpu():
    """float64, 96 x 64, nb = 16: d, e, tauq, taup and the packed storage
    to 1e-10 of their largest entry."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    F = torch.randn(96, 64, generator=gen, device="cuda", dtype=torch.float64)
    out = et.bidiag(et.from_global(F, et.MC, et.MR, et.Grid()), nb=16)
    ref = et.bidiag(et.from_global(F.cpu(), et.MC, et.MR,
                                   et.Grid(device="cpu")), nb=16)
    for got, want in zip((out[0].local,) + out[1:],
                         (ref[0].local,) + ref[1:]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * float(want.abs().max()))


def test_ldl_on_the_card_matches_the_cpu():
    """The card replays one CUDA graph of the Bunch-Kaufman column; the CPU
    runs the same column eagerly.  float32 at N = 2048 (chip_smoke.py
    phase 3g's KKT matrix, nb = 512): the same inertia, the factor and
    solve residuals of 3g on the card's factor, and solutions within 1e-3
    of each other (the two devices' sums round apart, so a near tie may
    pivot differently; a wrong replay gives errors of order one).  float64
    at N = 256, nb = 32 (ragged): the same permutation, and d, e and the
    packed factor to 1e-10 of their largest entry."""
    _need_card()
    from chip_smoke import _kkt, _ldl_gates
    K, gen = _kkt(1536, 512, seed=73)
    B = torch.randn(2048, 4, generator=gen, device="cuda")
    Kd = et.from_global(K, et.MC, et.MR, et.Grid())
    Bd = et.from_global(B, et.MC, et.MR, et.Grid())
    Lp, d, e, perm = et.ldl(Kd, conjugate=False, nb=512)
    X = et.ldl_solve_after(Lp, d, e, perm, Bd, conjugate=False, nb=512)
    cpu = et.Grid(device="cpu")
    Lc, dc, ec, pc = et.ldl(et.from_global(K.cpu(), et.MC, et.MR, cpu),
                            conjugate=False, nb=512)
    Xc = et.ldl_solve_after(Lc, dc, ec, pc, et.from_global(B.cpu(), et.MC,
                                                           et.MR, cpu),
                            conjugate=False, nb=512)
    assert et.inertia(d, e) == et.inertia(dc, ec) == (1536, 512, 0)
    factor_res, solve_res = _ldl_gates(K, Lp.local, d, e, perm, X.local, B,
                                       gen)
    assert factor_res < 1e-5 and solve_res < 1e-5
    x, xc = X.local.cpu(), Xc.local
    assert float(torch.linalg.norm(x - xc) / torch.linalg.norm(xc)) < 1e-3
    gen.manual_seed(74)
    G = torch.randn(256, 256, generator=gen, device="cuda",
                    dtype=torch.float64)
    F = (G + G.T) / 2
    out = et.ldl(et.from_global(F, et.MC, et.MR, et.Grid()), nb=32)
    ref = et.ldl(et.from_global(F.cpu(), et.MC, et.MR, cpu), nb=32)
    assert torch.equal(out[3].cpu(), ref[3])
    for got, want in zip((out[0].local,) + out[1:3],
                         (ref[0].local,) + ref[1:3]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-10 * float(want.abs().max()))


def test_symmetric_solve_meets_the_3g_gates():
    """chip_smoke.py phase 3g at N = 4096 (n = 3072, p = 1024, nb = 512):
    the factor and solve residuals, the exact inertia, no kernel launch."""
    _need_card()
    from chip_smoke import _kkt, _ldl_gates
    K, gen = _kkt(3072, 1024, seed=75)
    B = torch.randn(4096, 8, generator=gen, device="cuda")
    before = (potrf_inv.launches, lu_panel.launches, qr_panel.launches)
    Kd = et.from_global(K, et.MC, et.MR, et.Grid())
    Lp, d, e, perm = et.ldl(Kd, conjugate=False, nb=512)
    X = et.ldl_solve_after(Lp, d, e, perm,
                           et.from_global(B, et.MC, et.MR, et.Grid()),
                           conjugate=False, nb=512)
    torch.cuda.synchronize()
    assert (potrf_inv.launches, lu_panel.launches, qr_panel.launches) \
        == before
    factor_res, solve_res = _ldl_gates(K, Lp.local, d, e, perm, X.local, B,
                                       gen)
    assert factor_res < 1e-3 and solve_res < 1e-4
    assert et.inertia(d, e) == (3072, 1024, 0)


def test_launch_counts_of_the_ldl_slice():
    """determinant (lu_panel), glm (potrf_inv), ridge (qr_panel) and
    riccati (lu_panel through sign's LU solves, qr_panel through
    least_squares) launch their kernels as many times as the drivers'
    blocking says, float32 on the 1x1 grid with nb = 128."""
    _need_card()
    funcs = sys.modules["elemental_tpu_torch.lapack.funcs"]
    nb = 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(76)

    def dm(x):
        return et.from_global(x, et.MC, et.MR, et.Grid())

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def counts(fn):
        before = (potrf_inv.launches, lu_panel.launches, qr_panel.launches)
        fn()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(
            (potrf_inv.launches, lu_panel.launches, qr_panel.launches),
            before))
    A = rnd(1024, 1024) / 32
    A.diagonal().add_(2.0)
    assert counts(lambda: et.determinant(dm(A), nb=nb)) == (0, 8, 0)
    assert counts(lambda: et.glm(dm(rnd(1024, 256)), dm(rnd(1024, 1536)),
                                 dm(rnd(1024, 1)), nb=nb)) == (10, 0, 0)
    assert counts(lambda: et.ridge(dm(rnd(2048, 512)), dm(rnd(2048, 2)),
                                   1.5, nb=nb)) == (0, 0, 4)
    n = 256
    calls = [0]
    real = funcs.lu_solve

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    Bk = rnd(n, 64) / 8
    Q = rnd(n, n)
    funcs.lu_solve = counted
    try:
        got = counts(lambda: et.riccati(dm(rnd(n, n) / 16), dm(Bk @ Bk.T),
                                        dm(Q @ Q.T / n + torch.eye(
                                            n, device="cuda")), nb=nb))
    finally:
        funcs.lu_solve = real
    assert calls[0] > 0 and got == (0, calls[0] * (2 * n // nb), n // nb)


# ---------------------------------------------------------------------
# CALU, TSQR and the redistribution routes (chip_smoke.py phase 3i)
# ---------------------------------------------------------------------

def _both_grids(F, rc, dist=("MC", "MR")):
    d = (et.Dist[dist[0]], et.Dist[dist[1]])
    return (et.from_global(F, *d, et.Grid(*rc)),
            et.from_global(F.cpu(), *d, et.Grid(*rc, device="cpu")))


@pytest.mark.parametrize("rc", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_calu_on_the_card_matches_the_cpu(rc):
    """The tournament on the card picks the CPU's pivots (float64), the
    crossover tail launches ``lu_panel`` as the blocking says, and the
    solve meets the JAX test's bound."""
    _need_card()
    n, nb = 1024, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    F = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    B = torch.randn(n, 4, generator=gen, device="cuda", dtype=torch.float64)
    Ad, Ac = _both_grids(F, rc)
    lu_panel.launches = 0
    LUd, pd = et.lu(Ad, nb=nb, panel="calu", crossover=256)
    assert lu_panel.launches == 2                      # the 256-wide tail
    LUc, pc = et.lu(Ac, nb=nb, panel="calu", crossover=256)
    assert torch.equal(pd.cpu(), pc)
    np.testing.assert_allclose(et.storage_numpy(LUd), et.storage_numpy(LUc),
                               rtol=0, atol=1e-10)
    X = et.lu_solve(Ad, et.from_global(B, et.MC, et.MR, Ad.grid), nb=nb,
                    panel="calu")
    x = et.to_global(X)
    assert float(torch.linalg.norm(F @ x - B) / torch.linalg.norm(B)) < 1e-10


@pytest.mark.parametrize("shift, bound", [(1.0, 5e-2), (0.0, 0.2)],
                         ids=["normal+nI", "normal"])
def test_calu_int8_wire_on_the_card(shift, bound):
    """Phase 3i's int8 checks at n = 1024: equal rounds, >= 1.9x fewer
    wire bytes, and the factor residual.  On the JAX test's matrix class
    (normal + n I, growth 1) it holds the JAX test's bound, 5e-2 (0.0157
    on the CPU).  On a plain normal matrix the pivot growth max|U|/max|A|
    (15-20) multiplies the wire's 2^-8 relative rounding: 0.075 on the
    card, 0.080-0.097 on the CPU over seeds 0-3, so the bound is 0.2."""
    _need_card()
    from chip_smoke import wire_totals
    from elemental_tpu_torch.redist import engine
    n, nb = 1024, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    F = torch.randn(n, n, generator=gen, device="cuda") \
        + shift * n * torch.eye(n, device="cuda")
    A = et.from_global(F, et.MC, et.MR, et.Grid(4, 1))
    with engine.redist_trace() as full:
        et.lu(A, nb=nb, panel="calu", crossover=256)
    with engine.redist_trace() as q8:
        LU, p = et.lu(A, nb=nb, panel="calu", crossover=256,
                      comm_precision="int8")
    assert wire_totals(q8)[0] == wire_totals(full)[0]
    assert wire_totals(full)[1] >= 1.9 * wire_totals(q8)[1]
    lu_ = et.to_global(LU)
    L, U = torch.tril(lu_, -1) + torch.eye(n, device="cuda"), torch.triu(lu_)
    assert float(torch.linalg.norm(F[p] - L @ U) / torch.linalg.norm(F)) \
        < bound


@pytest.mark.parametrize("rc", [(4, 1), (1, 1)], ids=["4x1", "1x1"])
def test_tsqr_on_the_card_matches_the_cpu(rc):
    _need_card()
    m, n, nb = 1024, 512, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    F = torch.randn(m, n, generator=gen, device="cuda", dtype=torch.float64)
    Ad, Ac = _both_grids(F, rc)
    qr_panel.launches = 0
    Pd, td = et.qr(Ad, nb=nb, panel="tsqr")
    assert qr_panel.launches == 0
    Pc, tc = et.qr(Ac, nb=nb, panel="tsqr")
    np.testing.assert_allclose(et.storage_numpy(Pd), et.storage_numpy(Pc),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(td.cpu().numpy(), tc.numpy(), rtol=0,
                               atol=1e-10)
    Q = et.to_global(et.explicit_q(Pd, td))
    R = torch.triu(et.to_global(Pd))[:n]
    assert float(torch.linalg.norm(Q[:, :n] @ R - F) / torch.linalg.norm(F)) \
        < 1e-12


def test_standalone_tsqr_on_the_card():
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    F = torch.randn(1024 * 16, 64, generator=gen, device="cuda")
    Q, R = et.tsqr(et.from_global(F, et.VC, et.STAR, et.Grid(2, 2)))
    q, r = et.to_global(Q).double(), et.to_global(R).double()
    assert float(torch.linalg.norm(q @ r - F.double())
                 / torch.linalg.norm(F.double())) < 1e-5
    assert float((q.T @ q - torch.eye(64, device="cuda",
                                      dtype=torch.float64)).abs().max()) < 1e-5


@pytest.mark.parametrize("cp", [None, "bf16", "int8"])
def test_direct_and_quantized_routes_on_the_card_match_the_cpu(cp):
    """Every legal pair of a 1024 x 1024 matrix on 2x4: ``path='direct'``
    and the chain give the same storage on the card as on the CPU, bit
    for bit, under each wire."""
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    F = torch.randn(1024, 1024, generator=gen, device="cuda") * 100
    for src in et.LEGAL_PAIRS:
        Sd, Sc = _both_grids(F, (2, 4), (src[0].value, src[1].value))
        for dst in et.LEGAL_PAIRS:
            for path in (None, "direct"):
                Bd = et.redistribute(Sd, *dst, comm_precision=cp, path=path)
                Bc = et.redistribute(Sc, *dst, comm_precision=cp, path=path)
                assert np.array_equal(et.storage_numpy(Bd),
                                      et.storage_numpy(Bc)), (src, dst, path)


# ---------------------------------------------------------------------
# the resilience layer on the card: each guarded driver recovers from a
# one-shot fault at panel step 1 with one more launch of its kernel, its
# factor bit-equal to the clean guarded run's; the compute-target
# escalation of certified_solve certifies at 'abft'; a bit flip under
# the compute threshold goes unseen
# ---------------------------------------------------------------------

_GUARDED_N, _GUARDED_NB = 4096, 512


def _guarded_run(rc, op):
    """A guarded run of ``op`` at n = 4096, nb = 512 on the card: returns
    a function giving (factor storage, pivots or tau, kernel launches,
    abft report) for a fresh call."""
    from elemental_tpu_torch.resilience import last_abft_report
    n = _GUARDED_N
    kern = {"lu": lu_panel, "hpd": potrf_inv, "qr": qr_panel}[op]
    driver = {"lu": "lu", "hpd": "cholesky", "qr": "qr"}[op]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    M = torch.randn(n, n, generator=gen, device="cuda")
    if op == "hpd":
        M = M @ M.T / n + n * torch.eye(n, device="cuda")
    A = et.from_global(M, et.MC, et.MR, et.Grid(*rc))

    def run():
        kern.launches = 0
        out = getattr(et, driver)(A, nb=_GUARDED_NB, abft=True)
        F = out[0] if isinstance(out, tuple) else out
        extra = out[1] if isinstance(out, tuple) else None
        return F.local, extra, kern.launches, last_abft_report(driver)
    return run


@pytest.mark.parametrize("op,target,kind", [
    ("lu", "compute", "scale"), ("lu", "redistribute", "nan"),
    ("hpd", "compute", "scale"), ("qr", "compute", "scale"),
    ("qr", "redistribute", "nan")])
@pytest.mark.parametrize("rc", [(1, 1), (2, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_guarded_driver_recovers_on_the_card(rc, op, target, kind):
    _need_card()
    from elemental_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                fault_injection)
    n, nb = _GUARDED_N, _GUARDED_NB
    run = _guarded_run(rc, op)
    F0, x0, k0, rep0 = run()
    assert k0 == n // nb and rep0["ok"] and rep0["violations"] == []
    plan = FaultPlan(seed=7, faults=[FaultSpec(target, kind, nelem=2,
                                               window=(1, 2))])
    with fault_injection(plan):
        F1, x1, k1, rep1 = run()
    assert plan.fired() >= 1
    assert k1 == n // nb + 1
    assert sorted({v["step"] for v in rep1["violations"]}) == [1]
    assert rep1["recompute_count"] == 1 and rep1["recovered_panels"] == [1]
    assert torch.equal(F0, F1)
    if x0 is not None:
        assert torch.equal(x0, x1)


@pytest.mark.parametrize("op", ["lu", "qr"])
@pytest.mark.parametrize("rc", [(1, 1), (2, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_guarded_driver_misses_a_small_bitflip_on_the_card(rc, op):
    """A two-element bit flip in computed panel 1 moves its columns' sums
    by less than the compute threshold, 64 eps (nb + sqrt(rows)) of a
    column's mass (the JAX package's): the guard reports a clean run,
    recomputes nothing, and hands back a factor unlike the clean one.
    Pinned, so that a change of the threshold shows either way."""
    _need_card()
    from elemental_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                fault_injection)
    n, nb = _GUARDED_N, _GUARDED_NB
    run = _guarded_run(rc, op)
    F0, _, _, _ = run()
    plan = FaultPlan(seed=7, faults=[FaultSpec("compute", "bitflip",
                                               nelem=2, window=(1, 2))])
    with fault_injection(plan):
        F1, _, k1, rep1 = run()
    assert plan.fired() == 1 and k1 == n // nb
    assert rep1["ok"] and rep1["violations"] == []
    assert rep1["recompute_count"] == 0
    assert not torch.equal(F0, F1)


def test_compute_escalation_certifies_at_abft_on_the_card():
    _need_card()
    from elemental_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                certified_solve,
                                                fault_injection)
    n, nb = 4096, 512
    S = _spd(n, torch.float32)
    g = et.Grid()
    A = et.from_global(S, et.MC, et.MR, g)
    B = et.from_global(torch.ones(n, 4, device="cuda"), et.MC, et.MR, g)
    per = n // nb
    plan = FaultPlan(seed=5, faults=[FaultSpec("compute", "nan", call=0),
                                     FaultSpec("compute", "nan", call=per)])
    potrf_inv.launches = 0
    with fault_injection(plan):
        X, info = certified_solve("hpd", A, B, nb=nb)
    assert info["certified"] and info["rung"] == "abft"
    assert [a["rung"] for a in info["attempts"]] == ["quant", "fast",
                                                     "refine", "abft"]
    assert [a["health"]["ok"] for a in info["attempts"][:2]] == [False,
                                                                 False]
    assert potrf_inv.launches == 3 * per


# ---------------------------------------------------------------------
# the tuner on the card
# ---------------------------------------------------------------------

@pytest.fixture
def empty_tune_cache(tmp_path, monkeypatch):
    from elemental_tpu_torch.tune import cache as tc, policy as tp
    monkeypatch.setenv(tc.ENV_DIR, str(tmp_path))
    tp.clear_memo()
    yield tmp_path
    tp.clear_memo()


def test_gemm_defaults_on_the_card_equal_dot(empty_tune_cache):
    """``gemm(A, B)`` with its defaults (``alg='auto'``) resolves to
    'dot' on the card's 1x1 grid and is bit-equal to ``alg='dot'``."""
    _need_card()
    g = et.Grid()
    gen = torch.Generator(device="cuda").manual_seed(3)
    A = et.from_global(torch.randn(4096, 256, generator=gen, device="cuda"),
                       et.MC, et.MR, g)
    B = et.from_global(torch.randn(256, 128, generator=gen, device="cuda"),
                       et.MC, et.MR, g)
    assert torch.equal(et.gemm(A, B).local, et.gemm(A, B, alg="dot").local)


def test_every_op_resolves_the_kernel_on_a_cuda_grid(empty_tune_cache):
    _need_card()
    g = et.Grid()
    for op in ("cholesky", "lu", "qr"):
        res = et.tune.resolve(op, gshape=(4096, 4096), dtype=torch.float32,
                              grid=g, requested={k: "auto" for k in
                                                 et.tune.OPS[op].knobs})
        assert res.config["panel_impl"] == "kernel", op
        assert res.key.backend == "gpu"


def test_measured_search_is_read_back(empty_tune_cache):
    """``measure.search`` on the card writes the winner; the next
    ``resolve`` reads it back (source 'cache'), and ``cholesky`` with
    ``nb='auto'`` then launches N / nb kernels."""
    _need_card()
    from elemental_tpu_torch.tune import measure
    g = et.Grid()
    winner, measured, key = measure.search("cholesky", (4096, 4096), g,
                                           torch.float32, top=2, reps=1)
    assert len(measured) == 2 and winner.seconds > 0
    assert all(m.config["panel_impl"] == "kernel" for m in measured)
    assert (empty_tune_cache / key.filename()).exists()
    res = et.tune.resolve("cholesky", gshape=(4096, 4096),
                          dtype=torch.float32, grid=g,
                          requested={"nb": "auto", "lookahead": "auto",
                                     "crossover": "auto"})
    assert res.source == "cache"
    assert res.config == {k: winner.config[k]
                          for k in ("nb", "lookahead", "crossover")}
    A = et.from_global(_spd(4096, torch.float32), et.MC, et.MR, g)
    potrf_inv.launches = 0
    et.cholesky(A, nb="auto")
    torch.cuda.synchronize()
    assert potrf_inv.launches == -(-4096 // winner.config["nb"])


# ---------------------------------------------------------------------
# tracing on the card (obs)
# ---------------------------------------------------------------------

def _tracer_and_timer():
    from elemental_tpu_torch import obs
    return obs.Tracer(), obs.PhaseTimer()


@pytest.mark.parametrize("op", ["hpd_solve", "lu_solve"])
def test_traced_flagship_is_bit_equal_and_launches_its_kernel(op):
    """Under an active Tracer and an explicit PhaseTimer (every tick a
    device sync) the solve is bit-equal to the untraced one, launches its
    kernel N / nb times, and ticks the JAX package's phase names."""
    _need_card()
    from elemental_tpu_torch import obs
    n, nb = 4096, 256
    g = et.Grid()
    if op == "hpd_solve":
        Ag, kern, phases = _spd(n, torch.float32), potrf_inv, \
            {"diag", "panel", "update"}
    else:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        Ag = torch.randn(n, n, generator=gen, device="cuda")
        kern, phases = lu_panel, {"panel", "swap", "solve", "update"}
    A = et.from_global(Ag, et.MC, et.MR, g)
    B = et.from_global(torch.ones(n, 8, device="cuda"), et.MC, et.MR, g)
    fn = getattr(et, op)
    X0 = fn(A, B, nb=nb)
    tracer = obs.Tracer()
    drv = "cholesky" if op == "hpd_solve" else "lu"
    kern.launches = 0
    with obs.metrics_scope() as reg:
        with tracer:
            X = fn(A, B, nb=nb)
        assert reg.counter_value("op_calls", op=drv) == 1
        assert reg.counter_value("op_calls", op="trsm") == 2
    torch.cuda.synchronize()
    assert kern.launches == n // nb
    assert torch.equal(X.local, X0.local)
    got = {r.phase for r in tracer.phases if r.driver == drv}
    assert phases <= got
    assert {r.step for r in tracer.phases if r.driver == drv} \
        == set(range(n // nb))
    # the factor alone with an explicit timer beside the tracer
    factor = et.cholesky if op == "hpd_solve" else et.lu
    F0 = factor(A, nb=nb)
    tracer, timer = _tracer_and_timer()
    with obs.metrics_scope():
        with tracer:
            F = factor(A, nb=nb, timer=timer)
    first = (lambda x: x) if op == "hpd_solve" else (lambda x: x[0])
    assert torch.equal(first(F).local, first(F0).local)
    assert [s["step"] for s in timer.report()["steps"]] \
        == list(range(n // nb))


def test_traced_calu_on_a_virtual_4x1_grid_skips_the_sync_in_capture():
    """CALU captures its tournament sweep as CUDA graphs; a tick must not
    synchronize while a capture is open.  The traced call equals the
    untraced one and records the tournament phases."""
    _need_card()
    from elemental_tpu_torch import obs
    n, nb = 2048, 128
    g = et.Grid(4, 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    A = et.from_global(torch.randn(n, n, generator=gen, device="cuda"),
                       et.MC, et.MR, g)
    LU0, p0 = et.lu(A, nb=nb, panel="calu")
    tracer, timer = _tracer_and_timer()
    with obs.metrics_scope():
        with tracer:
            LU, p = et.lu(A, nb=nb, panel="calu", timer=timer)
    torch.cuda.synchronize()
    assert torch.equal(p, p0) and torch.equal(LU.local, LU0.local)
    assert "tournament" in {r.phase for r in tracer.phases}
    assert timer.report()["steps"]


def test_block_until_ready_is_a_no_op_inside_a_graph_capture():
    _need_card()
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.obs.tracer import block_until_ready
    x = torch.ones(1024, device="cuda")
    tracer = obs.Tracer(metrics=False)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        y = (x * 3) + 1                               # warm-up
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x * 3
        block_until_ready(y)                          # would abort capture
        ch = tracer.channel("lu")
        ch.start()
        ch.tick("panel", 0, y)
        with tracer.span("inside", sync=y):
            y = y + 1
    graph.replay()
    torch.cuda.synchronize()
    assert float(y[0]) == 4.0 and len(tracer.phases) == 1


def test_timer_stop_waits_for_the_device():
    _need_card()
    a = torch.randn(4096, 4096, device="cuda")
    t = et.Timer("fence")
    t.start()
    out = a
    for _ in range(20):
        out = out @ a
        out = out / out.abs().max()
    split = t.stop(out)
    assert torch.cuda.current_stream().query()        # all work done
    assert split > 0


def test_obs_cli_runs_on_the_card(tmp_path):
    _need_card()
    import json
    import subprocess
    out = tmp_path / "trace.json"
    res = subprocess.run(
        [sys.executable, "-m", "elemental_tpu_torch.obs", "run", "cholesky",
         "--n", "4096", "--out", str(out)], capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["schema"] == "obs_metrics/v1"
    assert last["device"] == torch.cuda.get_device_name(0)
    assert json.loads(out.read_text())["schema"] == "obs_chrome_trace/v1"


# ---------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------

def _serve_requests(op, n, count, seed, nrhs=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        rows = 2 * n if op == "lstsq" else n
        F = rng.standard_normal((rows, n)).astype(np.float32)
        if op == "hpd":
            A = (F @ F.T / n + n * np.eye(n)).astype(np.float32)
        elif op == "lu":
            A = F + n * np.eye(n, dtype=np.float32)
        else:
            A = F
        out.append((op, A, rng.standard_normal((rows, nrhs)).astype(
            np.float32)))
    return out


@pytest.mark.parametrize("n,slots", [(16, 4), (512, 8), (1024, 2)])
def test_serve_entries_capture_per_op(n, slots):
    """The per-op table of the executor: 'hpd' and 'lstsq' entries are
    captured graphs whose replay is bit-equal to the eager batched call
    on the same inputs; 'lu' entries are eager (MAGMA's batched getrf
    syncs with the host above n = 128)."""
    _need_card()
    from elemental_tpu_torch.serve import ExecutableCache, make_bucket
    from elemental_tpu_torch.serve.executor import GRAPH_OPS, _kernel
    assert GRAPH_OPS == {"hpd", "lstsq"}
    cache = ExecutableCache()
    cache.place = torch.device("cuda", 0)
    for op in ("lu", "hpd", "lstsq"):
        b = make_bucket(op, n, 4, np.float32,
                        m=2 * n if op == "lstsq" else None)
        entry = cache.get(op, b, slots)
        assert (entry.graph is not None) == (op in GRAPH_OPS)
        reqs = _serve_requests(op, n, slots, 5)
        a = torch.from_numpy(np.stack([A for _, A, _ in reqs])).cuda()
        bb = torch.from_numpy(np.stack([B for _, _, B in reqs])).cuda()
        stream = cache._stream()
        with torch.cuda.stream(stream):
            x = entry.launch(a, bb).clone()
        stream.synchronize()
        ref = _kernel(op)(a, bb)
        torch.cuda.synchronize()
        assert torch.equal(x, ref)
    st = cache.stats()
    assert st["graph_ops"] == ["hpd", "lstsq"] and len(st["graphs"]) == 2


#: (n, slots) of batched LU solves whose capture failed on an H100
LU_UNCAPTURABLE = ((512, 8), (2048, 2), (4096, 4))

_LU_CAPTURE_CHILD = """
import json, sys, torch
from elemental_tpu_torch.serve.executor import _capture
dev = torch.device("cuda", 0)
for n, slots in json.loads(sys.argv[1]):
    try:
        _capture("lu", slots, n, n, 8, torch.float32, dev,
                 torch.cuda.Stream(dev))
        rec = {"n": n, "slots": slots, "captured": True}
    except Exception as exc:
        rec = {"n": n, "slots": slots, "captured": False,
               "error": f"{type(exc).__name__}: {exc}"[:200]}
    print(json.dumps(rec), flush=True)
"""


def test_serve_lu_batch_cannot_be_captured():
    """Why 'lu' is not in ``GRAPH_OPS``: the executor's own capture of the
    batched LU solve fails at each geometry of :data:`LU_UNCAPTURABLE`
    (MAGMA's batched getrf syncs with the host).  The captures run in a
    child process, whose CUDA context a failed capture may leave
    unusable."""
    _need_card()
    import json
    import subprocess
    from pathlib import Path
    out = subprocess.run([sys.executable, "-c", _LU_CAPTURE_CHILD,
                          json.dumps(LU_UNCAPTURABLE)],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [(r["n"], r["slots"]) for r in recs] == \
        list(LU_UNCAPTURABLE), out.stderr[-2000:]
    assert not any(r["captured"] for r in recs), recs


@pytest.mark.parametrize("depth", [2, 3])
def test_serve_async_double_buffer_is_bit_equal_to_sync(depth):
    """One bucket, 16 requests, ``max_batch`` 4: the async front keeps
    ``depth`` batches of the SAME captured entry in flight (donated
    inputs, one set of static buffers); every solution is bit-equal to
    the synchronous pass's."""
    _need_card()
    import threading
    from elemental_tpu_torch.serve import AsyncSolverService, SolverService
    work = _serve_requests("hpd", 256, 16, 7)
    svc = SolverService(et.Grid(), max_batch=4)
    ids = [svc.submit(op, A, B) for op, A, B in work]
    svc.drain()
    front = AsyncSolverService(grid=et.Grid(), max_batch=4, depth=depth,
                               autostart=False)
    assert front.donate
    futs = [front.submit(op, A, B) for op, A, B in work]
    front.start()
    outs = [f.result(timeout=120) for f in futs]
    front.shutdown(drain=True)
    assert not any(t.name.startswith("elemental-serve-worker")
                   and t.is_alive() for t in threading.enumerate())
    ent = front.service.executor.cache.stats()
    assert ent["entries"] == ["hpd__b256x4__x4__float32__gpu__donated"]
    for rid, (x, doc) in zip(ids, outs):
        assert doc["status"] == "ok"
        assert np.array_equal(x, svc.solutions[rid])


def test_serve_warm_geometries_capture_nothing():
    _need_card()
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.serve import SolverService
    work = (_serve_requests("hpd", 200, 5, 1)
            + _serve_requests("lstsq", 100, 3, 2)
            + _serve_requests("lu", 300, 6, 3))
    svc = SolverService(et.Grid(), max_batch=4)

    def one_pass():
        ids = [svc.submit(op, A, B) for op, A, B in work]
        docs = svc.drain()
        return [docs[i]["status"] for i in ids]

    assert set(one_pass()) == {"ok"}
    with obs.metrics_scope() as reg:
        assert set(one_pass()) == {"ok"}
        events = {dict(lb)["event"]: v for (_, lb), v in
                  reg.counters("serve_exec_cache_events").items()}
    assert events.get("compile", 0) == 0 and events["hit"] > 0


def test_serve_escalation_launches_the_kernels():
    """``fastpath=False``: 'hpd' and 'lu' certify through
    ``certified_solve`` (N / nb launches of ``potrf_inv`` / ``lu_panel``
    a refactorization), 'lstsq' through ``least_squares(abft=True)``
    (n / nb launches of ``qr_panel``)."""
    _need_card()
    from elemental_tpu_torch.serve import SolverService
    n, nb = 512, 128
    svc = SolverService(et.Grid(), fastpath=False, escalate_nb=nb)
    for op, kern in (("hpd", potrf_inv), ("lu", lu_panel),
                     ("lstsq", qr_panel)):
        (_, A, B), = _serve_requests(op, n, 1, 11)
        for k in (potrf_inv, lu_panel, qr_panel):
            k.launches = 0
        X, doc = svc.solve(op, A, B)
        assert doc["status"] == "ok" and doc["path"] == "escalated"
        assert kern.launches == n // nb, (op, kern.launches)
        assert potrf_inv.launches + lu_panel.launches + qr_panel.launches \
            == n // nb


def test_serve_fleet_captures_beside_eager_lu():
    """Two pipelined members with cold caches: one captures its 'hpd' /
    'lstsq' entries while the other runs MAGMA's eager batched LU (the
    pairing that broke a capture before the device gate); every request
    certifies and no worker is left."""
    _need_card()
    import threading
    from elemental_tpu_torch.serve import SolverFleet
    work = []
    for i, (op, n) in enumerate([("lu", 512), ("hpd", 384), ("lstsq", 256),
                                 ("lu", 768), ("hpd", 640), ("lu", 300)]
                                * 3):
        work += _serve_requests(op, n, 1, 100 + i)
    fleet = SolverFleet(grids=2, depth=3, max_batch=2, shed=False)
    futs = [fleet.submit(op, A, B, tenant=f"t{i % 2}")
            for i, (op, A, B) in enumerate(work)]
    outs = [f.result(timeout=120) for f in futs]
    fleet.shutdown(drain=True)
    assert not any(t.name.startswith("elemental-serve-worker")
                   and t.is_alive() for t in threading.enumerate())
    assert all(d["status"] == "ok" for _, d in outs)
    assert {d["grid"] for _, d in outs} == {"g0", "g1"}


def test_serve_fleet_calu_escalation_beside_eager_lu():
    """Member g0 (a 2x2 virtual grid) escalates every 'lu' request, so
    its drivers capture CALU's pivot sweeps in the global capture mode,
    while member g1 runs MAGMA's eager batched LU and captures its own
    'hpd' entries: the escalation holds the device gate alone, and every
    request certifies."""
    _need_card()
    import threading
    from elemental_tpu_torch.serve import SolverFleet
    fleet = SolverFleet(grids=2, depth=3, max_batch=2, shed=False)
    esc = fleet.services[0]
    assert esc.grid.height == 2 and esc.grid.width == 2
    esc.fastpath, esc.escalate_nb = False, 128
    futs = []
    for i in range(6):
        (_, A, B), = _serve_requests("lu", 512, 1, 200 + i)
        futs.append((0, fleet.workers[0].submit("lu", A, B)))
        for op, n in (("lu", 640), ("hpd", 384 + 64 * i)):
            (_, A, B), = _serve_requests(op, n, 1, 300 + 2 * i)
            futs.append((1, fleet.workers[1].submit(op, A, B)))
    outs = [(m, f.result(timeout=300)) for m, f in futs]
    fleet.shutdown(drain=True)
    assert not any(t.name.startswith("elemental-serve-worker")
                   and t.is_alive() for t in threading.enumerate())
    for m, (_, doc) in outs:
        assert doc["status"] == "ok", doc
        assert doc["path"] == ("escalated" if m == 0 else "fastpath")
    assert {doc["rung"] for m, (_, doc) in outs if m == 0} <= {
        "quant", "fast", "refine"}


# ---------------------------------------------------------------------
# the solvers of the long tail: sparse SpMV, the captured CG, the LP
# ---------------------------------------------------------------------

def _laplacian_2d(k):
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (r + dr >= 0) & (r + dr < k) & (c + dc >= 0) & (c + dc < k)
        rows.append(i[ok])
        cols.append(((r + dr) * k + c + dc)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


@pytest.mark.parametrize("rc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_spmv_on_the_card_is_bit_equal_run_to_run(rc):
    """The segment-sum SpMV pair: two calls give the same bits (no
    atomics), and the card agrees with the CPU to 1e-13."""
    _need_card()
    from elemental_tpu_torch.core.multivec import mv_from_global
    rows, cols, vals, n = _laplacian_2d(200)
    rng = np.random.default_rng(0)
    vals = vals * rng.uniform(0.5, 1.5, vals.size)      # nonsymmetric
    X = rng.normal(size=(n, 3))
    out = {}
    for dev in ("cuda", "cpu"):
        g = et.Grid(*rc, device=dev)
        A = et.dist_sparse_from_coo(rows, cols, vals, n, n, grid=g)
        x = mv_from_global(X, grid=g)
        y1, y2 = A.spmv(x), A.spmv(x)
        a1, a2 = A.spmv_adjoint(x), A.spmv_adjoint(x)
        assert torch.equal(y1.local, y2.local)
        assert torch.equal(a1.local, a2.local)
        out[dev] = (y1.local.cpu(), a1.local.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max()) \
            <= 1e-13 * float(want.abs().max())


def test_pcg_graph_replay_is_bit_equal_to_the_eager_masked_loop():
    """``_pcg_graph`` (one capture, replayed in chunks) against
    ``_pcg_eager`` (the same masked chunks, eagerly) on the card: the
    same iteration count and the same bits, for two right-hand sides
    through one cached graph, and one host read a replay."""
    _need_card()
    from elemental_tpu_torch.core.multivec import mv_from_global
    from elemental_tpu_torch.optimization import sparse_ipm as si
    rng = np.random.default_rng(1)
    m, n, w = 3000, 1500, 8
    starts = rng.integers(0, n - w, m)
    rows = np.repeat(np.arange(m), w)
    cols = (starts[:, None] + np.arange(w)[None, :]).reshape(-1)
    vals = rng.normal(size=m * w)
    g = et.Grid()
    A = et.dist_sparse_from_coo(cols, rows, vals, n, m, grid=g)
    d2 = mv_from_global(rng.uniform(0.1, 3.0, (m, 1)), grid=g)
    diag = A.with_values(A.vals * A.vals).spmv(d2)
    dinv = diag.with_local(1.0 / (diag.local + 1e-3))
    graphs = {}
    before = dict(si.PCG_COUNTS)
    for seed in (2, 3):
        b = mv_from_global(np.random.default_rng(seed).normal(size=(n, 1)),
                           grid=g)
        wg, itg = si._pcg_graph(A, d2, 1e-3, b, dinv, 1e-10, 2000, graphs)
        we, ite = si._pcg_eager(A, d2, 1e-3, b, dinv, 1e-10, 2000)
        assert int(itg) == int(ite) > si.PCG_CHUNK
        assert torch.equal(wg.local, we.local)
    assert si.PCG_COUNTS["captures"] - before["captures"] == 1
    assert len(graphs) == 1


def test_lp_launches_potrf_inv_once_per_block_and_factorization():
    """``lp`` on the card: (1 + iterations) factorizations of the normal
    matrix, each ceil(m / nb) ``potrf_inv`` launches; bit-equal across
    two calls; the same iterate as on the CPU to 1e-8."""
    _need_card()
    rng = np.random.default_rng(2)
    m, n, nb = 300, 700, 128
    A = rng.normal(size=(m, n))
    basis = rng.choice(n, m, replace=False)
    x0 = np.zeros((n, 1))
    x0[basis, 0] = rng.uniform(0.5, 2.0, m)
    z0 = rng.uniform(0.5, 2.0, (n, 1))
    z0[basis] = 0.0
    b, c = A @ x0, A.T @ rng.normal(size=(m, 1)) + z0
    res = {}
    for dev in ("cuda", "cuda", "cpu"):
        g = et.Grid(device=dev)
        args = [et.from_global(F, et.MC, et.MR, grid=g) for F in (A, b, c)]
        potrf_inv.launches = 0
        x, y, z, info = et.lp(*args, nb=nb)
        assert info["converged"]
        if dev == "cuda":
            assert potrf_inv.launches == (1 + info["iters"]) * -(-m // nb)
            if "cuda" in res:
                assert torch.equal(x.local, res["cuda"])
        res[dev] = x.local
    assert float((res["cuda"].cpu() - res["cpu"]).abs().max()) \
        <= 1e-8 * float(res["cpu"].abs().max())


def test_lp_sparse_cg_engine_on_the_card_matches_the_cpu():
    """``lp_sparse(kkt='cg')`` with the captured CG on the card, three
    Mehrotra iterations: the iterate within 1e-10 of the CPU's (eager
    masked chunks), and bit-equal across two calls on the card."""
    _need_card()
    from elemental_tpu_torch.core.multivec import mv_from_global
    rng = np.random.default_rng(0)
    m, n, nnz = 40, 100, 400
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    import scipy.sparse as sp
    As = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsr()
    b = As @ rng.uniform(0.5, 1.5, n)
    c = As.T @ rng.normal(size=m) + rng.uniform(0.1, 2.0, n)
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        g = et.Grid(device=dev)
        A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=g)
        x, y, z, info = et.lp_sparse(
            A, mv_from_global(b.reshape(-1, 1), grid=g),
            mv_from_global(c.reshape(-1, 1), grid=g),
            et.MehrotraCtrl(tol=1e-6, max_iters=3), kkt="cg")
        out.append(x.local.cpu())
    assert torch.equal(out[0], out[1])
    assert float((out[0] - out[2]).abs().max()) \
        <= 1e-10 * float(out[2].abs().max())


@pytest.mark.parametrize("name", ["cholesky_crossover", "lu_calu", "qr_abft"])
def test_analysis_plan_with_the_kernels_equals_the_cpu_plan(name):
    """A registry driver's ``comm_plan/v1`` with ``panel_impl='kernel'``
    on a CUDA 2x2 grid is byte-equal to the plain panels' on the CPU, and
    the run launched the driver's kernel."""
    _need_card()
    import json
    from elemental_tpu_torch import analysis as an
    kern = {"cholesky": potrf_inv, "lu": lu_panel, "qr": qr_panel}[
        name.split("_")[0]]
    kern.launches = 0
    with an.panel_impl_override("kernel"):
        got = an.golden_doc(an.trace_driver(name, et.Grid(2, 2))[0])
    assert kern.launches > 0
    with an.panel_impl_override("torch"):
        want = an.golden_doc(an.trace_driver(
            name, et.Grid(2, 2, device="cpu"))[0])
    assert json.dumps(got) == json.dumps(want)


def test_analysis_meter_equals_the_allocator_peak():
    """``memory_plan/v1``'s meter on the card: its peak above the inputs
    is the caching allocator's (after a warm-up run)."""
    _need_card()
    from elemental_tpu_torch import analysis as an
    from elemental_tpu_torch.redist import engine
    fn, args, _ = an.build_driver("lu_crossover", et.Grid(2, 2), 1024, 128)
    with engine.isolated_probe(refs=False):
        fn(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with engine.isolated_probe(refs=False):
        stats, _ = an.measure_call(fn, args, (2, 2), "lu_crossover", True,
                                   "cuda")
    alloc = torch.cuda.max_memory_allocated() - base
    assert abs(stats.total_peak_bytes - alloc) <= 0.01 * alloc


def test_analysis_smem_row_is_the_cards():
    """Lint EL007's 'gpu' row equals the kernel's ``lu_panel_smem``."""
    _need_card()
    import importlib
    from elemental_tpu_torch import analysis as an
    lpm = importlib.import_module("elemental_tpu_torch.kernels.lu_panel")
    row = an.SMEM_ROWS["gpu"]
    for dt in (torch.float32, torch.float64):
        k = lpm.smem_constants(dt)
        assert k == {"sm_count": row.sm_count, "smem_optin": row.smem_optin,
                     "static_smem": row.static_smem[str(dt)[6:]]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_harness_panel_kernel_rows_hold_against_plain(dtype):
    """``ab_harness panel`` times the kernel, plain and library rows of
    each primitive, and each kernel's output passes phase 3p (b)'s check
    against its plain version on the same input."""
    _need_card()
    from chip_smoke import lu_panel_check, potrf_check, qr_panel_check
    from elemental_tpu_torch.perf import ab_harness
    bench = ab_harness.Bench("cuda")
    rows = ab_harness.run_panel(bench, 2048, nbs=(128,), dtypes=(dtype,))
    assert sorted((r["prim"], r["impl"]) for r in rows) == sorted(
        (p, i) for p in ab_harness.PANEL_PRIMS
        for i in ("plain", "kernel", "library"))
    assert all(r["seconds"] > 0 for r in rows)
    D = ab_harness.panel_input(bench, "chol", 2048, 128, dtype)
    potrf_check(D, *potrf_inv(D))
    P = ab_harness.panel_input(bench, "lu", 2048, 128, dtype)
    lu_panel_check(P, 128, 64, *lu_panel(P, 128, inner=64), large=False)
    qr_panel_check(P, "2048x128", *qr_panel(P))


@pytest.mark.parametrize("name,argv,kernel", [
    ("cholesky", ["--n", "2048"], "potrf_inv"),
    ("lu", ["--n", "2048"], "lu_panel"),
    ("qr_least_squares", ["--m", "2048", "--n", "512"], "qr_panel")])
def test_example_launches_its_kernel_in_float64(name, argv, kernel, capsys):
    """The float64 example reaches its kernel on the card and meets the
    JAX test's check (its residual keys below 1e-3)."""
    _need_card()
    import runpy
    from elemental_tpu_torch import kernels
    from elemental_tpu_torch.examples._common import parse_reports
    k = getattr(kernels, kernel)
    before = k.launches
    old = sys.argv
    sys.argv = [name] + argv
    try:
        runpy.run_module(f"elemental_tpu_torch.examples.{name}",
                         run_name="__main__")
    finally:
        sys.argv = old
    assert k.launches > before
    (_, rep), = parse_reports(capsys.readouterr().out)
    for key in {"cholesky": ("factor_resid", "solve_resid"),
                "lu": ("factor_resid",),
                "qr_least_squares": ("lstsq_err", "orth")}[name]:
        assert abs(float(rep[key])) < 1e-3, (key, rep)


def test_perf_kernels_and_redist_smokes_exit_zero(capsys):
    _need_card()
    from elemental_tpu_torch.perf import kernels, redist_bench
    assert kernels.main(["smoke"]) == 0
    assert redist_bench.main(["--smoke"]) == 0
    assert "kernels smoke OK" in capsys.readouterr().out


def _device_grid_case(devices, n=1024, dtype=torch.float64):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    G = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    A = G @ G.T / n + n * torch.eye(n, device="cuda", dtype=dtype)
    B = torch.randn(n, 4, generator=gen, device="cuda", dtype=dtype)
    r = 2 if len(devices) % 2 == 0 else 1
    return A, B, et.Grid(r, len(devices) // r, devices=devices)


def _pair(names):
    return et.Dist[names[0]], et.Dist[names[1]]


def test_device_grid_tiles_are_bit_equal_to_the_virtual_grid():
    _need_card()
    A, _, dg = _device_grid_case(["cuda:0"] * 4)
    vg = et.Grid(2, 2)
    for src, dst in DEVICE_GRID_MOVES:
        D = et.redistribute(et.from_global(A, *_pair(src), dg), *_pair(dst))
        V = et.redistribute(et.from_global(A, *_pair(src), vg), *_pair(dst))
        assert same_tiles(D, V), (src, dst)
    P = A[:, :128]
    for D, V in zip(et.panel_spread(et.from_global(P, et.VC, et.STAR, dg)),
                    et.panel_spread(et.from_global(P, et.VC, et.STAR, vg))):
        assert same_tiles(D, V)
    assert same_tiles(et.transpose_dist(et.from_global(A, et.MC, et.MR, dg)),
                      et.transpose_dist(et.from_global(A, et.MC, et.MR, vg)))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_device_grid_hpd_solve_launches_the_kernel_on_every_rank(uplo):
    _need_card()
    A, B, dg = _device_grid_case(["cuda:0"] * 4)
    ref = torch.linalg.solve(A, B)
    counts = []
    for g in (et.Grid(2, 2), dg):
        potrf_inv.launches = 0
        X = et.hpd_solve(et.from_global(A, et.MC, et.MR, g),
                         et.from_global(B, et.MC, et.MR, g), uplo=uplo,
                         nb=128)
        counts.append(potrf_inv.launches)
        x = et.to_global(X)
        assert float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref)) \
            < 1e-10
    assert counts[0] > 0 and counts[1] == 4 * counts[0]


def test_device_grid_puts_ranks_on_distinct_cards():
    _need_card()
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more cards")
    k = min(count, 4)
    devices = [f"cuda:{i}" for i in range(k)]
    A, B, dg = _device_grid_case(devices)
    M = et.from_global(A, et.MC, et.MR, dg)
    assert [t.device for t in M.local] == [torch.device(d) for d in devices]
    vg = et.Grid(dg.height, dg.width)
    for src, dst in DEVICE_GRID_MOVES:
        D = et.redistribute(et.from_global(A, *_pair(src), dg), *_pair(dst))
        assert len({t.device for t in D.local}) == k
        V = et.redistribute(et.from_global(A, *_pair(src), vg), *_pair(dst))
        assert same_tiles(D, V), (src, dst)
    X = et.hpd_solve(M, et.from_global(B, et.MC, et.MR, dg), nb=128)
    ref = torch.linalg.solve(A, B)
    assert float(torch.linalg.norm(et.to_global(X) - ref)
                 / torch.linalg.norm(ref)) < 1e-10


@pytest.mark.parametrize("panel", ["classic", "calu"])
def test_device_grid_lu_solve_launches_the_kernel_on_every_rank(panel):
    _need_card()
    A, B, dg = _device_grid_case(["cuda:0"] * 4)
    ref = torch.linalg.solve(A, B)
    counts, perms = [], []
    for g in (et.Grid(2, 2), dg):
        lu_panel.launches = 0
        Am = et.from_global(A, et.MC, et.MR, g)
        X = et.lu_solve(Am, et.from_global(B, et.MC, et.MR, g), nb=128,
                        panel=panel)
        counts.append(lu_panel.launches)
        perms.append(et.lu(Am, nb=128, panel=panel)[1])
        assert float(torch.linalg.norm(et.to_global(X) - ref)
                     / torch.linalg.norm(ref)) < 1e-10
    assert counts[0] > 0 and counts[1] == 4 * counts[0]
    assert torch.equal(perms[0], perms[1])


def test_device_grid_calu_on_distinct_cards():
    """CALU's sweep graphs captured on every rank's card: the pivots equal
    the virtual grid's, and the factor reproduces A as well as the virtual
    grid's does."""
    _need_card()
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more cards")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    A = torch.randn(1024, 1024, generator=gen, device="cuda")
    dg = et.Grid(2, 2, devices=[f"cuda:{i % count}" for i in range(4)])
    outs = [et.lu(et.from_global(A, et.MC, et.MR, g), nb=128, panel="calu",
                  crossover=0) for g in (et.Grid(2, 2), dg)]
    assert torch.equal(outs[0][1], outs[1][1].to(outs[0][1].device))
    res = []
    for LU, perm in outs:
        lu_, perm = et.to_global(LU), perm.to(A.device)
        L = torch.tril(lu_, -1) + torch.eye(1024, device=lu_.device)
        res.append(float(torch.linalg.norm(A[perm] - L @ torch.triu(lu_))
                         / torch.linalg.norm(A)))
    # f32, n = 1024: ~1.0e-5 for this matrix on the CPU's plain panels
    assert res[1] < 1e-4 and res[1] < 2 * res[0]


def test_device_grid_least_squares_launches_the_kernel_on_every_rank():
    _need_card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    A = torch.randn(1536, 1024, generator=gen, device="cuda",
                    dtype=torch.float64)
    B = torch.randn(1536, 4, generator=gen, device="cuda",
                    dtype=torch.float64)
    ref = torch.linalg.lstsq(A, B).solution
    counts = []
    for g in (et.Grid(2, 2), et.Grid(2, 2, devices=["cuda:0"] * 4)):
        qr_panel.launches = 0
        X = et.least_squares(et.from_global(A, et.MC, et.MR, g),
                             et.from_global(B, et.MC, et.MR, g), nb=128)
        counts.append(qr_panel.launches)
        assert float(torch.linalg.norm(et.to_global(X) - ref)
                     / torch.linalg.norm(ref)) < 1e-10
    assert counts[0] == 1024 // 128 and counts[1] == 4 * counts[0]


def test_device_grid_calu_sweep_graph_gives_each_rank_its_own_pivots():
    """Two ranks on one card replay one captured sweep graph; each gets a
    pivot tensor of its own holding its own sweep's pivots."""
    _need_card()
    import importlib
    tlu = importlib.import_module("elemental_tpu_torch.lapack.lu")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    V1, V2 = (torch.randn(2, 1024, 128, generator=gen, device="cuda")
              for _ in range(2))
    cache = tlu._SweepCache(et.Grid(2, 2, devices=["cuda:0"] * 4))
    caps = tlu.SWEEP_GRAPH_STATS["captures"]
    p1 = tlu._sweep_pivots(V1, 128, cache)
    p2 = tlu._sweep_pivots(V2, 128, cache)
    assert tlu.SWEEP_GRAPH_STATS["captures"] - caps == 1
    assert p1.data_ptr() != p2.data_ptr()

    def eager(V):
        B, Mp, _ = V.shape
        piv = torch.empty((128, B), dtype=torch.int64, device="cuda")
        rows = (torch.arange(B, device="cuda")[None, :] * Mp
                + torch.arange(128, device="cuda")[:, None])
        tlu._sweep(V.clone(), piv, rows)
        return piv
    assert torch.equal(p1, eager(V1)) and torch.equal(p2, eager(V2))
