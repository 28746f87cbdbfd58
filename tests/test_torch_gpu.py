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
'abft' (n = 4096, as ``chip_smoke.py`` phase 3j does at full width)."""
import sys

import numpy as np
import pytest
import torch

import elemental_tpu_torch as et
from elemental_tpu_torch.kernels import (lu_panel, lu_panel_reference,
                                         potrf_inv, potrf_inv_reference,
                                         qr_panel, qr_panel_reference)
from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_v
from chip_smoke import eig_gates, qr_residuals

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
    (700, 200, 48, torch.float64)],
    ids=["float32", "float32-in-place", "float64"])
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
