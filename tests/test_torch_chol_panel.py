"""The port's ``potrf_inv`` (plain version, as run for CPU tensors) against
the JAX package's ``_potrf_inv_impl`` and its Pallas kernel run in
interpret mode, and the ``panel_impl`` dispatch.

Bounds are those of ``tests/kernels/test_chol_panel.py``:
``||L L^T - D|| / ||D||`` and ``||Li L - I|| / sqrt(w)`` below 3e-6 at
float32 and 1e-12 at float64, on the same (w, bs) ladder.  Elementwise,
the two plain versions run the same blocked algorithm through different
LAPACK calls, so they agree to rtol 1e-10 at float64.  The models of the
CUDA kernel's schedules (float32's and float64's) are held to the same
rtol against both plain versions; their JAX reference runs under
``jax.jit`` once per block (eagerly, ``bs = 7`` at w = 300 compiles each
of its ~200 single ops alone)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elemental_tpu.kernels import potrf_inv as jax_pallas_potrf_inv
from elemental_tpu.lapack.cholesky import _potrf_inv_impl as jax_potrf_inv_impl
from elemental_tpu_torch.kernels import (PANEL_IMPLS, PanelPlan,
                                         potrf_inv, potrf_inv_reference,
                                         resolve_panel)

F32_TOL = 3e-6
F64_TOL = 1e-12
LADDER = [(48, 16), (96, 32), (16, 512), (128, 64)]


def _spd(w, dtype, graded=False, seed=0):
    rng = np.random.default_rng(seed + w)
    G = rng.normal(size=(w, w)).astype(dtype)
    D = G @ G.T / w + w * np.eye(w, dtype=dtype)
    if graded:
        s = np.logspace(0, -12, w).astype(dtype)
        D = (D * s[:, None]) * s[None, :]
    return D.astype(dtype)


def _residuals(L, Li, D):
    w = D.shape[0]
    return (np.linalg.norm(L @ L.conj().T - D) / np.linalg.norm(D),
            np.linalg.norm(Li @ L - np.eye(w)) / np.sqrt(w))


@pytest.mark.parametrize("w,bs", LADDER)
@pytest.mark.parametrize("dtype,tol", [(np.float32, F32_TOL),
                                       (np.float64, F64_TOL)])
def test_residual_random_spd_against_jax(w, bs, dtype, tol):
    D = _spd(w, dtype)
    L, Li = potrf_inv(torch.from_numpy(D), bs=bs)
    L, Li = L.numpy(), Li.numpy()
    assert max(_residuals(L, Li, D)) < tol
    for jL, jLi in (jax_potrf_inv_impl(jnp.asarray(D), None, bs=bs),
                    jax_pallas_potrf_inv(jnp.asarray(D), bs=bs,
                                         interpret=True)):
        jL, jLi = np.asarray(jL), np.asarray(jLi)
        assert max(_residuals(jL, jLi, D)) < tol
        scale = np.abs(jL).max()
        np.testing.assert_allclose(L, jL, rtol=0, atol=30 * tol * scale)


@pytest.mark.parametrize("w,bs", [(64, 16), (96, 512)])
def test_residual_graded_spd(w, bs):
    D = _spd(w, np.float64, graded=True)
    L, _ = potrf_inv(torch.from_numpy(D), bs=bs)
    jL, _ = jax_potrf_inv_impl(jnp.asarray(D), None, bs=bs)
    L, jL = L.numpy(), np.asarray(jL)
    res = np.linalg.norm(L @ L.T - D) / np.linalg.norm(D)
    res_ref = np.linalg.norm(jL @ jL.T - D) / np.linalg.norm(D)
    assert res < max(10 * res_ref, F64_TOL)


@pytest.mark.parametrize("w,bs", LADDER)
def test_matches_jax_twin_elementwise_f64(w, bs):
    D = _spd(w, np.float64)
    L, Li = potrf_inv_reference(torch.from_numpy(D), bs=bs)
    jL, jLi = jax_potrf_inv_impl(jnp.asarray(D), None, bs=bs)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jL)).max())
    np.testing.assert_allclose(Li.numpy(), np.asarray(jLi), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jLi)).max())


def test_complex_plain_version_matches_jax():
    rng = np.random.default_rng(3)
    w = 40
    G = rng.normal(size=(w, w)) + 1j * rng.normal(size=(w, w))
    D = G @ G.conj().T / w + w * np.eye(w)
    L, Li = potrf_inv(torch.from_numpy(D), bs=16)
    jL, jLi = jax_potrf_inv_impl(jnp.asarray(D), None, bs=16)
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-10,
                               atol=1e-12)
    assert max(_residuals(L.numpy(), Li.numpy(), D)) < F64_TOL


def test_reads_only_lower_triangle():
    D = _spd(48, np.float64)
    junk = D + np.triu(np.random.default_rng(9).normal(size=D.shape), 1)
    L1, Li1 = potrf_inv(torch.from_numpy(D), bs=16)
    L2, Li2 = potrf_inv(torch.from_numpy(junk), bs=16)
    assert torch.equal(L1, L2) and torch.equal(Li1, Li2)


def test_non_positive_definite_block_gives_nans():
    D = -np.eye(8)
    L, _ = potrf_inv(torch.from_numpy(D), bs=4)
    assert torch.isnan(L).any()


def test_cpu_tensor_never_counts_a_launch():
    before = potrf_inv.launches
    potrf_inv(torch.from_numpy(_spd(16, np.float64)))
    assert potrf_inv.launches == before


def test_resolve_panel():
    f32, c64 = torch.float32, torch.complex64
    assert resolve_panel(None, dtype=f32, device="cpu").impl == "torch"
    assert resolve_panel("auto", dtype=f32, device="cpu").impl == "torch"
    card = resolve_panel(None, dtype=f32, device="cuda:0")
    assert (card.impl, card.source) == ("kernel", "default")
    assert resolve_panel("auto", dtype=f32, device="cuda").impl == "kernel"
    assert resolve_panel("torch", dtype=f32, device="cuda").impl == "torch"
    for knob in (None, "kernel"):
        cplx = resolve_panel(knob, dtype=c64, device="cuda")
        assert (cplx.impl, cplx.source) == ("torch", "complex-torch")
    assert resolve_panel("kernel", dtype=f32).source == "explicit"
    with pytest.raises(ValueError, match="panel_impl"):
        resolve_panel("pallas", dtype=f32)
    assert PANEL_IMPLS == ("torch", "kernel")


def test_size_gate_passes_the_main_path_block():
    # w = 2048 float32 (nb = 2048 on the 1x1 main path) must reach the
    # kernel, and so must any larger block: the gate is on dtype alone
    plan = PanelPlan(impl="kernel")
    assert plan.use_kernel(torch.float32) and plan.use_kernel(torch.float64)
    assert not plan.use_kernel(torch.complex64)
    assert not plan.use_kernel(torch.complex128)
    assert not PanelPlan(impl="torch").use_kernel(torch.float32)


def _lapack_base(blk):
    """A sub-block's Cholesky factor and inverse (``warp_base``'s
    function, through LAPACK)."""
    Lcc = torch.linalg.cholesky(blk + torch.tril(blk, -1).T)
    return Lcc, torch.linalg.solve_triangular(
        Lcc, torch.eye(blk.shape[0], dtype=blk.dtype), upper=False)


def _rsqrt_base(blk):
    """``warp_base16``'s column recurrence (the float64 route's base): the
    factor and its inverse by elimination on ``[blk | I]``.  Column j is
    scaled by the reciprocal square root r of its pivot p (diagonal p r),
    the rows below it are eliminated from the trailing lower triangle and,
    with L[i][j] r, from the inverse's rows, which stay unscaled until
    each is scaled by its own r at the end."""
    b = blk.shape[0]
    S = torch.tril(blk).clone()
    X = torch.eye(b, dtype=blk.dtype)
    rr = torch.ones(b, dtype=blk.dtype)
    for j in range(b):
        r = 1 / torch.sqrt(S[j, j])
        lj = S[j + 1:, j] * r
        S[j, j] = S[j, j] * r
        S[j + 1:, j] = lj
        rr[j] = r
        S[j + 1:, j + 1:] -= torch.tril(lj[:, None] * lj[None, :])
        X[j + 1:, :j + 1] -= (lj * r)[:, None] * X[j, :j + 1][None, :]
    return S, X * rr[:, None]


def _two_level_potrf_inv(D, nb, b, base=_lapack_base):
    """The CUDA kernel's algebra (``csrc/potrf_inv.cu``), in float64 torch:
    nb-column diagonal blocks, each factored and inverted in b-column
    sub-blocks (a sub-block's Cholesky and inverse by ``base``, the rows
    below it times that inverse, the block's trailing lower triangle; then
    the inverse's off-diagonal block rows left-looking); then the
    right-looking outer step: the panel W Lkk^{-T}, the inverse rows
    Lkk^{-1} R, the trailing lower triangle and R.  W lives in L's lower
    triangle and R in Li, as in the kernel."""
    w = D.shape[0]
    L = torch.tril(D).clone()
    Li = torch.zeros_like(D)
    for b0 in range(0, w, nb):
        b1 = min(b0 + nb, w)
        n = b1 - b0
        S = torch.tril(L[b0:b1, b0:b1]).clone()
        X = torch.zeros_like(S)
        for c0 in range(0, n, b):
            c1 = min(c0 + b, n)
            Lcc, Xcc = base(torch.tril(S[c0:c1, c0:c1]))
            S[c0:c1, c0:c1] = Lcc
            X[c0:c1, c0:c1] = Xcc
            S[c1:, c0:c1] = S[c1:, c0:c1] @ Xcc.T
            S[c1:, c1:] -= torch.tril(S[c1:, c0:c1] @ S[c1:, c0:c1].T)
        for c0 in range(b, n, b):
            c1 = min(c0 + b, n)
            X[c0:c1, :c0] = -X[c0:c1, c0:c1] @ (S[c0:c1, :c0] @ X[:c0, :c0])
        L[b0:b1, b0:b1] = S
        Li[b0:b1, b0:b1] = X
        L[b1:, b0:b1] = L[b1:, b0:b1] @ X.T
        Li[b0:b1, :b0] = X @ Li[b0:b1, :b0]
        L[b1:, b1:] -= torch.tril(L[b1:, b0:b1] @ L[b1:, b0:b1].T)
        Li[b1:, :b1] -= L[b1:, b0:b1] @ Li[b0:b1, :b1]
    return L, Li


def _f64_route_potrf_inv(D, bs):
    """The float64 route's schedule: the same outer step over 64-column
    diagonal blocks (``Blk<double>::NB``), each factored in sub-blocks of
    at most 16 columns (four on the main path, ``NB64_BASE`` in the
    source) by ``warp_base16``'s recurrence; its products run on the FP64
    tensor cores, which this model cannot show (they round as FMA
    does)."""
    return _two_level_potrf_inv(D, 64, min(bs, 16), base=_rsqrt_base)


@functools.lru_cache(maxsize=None)
def _jax_reference(w, bs):
    """JAX's ``_potrf_inv_impl`` of ``_spd(w, float64)`` at ``bs``, as
    numpy arrays, traced and compiled once."""
    fn = jax.jit(jax_potrf_inv_impl, static_argnums=1, static_argnames="bs")
    jL, jLi = fn(jnp.asarray(_spd(w, np.float64)), None, bs=bs)
    return np.asarray(jL), np.asarray(jLi)


def _check_schedule_model(L, Li, D, b):
    """The model's (L, L^-1) of D against both plain versions at bs = b:
    residuals within F64_TOL, elementwise rtol 1e-10, zero above the
    diagonal."""
    Lp, Lip = potrf_inv_reference(torch.from_numpy(D), bs=b)
    jL, jLi = _jax_reference(D.shape[0], b)
    assert max(_residuals(L.numpy(), Li.numpy(), D)) < F64_TOL
    for got, want in ((L, Lp.numpy()), (Li, Lip.numpy()),
                      (L, jL), (Li, jLi)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))


@pytest.mark.parametrize("w,nb,b", [(1, 32, 32), (31, 32, 32), (33, 32, 32),
                                    (100, 32, 32), (129, 32, 32),
                                    (300, 32, 7)])
def test_two_level_blocking_matches_plain_and_jax(w, nb, b):
    """The kernel's blocked factor and right-looking inverse assembly
    (32-column diagonal blocks, as in the kernel) agree with the plain
    version and with JAX's ``_potrf_inv_impl`` to rtol 1e-10 (float64;
    the same function through other blockings) at the edges of its
    blocks: w below, at and past one block, blocks that do not divide w,
    and a sub-block cap that does not divide the block."""
    D = _spd(w, np.float64)
    L, Li = _two_level_potrf_inv(torch.from_numpy(D), nb, b)
    _check_schedule_model(L, Li, D, b)


@pytest.mark.parametrize("w,b", [(1, 32), (31, 32), (33, 32), (65, 32),
                                 (100, 32), (129, 32), (300, 7)])
def test_f64_route_blocking_matches_plain_and_jax(w, b):
    """The float64 route's schedule (``_f64_route_potrf_inv``: 64-column
    diagonal blocks in 16-column sub-blocks, the rsqrt recurrence of
    ``warp_base16``) agrees with the plain version and with JAX's
    ``_potrf_inv_impl`` to rtol 1e-10 at the float32 schedule's edges and
    its own: w below, at and past a sub-block and a block, blocks that do
    not divide w, and a cap that divides neither the block nor its
    sub-blocks."""
    D = _spd(w, np.float64)
    L, Li = _f64_route_potrf_inv(torch.from_numpy(D), b)
    _check_schedule_model(L, Li, D, b)


@pytest.mark.parametrize("b", [1, 5, 16, 32])
def test_rsqrt_base_is_the_factor_and_its_inverse(b):
    """``warp_base16``'s recurrence on one sub-block gives LAPACK's
    Cholesky factor and its inverse to rtol 1e-12 (float64)."""
    blk = torch.from_numpy(np.tril(_spd(b, np.float64)))
    S, X = _rsqrt_base(blk)
    Lref, Xref = _lapack_base(blk)
    for got, want in ((S, Lref), (X, Xref)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * want.abs().max().item())
