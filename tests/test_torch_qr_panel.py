"""The port's ``qr_panel`` (plain version, as run for CPU tensors) and its
plain functions ``_panel_qr`` / ``_larft`` / ``_panel_v`` against the JAX
package's (``elemental_tpu.lapack.qr``) and against its Pallas
``qr_panel`` in interpret mode.

Contract of ``tests/kernels/test_qr_panel.py``: the QR residual
``||F - Q R|| / ||F||`` and ``||Q^T Q - I|| / sqrt(m)`` below 3e-6
(float32) and 1e-12 (float64); T equal to ``_larft(_panel_v(packed),
tau)`` to atol 1e-5 (float32) / 1e-12 (float64); a zero column gives
tau = 0 exactly.  Against the JAX XLA twin the packed panel, tau and T
agree to 1e-12 (float64) / 1e-5 (float32) of their largest entry: the
same recurrence, with the sums rounded by different libraries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elemental_tpu.kernels import qr_panel as jax_qr_panel
from elemental_tpu.lapack.qr import _larft as jax_larft
from elemental_tpu.lapack.qr import _panel_qr as jax_panel_qr
from elemental_tpu.lapack.qr import _panel_v as jax_panel_v
from elemental_tpu_torch.kernels import qr_panel, qr_panel_reference
from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_qr, _panel_v

RES_TOL = {np.float32: 3e-6, np.float64: 1e-12}
T_TOL = {np.float32: 1e-5, np.float64: 1e-12}
#: agreement with the JAX twin, relative to the largest entry
TWIN_TOL = {np.float32: 1e-5, np.float64: 1e-12}
SHAPES = [(64, 16), (40, 8), (33, 7)]
DTYPES = [np.float32, np.float64]


def _panel(shape, dtype, seed=None):
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    return rng.normal(size=shape).astype(dtype)


def _recon(pg, tg, m, k):
    """Q from the reflectors one by one, and R (the JAX test's oracle)."""
    Q = np.eye(m, dtype=np.result_type(pg, np.float64))
    for j in range(k):
        v = np.zeros(m, dtype=Q.dtype)
        v[j] = 1.0
        v[j + 1:] = pg[j + 1:, j]
        Q = Q @ (np.eye(m) - tg[j] * np.outer(v, v.conj()))
    return Q, np.triu(pg[:k, :])


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_qr_panel_contract_and_twins(shape, dtype):
    m, k = shape
    F = _panel(shape, dtype)
    packed, tau, T = (x.numpy() for x in qr_panel(torch.from_numpy(F)))
    Q, R = _recon(packed, tau, m, k)
    assert np.linalg.norm(Q[:, :k] @ R - F) / np.linalg.norm(F) < RES_TOL[dtype]
    assert np.linalg.norm(Q.T @ Q - np.eye(m)) / np.sqrt(m) < RES_TOL[dtype]
    V = np.tril(packed, -1) + np.eye(m, k)
    Texp = np.asarray(jax_larft(jnp.asarray(V.astype(dtype)),
                                jnp.asarray(tau)))
    np.testing.assert_allclose(T, Texp, rtol=0, atol=T_TOL[dtype])
    # the XLA twin and the Pallas body (interpret mode)
    jpacked, jtau = jax_panel_qr(jnp.asarray(F))
    jT = jax_larft(jax_panel_v(jpacked), jtau)
    for got, want in ((packed, jpacked), (tau, jtau), (T, jT)):
        _close(got, np.asarray(want), TWIN_TOL[dtype])
    ppacked, ptau, pT = jax_qr_panel(jnp.asarray(F), interpret=True)
    for got, want in ((packed, ppacked), (tau, ptau), (T, pT)):
        _close(got, np.asarray(want), TWIN_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_panel_qr_and_larft_match_jax(dtype):
    F = _panel((50, 20), dtype, seed=1)
    packed, tau = _panel_qr(torch.from_numpy(F))
    jpacked, jtau = jax_panel_qr(jnp.asarray(F))
    _close(packed.numpy(), np.asarray(jpacked), TWIN_TOL[dtype])
    _close(tau.numpy(), np.asarray(jtau), TWIN_TOL[dtype])
    V = _panel_v(packed)
    np.testing.assert_array_equal(
        V.numpy(), np.asarray(jax_panel_v(jnp.asarray(packed.numpy()))))
    T = _larft(V, tau)
    jT = jax_larft(jnp.asarray(V.numpy()), jnp.asarray(tau.numpy()))
    _close(T.numpy(), np.asarray(jT), TWIN_TOL[dtype])
    assert torch.equal(torch.tril(T, -1), torch.zeros_like(T))


def test_graded_columns():
    """Columns scaled over 10 decades: the larfg guards hold."""
    m, k = 64, 16
    rng = np.random.default_rng(5)
    F = (rng.normal(size=(m, k)) * np.logspace(0, -10, k)[None, :])
    packed, tau, T = (x.numpy() for x in qr_panel(torch.from_numpy(F)))
    Q, R = _recon(packed, tau, m, k)
    assert np.linalg.norm(Q[:, :k] @ R - F) / np.linalg.norm(F) < RES_TOL[np.float64]
    jpacked, jtau = jax_panel_qr(jnp.asarray(F))
    _close(packed, np.asarray(jpacked), TWIN_TOL[np.float64])
    _close(tau, np.asarray(jtau), TWIN_TOL[np.float64])


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
def test_zero_column_degenerate(dtype):
    """An exactly-zero column: tau = 0 and beta = 0, as the reference's
    guard gives them; the other columns keep the contract."""
    m, k = 32, 8
    F = _panel((m, k), dtype, seed=6)
    F[:, 3] = 0.0
    packed, tau, T = (x.numpy() for x in qr_panel(torch.from_numpy(F)))
    jpacked, jtau = jax_panel_qr(jnp.asarray(F))
    assert tau[3] == np.asarray(jtau)[3] == 0.0
    assert packed[3, 3] == 0.0 and np.all(packed[4:, 3] == 0.0)
    _close(packed, np.asarray(jpacked), TWIN_TOL[dtype])
    Q, R = _recon(packed, tau, m, k)
    assert np.linalg.norm(Q[:, :k] @ R - F) / np.linalg.norm(F) < RES_TOL[dtype]


def test_complex128_plain_version_matches_jax():
    rng = np.random.default_rng(7)
    F = rng.normal(size=(30, 12)) + 1j * rng.normal(size=(30, 12))
    packed, tau = _panel_qr(torch.from_numpy(F))
    jpacked, jtau = jax_panel_qr(jnp.asarray(F))
    _close(packed.numpy(), np.asarray(jpacked), 1e-12)
    _close(tau.numpy(), np.asarray(jtau), 1e-12)
    T = _larft(_panel_v(packed), tau)
    jT = jax_larft(jax_panel_v(jpacked), jtau)
    _close(T.numpy(), np.asarray(jT), 1e-12)
    Q, R = _recon(packed.numpy(), tau.numpy(), 30, 12)
    assert np.linalg.norm(Q[:, :12] @ R - F) / np.linalg.norm(F) < 1e-13
    # a purely imaginary alpha takes the real-part-zero branch (beta < 0)
    G = F.copy()
    G[0, 0] = 2j
    p2, _ = _panel_qr(torch.from_numpy(G))
    assert p2[0, 0].real < 0 and p2[0, 0].imag == 0


def test_wrapper_refuses_complex_and_short_panels():
    with pytest.raises(ValueError, match="real-only"):
        qr_panel(torch.ones(16, 4, dtype=torch.complex128))
    with pytest.raises(ValueError, match="M >= k"):
        qr_panel(torch.ones(3, 4))
    with pytest.raises(ValueError, match="M >= k"):
        qr_panel(torch.ones(8))


def test_cpu_tensor_runs_the_plain_version_and_counts_no_launch():
    F = torch.from_numpy(_panel((24, 8), np.float64))
    before, keep = qr_panel.launches, F.clone()
    got = qr_panel(F)
    want = qr_panel_reference(F)
    assert qr_panel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(F, keep)                    # the input is untouched


def test_strided_view_gives_the_contiguous_result():
    big = torch.from_numpy(_panel((40, 20), np.float64, seed=8))
    a = qr_panel(big[4:, 3:11])
    b = qr_panel(big[4:, 3:11].contiguous())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _tcc(G, t):
    """larft's forward recurrence on a chunk's gram G = V_c^T V_c."""
    n = t.shape[0]
    Tc = torch.diag(t)
    for i in range(1, n):
        Tc[:i, i] = -t[i] * (Tc[:i, :i] @ G[:i, i])
    return Tc


def _two_level_qr(F, cw, ob):
    """The CUDA kernel's algebra (``csrc/qr_panel.cu``), in float64 torch:
    cw-column inner chunks factored by the column recurrence, each inner
    block reflector applied to the rest of its ob-column outer block only,
    then each outer block's reflector to the rest of the panel.  T is
    assembled per outer block from the inner T_cc recurrences and the
    grams Z = V_c^T P[:, so:eo] and Z_o = V_o^T P the products already
    hold."""
    P = F.clone()
    M, k = P.shape
    tau = torch.zeros(k, dtype=P.dtype)
    T = torch.zeros(k, k, dtype=P.dtype)
    for so in range(0, k, ob):
        eo = min(so + ob, k)
        for s in range(so, eo, cw):
            e = min(s + cw, eo)
            P[s:, s:e], tau[s:e] = _panel_qr(P[s:, s:e])
            Vc = _panel_v(P[s:, s:e])
            Z = Vc.T @ torch.cat([P[s:, so:s], Vc, P[s:, e:eo]], dim=1)
            Tcc = _tcc(Z[:, s - so:e - so], tau[s:e])
            T[s:e, s:e] = Tcc
            Y = Tcc.T @ Z
            T[so:s, s:e] = -T[so:s, so:s] @ Y[:, :s - so].T
            P[s:, e:eo] -= Vc @ Y[:, e - so:]
        Vo = _panel_v(P[so:, so:eo])
        Yo = T[so:eo, so:eo].T @ (Vo.T @ torch.cat([P[so:, :so], P[so:, eo:]],
                                                  dim=1))
        T[:so, so:eo] = -T[:so, :so] @ Yo[:, :so].T
        P[so:, eo:] -= Vo @ Yo[:, so:]
    return P, tau, T


@pytest.mark.parametrize("shape,cw,ob", [((40, 20), 4, 8), ((33, 7), 4, 8),
                                         ((64, 17), 4, 16), ((24, 24), 8, 16)],
                         ids=["k-not-multiple", "one-outer-block",
                              "ragged-inner", "square"])
def test_two_level_blocking_matches_plain_and_jax(shape, cw, ob):
    """The kernel's two-level blocking gives the plain version's packed
    panel and tau, and its T (assembled per outer block from the inner
    T_cc blocks and the grams) equals ``_larft`` of the port and of the
    JAX package, to 1e-12 of the largest entry (float64; the same
    recurrence through other blockings)."""
    F = torch.from_numpy(_panel(shape, np.float64))
    P, tau, T = _two_level_qr(F, cw, ob)
    packed, ptau = _panel_qr(F)
    _close(P.numpy(), packed.numpy(), 1e-12)
    _close(tau.numpy(), ptau.numpy(), 1e-12)
    V = _panel_v(P)
    _close(T.numpy(), _larft(V, tau).numpy(), 1e-12)
    _close(T.numpy(), np.asarray(jax_larft(jnp.asarray(V.numpy()),
                                           jnp.asarray(tau.numpy()))), 1e-12)
    assert torch.equal(torch.tril(T, -1), torch.zeros_like(T))
