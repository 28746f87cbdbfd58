"""TSQR: the tree panel of ``qr(panel='tsqr')`` and the standalone
``tsqr`` of a [VC,STAR] matrix, against the JAX package (mirroring
``tests/lapack/test_qr_tsqr.py``).

The slab QRs, the R playoffs, the Householder reconstruction through
LU's unpivoted panel and the whole blocked ``qr`` give ``(packed, tau)``
equal to the JAX package's to 1e-12 (float64; the JAX references run on
1x1 and 2x2 grids, where no collective can time out).  The port alone
then covers the 2x4 and 4x1 grids against numpy: A = Q R, orthogonality,
``apply_q`` round trips and least squares through both panels."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.redist.interior import interior_view as j_interior_view

jqr = importlib.import_module("elemental_tpu.lapack.qr")
jlu = importlib.import_module("elemental_tpu.lapack.lu")
tqr = importlib.import_module("elemental_tpu_torch.lapack.qr")
tlu = importlib.import_module("elemental_tpu_torch.lapack.lu")

GRIDS = [(1, 1), (2, 2), (2, 4), (4, 1)]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _whole(fn, *args):
    """A JAX reference compiled as one program.  Run eagerly, each op of
    the blocked loops compiles on its own, which took most of this file's
    time on the CPU; the compiled program gives the same numbers."""
    return jax.jit(fn)(*args)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(24, 8), (19, 13), (30, 6)])
def test_tree_and_panel_match_jax(r, shape):
    P = np.random.default_rng(70 + r).normal(size=shape)
    jQ1, jR = _whole(lambda p: jqr._tsqr_tree(p, r), jnp.asarray(P))
    tQ1, tR = tqr._tsqr_tree(torch.as_tensor(P), r)
    _close(tQ1.numpy(), jQ1)
    _close(tR.numpy(), jR)
    jpk, jtau = _whole(lambda p: jqr._panel_qr_tsqr(p, r), jnp.asarray(P))
    tpk, ttau = tqr._panel_qr_tsqr(torch.as_tensor(P), r)
    _close(tpk.numpy(), jpk)
    _close(ttau.numpy(), jtau)


def test_complex_panel_matches_jax():
    rng = np.random.default_rng(73)
    P = rng.normal(size=(20, 6)) + 1j * rng.normal(size=(20, 6))
    jpk, jtau = _whole(lambda p: jqr._panel_qr_tsqr(p, 2), jnp.asarray(P))
    tpk, ttau = tqr._panel_qr_tsqr(torch.as_tensor(P), 2)
    _close(tpk.numpy(), jpk)
    _close(ttau.numpy(), jtau)


@pytest.mark.parametrize("n", [16, 40, 300])
def test_reconstruction_lu_matches_jax(n):
    """LU's ``_lu_nopiv`` (blocked past 256), ``_upper_inv`` and
    ``_nopiv_panel``, which the Householder reconstruction runs."""
    rng = np.random.default_rng(n)
    W = rng.normal(size=(n + 9, n)) + np.vstack([n * np.eye(n),
                                                 np.zeros((9, n))])
    _close(tlu._lu_nopiv(torch.as_tensor(W[:n])).numpy(),
           _whole(jlu._lu_nopiv, jnp.asarray(W[:n])))
    U = np.triu(W[:n])
    _close(tlu._upper_inv(torch.as_tensor(U), n).numpy(),
           _whole(lambda u: jlu._upper_inv(u, n), jnp.asarray(U)))
    _close(tlu._nopiv_panel(torch.as_tensor(W), n).numpy(),
           _whole(lambda w: jlu._nopiv_panel(w, n), jnp.asarray(W)))


@pytest.mark.parametrize("rc", [(1, 1), (2, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("shape,nb", [((24, 16), 8), ((32, 32), 8),
                                      ((19, 13), 4)])
def test_blocked_tsqr_matches_jax(rc, shape, nb):
    F = np.random.default_rng(71).normal(size=shape)
    jAp, jtau = _whole(lambda a: jqr.qr(a, nb=nb, panel="tsqr"),
                       el.from_global(F, el.MC, el.MR, jgrid(*rc)))
    tAp, ttau = et.qr(et.from_global(F, et.MC, et.MR, tgrid(*rc)), nb=nb,
                      panel="tsqr")
    _close(et.storage_numpy(tAp), jAp.local)
    _close(ttau.numpy(), jtau)
    assert tAp._qr_nb == nb


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("shape", [(24, 16), (32, 32), (19, 13), (30, 18)])
def test_tsqr_residual_orthogonality(rc, shape):
    m, n = shape
    F = np.random.default_rng(71).normal(size=shape)
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, tgrid(*rc)), nb=8,
                    panel="tsqr")
    Q = et.to_global(et.explicit_q(Ap, tau)).numpy()
    k = min(m, n)
    R = np.triu(et.to_global(Ap).numpy())[:k, :]
    assert np.linalg.norm(Q.T @ Q - np.eye(m)) < 1e-12
    assert np.linalg.norm(Q[:, :k] @ R - F) < 1e-12 * np.linalg.norm(F)


def test_tsqr_R_matches_numpy_abs_on_4x2():
    F = np.random.default_rng(72).normal(size=(28, 12))
    Ap, _ = et.qr(et.from_global(F, et.MC, et.MR, tgrid(4, 2)), nb=4,
                  panel="tsqr")
    R = np.triu(et.to_global(Ap).numpy())[:12, :]
    np.testing.assert_allclose(np.abs(R), np.abs(np.linalg.qr(F, mode="r")),
                               atol=1e-11)


def test_tsqr_complex():
    rng = np.random.default_rng(73)
    F = rng.normal(size=(20, 12)) + 1j * rng.normal(size=(20, 12))
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, tgrid(2, 4)), nb=4,
                    panel="tsqr")
    Q = et.to_global(et.explicit_q(Ap, tau)).numpy()
    R = np.triu(et.to_global(Ap).numpy())[:12, :]
    assert np.linalg.norm(Q.conj().T @ Q - np.eye(20)) < 1e-11
    assert np.linalg.norm(Q[:, :12] @ R - F) < 1e-11 * np.linalg.norm(F)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_tsqr_apply_q_roundtrip_records_nb(rc):
    rng = np.random.default_rng(74)
    F = rng.normal(size=(24, 16))
    g = tgrid(*rc)
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, g), nb=8, panel="tsqr")
    assert getattr(Ap, "_qr_nb", None) == 8
    B = rng.normal(size=(24, 3))
    Bd = et.from_global(B, et.MC, et.MR, g)
    out = et.apply_q(Ap, tau, et.apply_q(Ap, tau, Bd, orient="C"))
    np.testing.assert_allclose(et.to_global(out).numpy(), B, atol=1e-12)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("panel", ["classic", "tsqr"])
def test_least_squares_through_both_panels(rc, panel):
    """A tall least-squares solve through either panel: Q^H B from the
    packed reflectors, then the triangular solve against R."""
    rng = np.random.default_rng(76)
    F, B = rng.normal(size=(30, 10)), rng.normal(size=(30, 2))
    X_np, *_ = np.linalg.lstsq(F, B, rcond=None)
    g = tgrid(*rc)
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, g), nb=4, panel=panel)
    Y = et.apply_q(Ap, tau, et.from_global(B, et.MC, et.MR, g), orient="C")
    R = et.make_trapezoidal(et.interior_view(Ap, (0, 10), (0, 10)), "U")
    X = et.trsm("L", "U", "N", R, et.interior_view(Y, (0, 10), (0, 2)),
                nb=4)
    np.testing.assert_allclose(et.to_global(X).numpy(), X_np, atol=1e-10)
    if panel == "classic":
        X2 = et.least_squares(et.from_global(F, et.MC, et.MR, g),
                              et.from_global(B, et.MC, et.MR, g), nb=4)
        np.testing.assert_allclose(et.to_global(X2).numpy(), X_np,
                                   atol=1e-10)


def test_tsqr_least_squares_matches_jax_on_2x2():
    rng = np.random.default_rng(76)
    F, B = rng.normal(size=(30, 10)), rng.normal(size=(30, 2))
    jg, tg = jgrid(2, 2), tgrid(2, 2)

    def ref(a, b):
        jAp, jtau = jqr.qr(a, nb=4, panel="tsqr")
        return jqr.apply_q(jAp, jtau, b, orient="C")
    jY = _whole(ref, el.from_global(F, el.MC, el.MR, jg),
                el.from_global(B, el.MC, el.MR, jg))
    tAp, ttau = et.qr(et.from_global(F, et.MC, et.MR, tg), nb=4, panel="tsqr")
    tY = et.apply_q(tAp, ttau, et.from_global(B, et.MC, et.MR, tg),
                    orient="C")
    _close(et.storage_numpy(tY), jY.local)
    _close(et.storage_numpy(et.interior_view(tY, (0, 10), (0, 2))),
           j_interior_view(jY, (0, 10), (0, 2)).local)


def test_tsqr_rejects_unknown_panel():
    A = et.from_global(np.ones((16, 8)), et.MC, et.MR, tgrid(2, 2))
    with pytest.raises(ValueError, match="panel"):
        et.qr(A, nb=8, panel="caqr2")


def test_tree_panel_never_reaches_the_panel_kernel(monkeypatch):
    """``panel='tsqr'`` on a 1x1 grid runs the tree with one slab (as the
    JAX package does), not the classic panel or its kernel."""
    calls = []
    monkeypatch.setattr(tqr, "_panel_qr_dispatch",
                        lambda *a, **k: calls.append(1))
    F = np.random.default_rng(1).normal(size=(24, 16))
    Ap, tau = et.qr(et.from_global(F, et.MC, et.MR, tgrid(1, 1)), nb=8,
                    panel="tsqr")
    assert calls == []
    jAp, jtau = jqr.qr(el.from_global(F, el.MC, el.MR, jgrid(1, 1)), nb=8,
                       panel="tsqr")
    _close(et.storage_numpy(Ap), jAp.local)


# ---------------------------------------------------------------------
# standalone tsqr of a [VC,STAR] matrix
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", [(1, 1), (2, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("shape", [(40, 6), (23, 5), (9, 4)])
def test_standalone_tsqr_matches_jax(rc, shape):
    F = np.random.default_rng(80).normal(size=shape)
    jQ, jR = _whole(jqr.tsqr, el.from_global(F, el.VC, el.STAR, jgrid(*rc)))
    tQ, tR = et.tsqr(et.from_global(F, et.VC, et.STAR, tgrid(*rc)))
    assert tQ.dist == (et.VC, et.STAR) and tR.dist == (et.STAR, et.STAR)
    _close(et.storage_numpy(tQ), jQ.local)
    _close(et.storage_numpy(tR), jR.local)


@pytest.mark.parametrize("rc", GRIDS + [(3, 2)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_standalone_tsqr_factors(rc):
    F = np.random.default_rng(81).normal(size=(50, 7))
    Q, R = et.tsqr(et.from_global(F, et.VC, et.STAR, tgrid(*rc)))
    Qh, Rh = et.to_global(Q).numpy(), et.to_global(R).numpy()
    assert np.abs(np.tril(Rh, -1)).max() == 0
    assert np.linalg.norm(Qh @ Rh - F) < 1e-13 * np.linalg.norm(F)
    assert np.abs(Qh.T @ Qh - np.eye(7)).max() < 1e-13


def test_standalone_tsqr_rejects():
    with pytest.raises(ValueError, match="VC,STAR"):
        et.tsqr(et.from_global(np.ones((8, 2)), et.MC, et.MR, tgrid(2, 2)))
    with pytest.raises(ValueError, match="m >= k"):
        et.tsqr(et.from_global(np.ones((2, 8)), et.VC, et.STAR, tgrid(1, 1)))
