"""The port's blocked block-reflector triangle (``kernels/qr_panel.py::
_larft``: levels of batched T12 = -T11 (V1^H V2) T22 from the Gram V^H V)
against the JAX package's column recurrence (``elemental_tpu.lapack.qr.
_larft``) on the same (V, tau): T agrees to atol 1e-5 at float32 and
1e-12 at float64, for k that are and are not powers of two, real and
complex.  V and tau are Householder reflectors of a seeded panel, as
``qr``, ``apply_q`` and the apply functions of ``lapack/condense.py``
build them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elemental_tpu.lapack.qr import _larft as jax_larft
from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_qr, _panel_v

ATOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex128: 1e-12}


def _reflectors(M, k, dtype, seed):
    """(V, tau) of the Householder QR of a seeded (M, k) panel."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(M, k))
    if np.issubdtype(dtype, np.complexfloating):
        P = P + 1j * rng.normal(size=(M, k))
    packed, tau = _panel_qr(torch.from_numpy(P.astype(dtype)))
    return _panel_v(packed), tau


@pytest.mark.parametrize("k", [1, 2, 7, 32, 100, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128],
                         ids=["f32", "f64", "c128"])
def test_blocked_larft_matches_the_jax_recurrence(k, dtype):
    V, tau = _reflectors(3 * k + 5, k, dtype, seed=k)
    T = _larft(V, tau)
    want = np.asarray(jax_larft(jnp.asarray(V.numpy()),
                                jnp.asarray(tau.numpy())))
    assert T.shape == (k, k) and T.dtype == V.dtype
    np.testing.assert_allclose(T.numpy(), want, rtol=0, atol=ATOL[dtype])
    # upper triangular with tau on the diagonal
    np.testing.assert_array_equal(np.tril(T.numpy(), -1), 0)
    np.testing.assert_array_equal(np.diag(T.numpy()), tau.numpy())


def test_blocked_larft_builds_the_orthogonal_q():
    """Q = I - V T V^H of a 512-column panel is orthogonal to rounding, and
    an empty panel gives an empty T."""
    V, tau = _reflectors(700, 512, np.float64, seed=3)
    T = _larft(V, tau)
    Q = torch.eye(700, dtype=torch.float64) - V @ T @ V.mT
    assert float(torch.linalg.norm(Q.mT @ Q - torch.eye(700,
                                                        dtype=torch.float64))) < 1e-12
    assert _larft(V[:, :0], tau[:0]).shape == (0, 0)
