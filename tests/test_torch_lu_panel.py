"""The port's ``lu_panel`` (plain version, as run for CPU tensors) and its
panel ladder against the JAX package's ``lu_panel`` (Pallas, interpret
mode), ``_panel_lu`` and ``_panel_lu_unb``, and the ``panel_impl`` plan.

Contract of ``tests/kernels/test_lu_panel.py``: identical pivot sequences
(including constructed |pivot| ties), and ``||F[perm] - L U|| / ||F||``
below 1e-5 at float32 and 1e-12 at float64.  The packed factors of the
two packages agree to 1e-12 (float64) of the largest entry: the same
algorithm, with the products rounded by different libraries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elemental_tpu.kernels import lu_panel as jax_lu_panel
from elemental_tpu.lapack.lu import _panel_lu as jax_panel_lu
from elemental_tpu.lapack.lu import _panel_lu_unb as jax_panel_lu_unb
from elemental_tpu_torch.kernels import (DEFAULT_INNERS, PanelPlan,
                                         default_inners, lu_panel,
                                         lu_panel_reference, resolve_panel)
from elemental_tpu_torch.kernels.lu_panel import _panel_lu, _panel_lu_unb

RES_TOL = {np.float32: 1e-5, np.float64: 1e-12}
#: (shape, nbw, inner) -- the unblocked rungs of the JAX kernel tests at
#: inner 0, and its chunked panel at inner 8 / 16 / 32
LADDER = [((64, 16), 16, 0), ((40, 40), 40, 0), ((8, 3), 3, 0),
          ((33, 7), 7, 0), ((96, 64), 64, 8), ((96, 64), 64, 16),
          ((96, 64), 64, 32)]


def _panel(shape, dtype):
    return np.random.default_rng(sum(shape)).normal(size=shape).astype(dtype)


def _tie_panel():
    """Columns where several rows tie on |value| at each pivot search
    (``tests/kernels/test_lu_panel.py::test_pivot_ties_break_identically``)."""
    m, w = 32, 8
    P = np.zeros((m, w), dtype=np.float32)
    rng = np.random.default_rng(3)
    for j in range(w):
        P[:, j] = rng.integers(1, 4, size=m).astype(np.float32)
        P[j::5, j] = 3.0
        P[:, j] *= np.sign(rng.normal(size=m)) + 0.5
    return P


def _residual(F, packed, perm):
    m, w = F.shape
    L = np.tril(packed, -1) + np.eye(m, w)
    U = np.triu(packed[:w])
    return np.linalg.norm(F[perm] - L @ U) / np.linalg.norm(F)


@pytest.mark.parametrize("shape,nbw,inner", LADDER,
                         ids=[f"{s[0]}x{s[1]}-inner{k}" for s, _, k in LADDER])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
def test_lu_panel_matches_jax(shape, nbw, inner, dtype):
    F = _panel(shape, dtype)
    packed, perm = lu_panel(torch.from_numpy(F), nbw, inner=inner)
    packed, perm = packed.numpy(), perm.numpy()
    assert _residual(F, packed, perm) < RES_TOL[dtype]
    jP = jnp.asarray(F)
    twins = [jax_lu_panel(jP, nbw, inner=inner, interpret=True),
             jax_panel_lu(jP, nbw, None, (inner,) if inner else ())]
    for jpacked, jperm in twins:
        np.testing.assert_array_equal(perm, np.asarray(jperm))
        assert _residual(F, np.asarray(jpacked), perm) < RES_TOL[dtype]
    if dtype == np.float64:
        want = np.asarray(twins[1][0])
        np.testing.assert_allclose(packed, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("inners", [(32, 8), (16,), ()],
                         ids=["32-8", "16", "unblocked"])
def test_panel_ladder_matches_jax(inners):
    F = _panel((80, 48), np.float64)
    packed, perm = _panel_lu(torch.from_numpy(F), 48, None, inners)
    jpacked, jperm = jax_panel_lu(jnp.asarray(F), 48, None, inners)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    want = np.asarray(jpacked)
    np.testing.assert_allclose(packed.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", ["random-float64", "ties-float32"])
def test_unblocked_matches_jax(case):
    F = _tie_panel() if case.startswith("ties") else _panel((33, 7), np.float64)
    w = F.shape[1]
    packed, perm = _panel_lu_unb(torch.from_numpy(F), w)
    jpacked, jperm = jax_panel_lu_unb(jnp.asarray(F), w)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    want = np.asarray(jpacked)
    np.testing.assert_allclose(packed.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_tie_panel_pivots_through_the_wrapper():
    F = _tie_panel()
    _, perm = lu_panel(torch.from_numpy(F), 8, inner=4)
    _, jperm = jax_lu_panel(jnp.asarray(F), 8, inner=4, interpret=True)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def test_lu_panel_leaves_its_input_untouched():
    P = torch.from_numpy(_panel((24, 8), np.float64))
    before = P.clone()
    lu_panel(P, 8, inner=4)
    assert torch.equal(P, before)


def test_lu_panel_refuses_complex_and_bad_shapes():
    with pytest.raises(ValueError, match="real-only"):
        lu_panel(torch.ones(16, 4, dtype=torch.complex64), 4, inner=2)
    with pytest.raises(ValueError, match="M >= nbw"):
        lu_panel(torch.ones(3, 4), 4, inner=2)
    with pytest.raises(ValueError, match="M >= nbw"):
        lu_panel(torch.ones(8, 4), 3, inner=2)


def test_complex_plain_ladder_matches_jax():
    rng = np.random.default_rng(4)
    F = rng.normal(size=(30, 12)) + 1j * rng.normal(size=(30, 12))
    packed, perm = _panel_lu(torch.from_numpy(F), 12, None, (8, 4))
    jpacked, jperm = jax_panel_lu(jnp.asarray(F), 12, None, (8, 4))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert _residual(F, packed.numpy(), perm.numpy()) < 1e-13


def test_cpu_tensor_never_counts_a_launch():
    before = lu_panel.launches
    lu_panel(torch.from_numpy(_panel((16, 4), np.float64)), 4, inner=2)
    assert lu_panel.launches == before


def test_reference_is_the_chunked_ladder():
    F = torch.from_numpy(_panel((40, 16), np.float64))
    for inner in (0, 4):
        got = lu_panel_reference(F, 16, inner)
        want = _panel_lu(F, 16, None, (inner,) if inner else ())
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_panel_plan_inners():
    assert DEFAULT_INNERS == (512, 64) and default_inners() == (512, 64)
    f32 = torch.float32
    plan = resolve_panel(None, dtype=f32, device="cuda:0")
    assert plan.impl == "kernel" and plan.inners == (512, 64)
    assert plan.kernel_inner == 64
    assert resolve_panel("torch", dtype=f32, inners=[32, 8]).inners == (32, 8)
    assert resolve_panel("kernel", dtype=f32, inners=(16,)).kernel_inner == 16
    assert PanelPlan(inners=()).kernel_inner == 0
    cplx = resolve_panel("kernel", dtype=torch.complex128, inners=(8,))
    assert (cplx.impl, cplx.source, cplx.inners) == ("torch", "complex-torch",
                                                     (8,))
