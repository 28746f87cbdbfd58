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
from elemental_tpu_torch.kernels.lu_panel import (KERNEL_OUTER_BLOCK,
                                                  _panel_lu, _panel_lu_unb)

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
    """The plain version is the kernel's two levels: outer blocks of
    ``KERNEL_OUTER_BLOCK`` columns, ``inner``-wide chunks inside them."""
    assert KERNEL_OUTER_BLOCK == 128
    for shape, nbw, inner in (((40, 16), 16, 0), ((40, 16), 16, 4),
                              ((150, 140), 140, 32)):
        F = torch.from_numpy(_panel(shape, np.float64))
        got = lu_panel_reference(F, nbw, inner)
        want = _panel_lu(F, nbw, None,
                         (KERNEL_OUTER_BLOCK, inner) if inner else ())
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


def _two_level_lu(F, nbw, ob, cw):
    """The CUDA kernel's algebra (``csrc/lu_panel.cu``), in float64 torch.
    Each cw-column chunk of an ob-column outer block is factored column by
    column on its own columns only; its composed swaps then reach the rest
    of the outer block as one gather of the <= 2 cw rows it displaced; its
    U12 solve and product reach only the rest of the outer block.  Per
    outer block, its composed swaps reach the panel's other columns the
    same way, U12 is solved chunk by chunk (a solve, then a product on the
    outer block's rows below the chunk), and one product of depth ob
    updates the rest of the panel."""
    P = F.clone()
    M = P.shape[0]
    piv = list(range(nbw))

    def move_displaced(lo, hi, cols):
        """Rows lo .. hi-1 and the pivot rows of columns lo .. hi-1 take
        the rows the swaps of those columns send them, on ``cols``."""
        if not cols:
            return
        dst = list(range(lo, hi)) + piv[lo:hi]
        src = []
        for x in dst:
            for j in range(hi - 1, lo - 1, -1):
                x = piv[j] if x == j else (j if x == piv[j] else x)
            src.append(x)
        c = torch.tensor(cols)
        P[torch.tensor(dst)[:, None], c] = P[torch.tensor(src)[:, None], c]

    def solve(lo, hi, c0, c1):
        L = torch.tril(P[lo:hi, lo:hi], -1) + torch.eye(hi - lo,
                                                        dtype=P.dtype)
        P[lo:hi, c0:c1] = torch.linalg.solve_triangular(
            L, P[lo:hi, c0:c1], upper=False, unitriangular=True)

    for so in range(0, nbw, ob):
        eo = min(so + ob, nbw)
        for s in range(so, eo, cw):
            e = min(s + cw, eo)
            for j in range(s, e):
                p = j + int(torch.argmax(P[j:, j].abs()))
                piv[j] = p
                P[[j, p], s:e] = P[[p, j], s:e]
                P[j + 1:, j] /= P[j, j]
                P[j + 1:, j + 1:e] -= torch.outer(P[j + 1:, j], P[j, j + 1:e])
            move_displaced(s, e, list(range(so, s)) + list(range(e, eo)))
            if e < eo:
                solve(s, e, e, eo)
                P[e:, e:eo] -= P[e:, s:e] @ P[s:e, e:eo]
        move_displaced(so, eo, list(range(0, so)) + list(range(eo, nbw)))
        if eo < nbw:
            for s in range(so, eo, cw):
                e = min(s + cw, eo)
                solve(s, e, eo, nbw)
                P[e:eo, eo:] -= P[e:eo, s:e] @ P[s:e, eo:]
            P[eo:, eo:] -= P[eo:, so:eo] @ P[so:eo, eo:]
    perm = torch.arange(M)
    for j in range(nbw):
        perm[[j, piv[j]]] = perm[[piv[j], j]]
    return P, perm


#: (M, nbw, inner): panels across 1-3 outer blocks with ragged chunks, then
#: two within one outer block (where the Pallas kernel is the same function)
TWO_LEVEL = [(300, 129, 48), (300, 129, 64), (320, 200, 48), (320, 200, 64),
             (340, 300, 48), (340, 300, 64), (200, 128, 48), (180, 100, 64)]


@pytest.mark.parametrize("M,nbw,inner", TWO_LEVEL,
                         ids=[f"{m}x{n}-inner{i}" for m, n, i in TWO_LEVEL])
def test_two_level_blocking_matches_plain_and_jax(M, nbw, inner):
    """The kernel's two-level blocking (its displaced-row gathers and its
    chunked U12 solves included) and the plain version give the JAX
    package's ``_panel_lu(P, nbw, None, (128, inner))`` pivots exactly and
    its packed factor to 1e-12 of the largest entry (float64; the same
    algorithm, rounded through other blockings); within one outer block
    the Pallas kernel (interpret mode) gives the same pivots."""
    F = _panel((M, nbw), np.float64)
    jpacked, jperm = jax_panel_lu(jnp.asarray(F), nbw, None,
                                  (KERNEL_OUTER_BLOCK, inner))
    want, wperm = np.asarray(jpacked), np.asarray(jperm)
    tol = 1e-12 * np.abs(want).max()
    for packed, perm in (_two_level_lu(torch.from_numpy(F), nbw,
                                       KERNEL_OUTER_BLOCK, inner),
                         lu_panel_reference(torch.from_numpy(F), nbw, inner)):
        np.testing.assert_array_equal(perm.numpy(), wperm)
        np.testing.assert_allclose(packed.numpy(), want, rtol=0, atol=tol)
    assert _residual(F, want, wperm) < RES_TOL[np.float64]
    if nbw <= KERNEL_OUTER_BLOCK:
        ppacked, pperm = jax_lu_panel(jnp.asarray(F), nbw, inner=inner,
                                      interpret=True)
        np.testing.assert_array_equal(np.asarray(pperm), wperm)
        assert _residual(F, np.asarray(ppacked), wperm) < RES_TOL[np.float64]
