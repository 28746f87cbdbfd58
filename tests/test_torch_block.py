"""The port's tiled ``BlockMatrix`` layout and the small ``core`` members
(mirroring ``tests/core/test_block.py`` and
``tests/core/test_environment.py``): round trips, the cyclic <-> tiled
re-layouts (storage bit-equal to the JAX package's, which is computed
once per module), the ``gemm`` read proxy, ``Grid.lcm`` /
``set_default_grid``, ``DistMatrix.astype`` / ``.like`` /
``.local_shape``, ``shrink_matrix`` / ``split_point``, and the
environment's ``Timer``, ``Args``, ``ProgressLog`` and ``*Ctrl``
structs."""
import functools
import inspect
import io
import time

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4), (3, 2)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def _f(m, n):
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    return (i * 1000.0 + j).astype(np.float64)


@pytest.mark.parametrize("shape", [(16, 24), (13, 7), (1, 9), (8, 8)])
@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_block_roundtrip(rc, shape):
    F = _f(*shape)
    B = et.block_from_global(F, grid=tgrid(*rc))
    assert B.local.shape == (rc[0] * B.tile_rows, rc[1] * B.tile_cols)
    np.testing.assert_array_equal(et.block_to_global(B).numpy(), F)


@functools.cache
def _jax_layouts(rc, shape):
    """The JAX package's tiled and cyclic storage of ``_f(*shape)``."""
    F = _f(*shape)
    B = el.block_from_global(F, grid=jgrid(*rc))
    A = el.block_to_cyclic(B)
    A0 = el.from_global(F, el.MC, el.MR, grid=jgrid(*rc))
    return (np.asarray(B.local), np.asarray(A.local),
            np.asarray(el.block_from_cyclic(A0).local))


@pytest.mark.parametrize("shape", [(16, 24), (13, 7), (23, 5)])
@pytest.mark.parametrize("rc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_block_cyclic_roundtrip_bit_equal_to_jax(rc, shape):
    F = _f(*shape)
    g = tgrid(*rc)
    B = et.block_from_global(F, grid=g)
    A = et.block_to_cyclic(B)
    assert (A.cdist, A.rdist) == (et.MC, et.MR)
    np.testing.assert_array_equal(et.to_global(A).numpy(), F)
    B2 = et.block_from_cyclic(A)
    np.testing.assert_array_equal(et.block_to_global(B2).numpy(), F)
    jB, jA, jB0 = _jax_layouts(rc, shape)
    np.testing.assert_array_equal(B.local.numpy(), jB)
    np.testing.assert_array_equal(A.local.numpy(), jA)
    A0 = et.from_global(F, et.MC, et.MR, grid=g)
    np.testing.assert_array_equal(et.block_from_cyclic(A0).local.numpy(), jB0)
    # the conversions return fresh tensors
    assert B2.local.data_ptr() != A.local.data_ptr()


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_cyclic_block_roundtrip(rc):
    F = _f(19, 11)
    A = et.from_global(F, et.MC, et.MR, grid=tgrid(*rc))
    B = et.block_from_cyclic(A)
    np.testing.assert_array_equal(et.block_to_global(B).numpy(), F)
    A2 = et.block_to_cyclic(B)
    assert torch.equal(A2.local, A.local)
    with pytest.raises(ValueError):
        et.block_from_cyclic(et.redistribute(A, et.VC, et.STAR))


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_gemm_accepts_tiled(rc):
    rng = np.random.default_rng(0)
    Fa, Fb = rng.normal(size=(18, 12)), rng.normal(size=(12, 10))
    g = tgrid(*rc)
    Ba = et.block_from_global(Fa, grid=g)
    Bb = et.block_from_global(Fb, grid=g)
    C = et.gemm(Ba, Bb)
    assert isinstance(C, et.BlockMatrix)          # all tiled in -> tiled out
    np.testing.assert_allclose(et.block_to_global(C).numpy(), Fa @ Fb,
                               atol=1e-12)
    Ae = et.from_global(Fa, et.MC, et.MR, grid=g)
    C2 = et.gemm(Ae, Bb, alg="C", nb=4)
    assert isinstance(C2, et.DistMatrix)          # mixed -> elemental
    np.testing.assert_allclose(et.to_global(C2).numpy(), Fa @ Fb, atol=1e-12)
    # a tiled gemm equals the cyclic one bit for bit
    Ce = et.gemm(Ae, et.block_to_cyclic(Bb))
    assert torch.equal(et.block_to_cyclic(C).local, Ce.local)
    assert et.as_elemental(Ae) is Ae


def test_block_adopt_padded_array():
    g = tgrid(2, 2)
    F = _f(8, 6)
    B = et.block_from_array(torch.as_tensor(F), grid=g)
    np.testing.assert_array_equal(et.to_global(et.block_to_cyclic(B)).numpy(),
                                  F)
    Bh = et.block_from_global(F, grid=g, device_put=False)
    assert Bh.local.device.type == "cpu" and "BlockMatrix" in repr(Bh)


# ---------------------------------------------------------------------
# small core members
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_grid_lcm_and_default_grid(rc):
    assert tgrid(*rc).lcm == jgrid(*rc).lcm
    from elemental_tpu_torch.core import grid as tg
    prev = tg._default_grid
    try:
        g = tgrid(*rc)
        et.set_default_grid(g)
        assert et.default_grid() is g
        A = et.from_global(np.eye(5), et.MC, et.MR)
        assert A.grid is g
    finally:
        tg._default_grid = prev


@pytest.mark.parametrize("rc", [(1, 1), (2, 2), (2, 4)],
                         ids=["1x1", "2x2", "2x4"])
def test_distmatrix_members_and_shrink(rc):
    F = _f(11, 9)
    A = et.from_global(F, et.MC, et.MR, grid=tgrid(*rc))
    jA = el.from_global(F, el.MC, el.MR, grid=jgrid(*rc))
    assert A.local_shape == jA.local_shape
    A32 = A.astype(torch.float32)
    assert A32.dtype == torch.float32 and A32.gshape == A.gshape
    L = A.like(A.local * 2)
    np.testing.assert_array_equal(et.to_global(L).numpy(), 2 * F)
    assert A.like(A.local, gshape=(11, 9)).gshape == (11, 9)
    from elemental_tpu.core.view import shrink_matrix as jshrink
    from elemental_tpu_torch.core.view import shrink_matrix, split_point
    S = shrink_matrix(A, 7, 5)
    np.testing.assert_array_equal(et.to_global(S).numpy(), F[:7, :5])
    np.testing.assert_array_equal(S.local.numpy(),
                                  np.asarray(jshrink(jA, 7, 5).local))
    with pytest.raises(ValueError):
        shrink_matrix(A, 12, 5)
    from elemental_tpu.core.view import split_point as jsplit
    for n, grain in [(10, 2), (7, 3), (1, 4), (64, 8), (5, 8)]:
        assert split_point(n, grain) == jsplit(n, grain)


# ---------------------------------------------------------------------
# environment: Timer, Args, ProgressLog, Ctrl
# ---------------------------------------------------------------------

class TestTimer:
    def test_accumulates(self):
        t = et.Timer("x")
        t.start()
        time.sleep(0.01)
        s = t.stop()
        assert s >= 0.009 and t.total() >= 0.009
        with t:
            time.sleep(0.005)
        assert t.total() >= 0.014
        assert "stopped" in repr(t)
        t.reset()
        assert t.total() == 0.0

    def test_stop_fences_tensors_and_distmatrix(self):
        t = et.Timer()
        t.start()
        A = et.from_global(np.eye(3), et.MC, et.MR, tgrid(1, 1))
        assert t.stop((A, [torch.ones(2)])) >= 0.0

    def test_misuse(self):
        t = et.Timer()
        with pytest.raises(RuntimeError):
            t.stop()
        t.start()
        with pytest.raises(RuntimeError):
            t.start()


class TestArgs:
    def test_typed_parsing(self):
        a = et.Args(["--m", "500", "--tol", "1e-6", "--upper", "--name", "hi"])
        assert a.input("--m", "height", 100) == 500
        assert a.input("--tol", "tolerance", 1e-8) == 1e-6
        assert a.input("--upper", "uplo", False) is True
        assert a.input("--name", "label", "x") == "hi"
        assert a.input("--nb", "blocksize", 128) == 128
        a.process()

    def test_unknown_flag_and_required_missing(self):
        a = et.Args(["--bogus", "1"])
        a.input("--m", "height", 100)
        with pytest.raises(ValueError, match="unknown flag"):
            a.process()
        b = et.Args([])
        b.input("--m", "height", required=True)
        with pytest.raises(ValueError, match="missing required"):
            b.process(report=False)

    def test_dashed_value_and_report(self):
        a = et.Args(["--name", "--weird", "--m", "3"])
        assert a.input("--name", "label", "d") == "--weird"
        a.input("--m", "height", 100)
        a.process()
        buf = io.StringIO()
        a.print_report(stream=buf)
        assert "--m" in buf.getvalue() and "height" in buf.getvalue()


def test_progress_log(capsys):
    p = et.ProgressLog("ipm", print_every=1)
    p.log(0, gap=1.0)
    p.log(1, gap=0.1)
    assert p.history("gap") == [1.0, 0.1]
    assert "[ipm    1]" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["SignCtrl", "PolarCtrl", "HermitianEigCtrl",
                                  "SVDCtrl", "SchurCtrl", "PseudospecCtrl",
                                  "LDLPivotCtrl", "QRCtrl",
                                  "LeastSquaresCtrl"])
def test_ctrl_equals_jax(name):
    c, jc = getattr(et, name)(), getattr(el, name)()
    assert c.kwargs() == jc.kwargs() and hash(c) is not None
    assert inspect.signature(type(c)).parameters.keys() \
        == inspect.signature(type(jc)).parameters.keys()


def test_ctrl_threads_into_driver():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(16, 16))
    A = A + A.T
    Ad = et.from_global(A, et.MC, et.MR, grid=tgrid(2, 2))
    c = et.HermitianEigCtrl(vectors=False, approach="tridiag", nb=8)
    w = et.herm_eig(Ad, **c.kwargs())
    np.testing.assert_allclose(np.sort(w.numpy()), np.linalg.eigvalsh(A),
                               atol=1e-8)


_SLICE_NAMES = [
    "set_default_grid", "Timer", "Args", "ProgressLog", "SignCtrl",
    "PolarCtrl", "HermitianEigCtrl", "SVDCtrl", "SchurCtrl",
    "PseudospecCtrl", "LDLPivotCtrl", "QRCtrl", "LeastSquaresCtrl",
    "remote_updates", "BlockMatrix", "block_from_global",
    "block_from_array", "block_to_global", "block_to_cyclic",
    "block_from_cyclic", "as_elemental", "DistMultiVec", "mv_from_global",
    "mv_to_global", "mv_zeros", "mv_axpy", "mv_scale", "mv_dot", "mv_nrm2",
    "mv_remote_updates", "mv_to_distmatrix", "mv_from_distmatrix",
    "cholesky_pivoted", "cholesky_mod"]


@pytest.mark.parametrize("name", _SLICE_NAMES)
def test_slice_names_have_the_jax_signature(name):
    ours, theirs = getattr(et, name), getattr(el, name)
    if inspect.isclass(ours) and not hasattr(ours, "__dataclass_fields__"):
        ours, theirs = ours.__init__, theirs.__init__
    assert list(inspect.signature(ours).parameters) \
        == list(inspect.signature(theirs).parameters)


def test_gallery_names_have_the_jax_signatures():
    from elemental_tpu import matrices as JM
    from elemental_tpu_torch import matrices as TM
    names = [n for n in dir(JM) if not n.startswith("_")
             and callable(getattr(JM, n))
             and getattr(JM, n).__module__.startswith(
                 "elemental_tpu.matrices")]
    assert len(names) >= 50
    for n in names:
        assert list(inspect.signature(getattr(TM, n)).parameters) \
            == list(inspect.signature(getattr(JM, n)).parameters), n
