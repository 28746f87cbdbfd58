"""The quantized wire (``comm_precision``) against the JAX package.

The codec (``q8_encode`` / ``q8_decode`` / ``q8_pack`` / ``q8_unpack``)
is bit-equal to the JAX codec, NaN/Inf tiles and zero tiles included.
``redistribute`` and ``panel_spread`` under ``'bf16'`` and ``'int8'``
give storage bit-equal to the JAX engine's (bf16 casts every entry of a
rank's block, the ones it keeps too; int8 round-trips each rank block it
sends, tile by tile, with the scale as XLA computes it inside the JAX
programs).  The knob does nothing on 1x1 grids, replicated sources and
complex payloads; the drivers accept it and land in the documented
residual class.  JAX references run on 2x2 and 2x4 grids at the JAX
tests' sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.redist import engine as j_engine
from elemental_tpu.redist import quantize as jq
from elemental_tpu_torch.redist import engine as t_engine
from elemental_tpu_torch.redist import quantize as tq

RNG = np.random.default_rng(1234)
PAIRS = [(a.value, b.value) for a, b in el.LEGAL_PAIRS
         if "CIRC" not in (a.value, b.value)]
T = tq.QUANT_TILE


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _jp(p):
    return el.Dist[p[0]], el.Dist[p[1]]


def _tp(p):
    return et.Dist[p[0]], et.Dist[p[1]]


def test_vocabulary_and_tile_pinned():
    assert tq.COMM_PRECISIONS == jq.COMM_PRECISIONS
    assert tq.QUANT_TILE == jq.QUANT_TILE
    for dt in (torch.float32, torch.float64, torch.complex64, torch.int32,
               torch.bfloat16):
        assert tq.quantizable(dt) == jq.quantizable(
            np.dtype(str(dt).removeprefix("torch.")) if dt is not
            torch.bfloat16 else jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(T, T), (70, 33), (5, 129),
                                   (3 * T + 7, 2 * T + 5)])
def test_codec_bit_equal_to_jax(dtype, shape):
    x = (RNG.normal(size=shape) * np.logspace(0, 3, shape[1])[None, :]
         ).astype(dtype)
    x[0, :3] = 0.0
    q, s = jq.q8_encode(jnp.asarray(x))
    tq_, ts = tq.q8_encode(torch.as_tensor(x))
    assert np.array_equal(tq_.numpy(), np.asarray(q))
    assert np.array_equal(ts.numpy(), np.asarray(s))
    back = np.asarray(jq.q8_decode(q, s, jnp.dtype(dtype)))
    assert np.array_equal(tq.q8_decode(tq_, ts, getattr(torch, dtype))
                          .numpy(), back)
    packed = jq.q8_pack(jnp.asarray(x))
    tpk = tq.q8_pack(torch.as_tensor(x))
    assert tpk.dtype == torch.int8
    assert np.array_equal(tpk.numpy(), np.asarray(packed))
    assert tq.q8_packed_rows(shape) == jq.q8_packed_rows(shape) \
        == tpk.shape[0]
    un = tq.q8_unpack(tpk, shape, getattr(torch, dtype))
    assert np.array_equal(un.numpy(), back)
    assert np.array_equal(tq.q8_roundtrip(torch.as_tensor(x)).numpy(), back)


def test_int8_error_bound_zero_tiles_and_nonfinite():
    x = RNG.normal(size=(2 * T, 2 * T)).astype(np.float32)
    x[:T, :T] = 0.0
    back = tq.q8_roundtrip(torch.as_tensor(x)).numpy()
    assert (back[:T, :T] == 0).all()
    for ti in range(2):
        for tj in range(2):
            blk = np.s_[ti * T:(ti + 1) * T, tj * T:(tj + 1) * T]
            assert np.abs(x[blk] - back[blk]).max() <= \
                np.abs(x[blk]).max() / 127 + 1e-12
    x[3, 5] = np.nan
    x[T + 2, T + 9] = np.inf
    back = tq.q8_roundtrip(torch.as_tensor(x)).numpy()
    assert not np.isfinite(back[3, 5]) and not np.isfinite(back[T + 2, T + 9])
    assert np.isfinite(back[:T, T:]).all()


def test_reciprocal_scale_is_one_rounding_off_the_division():
    amax = torch.tensor([7.4740800857543945], dtype=torch.float32)
    x = torch.zeros(1, 1, dtype=torch.float32) + amax
    _, s_div = tq.q8_encode(x)
    _, s_rec = tq.q8_encode(x, reciprocal=True)
    assert s_div.item() == (amax / 127).item()
    assert s_rec.item() == (amax * torch.tensor(1 / 127,
                                                dtype=torch.float32)).item()


def _storage_pair(rc, src, F, dst, cp, path=None):
    jA = el.from_global(F, *_jp(src), jgrid(*rc))
    tA = et.from_global(F, *_tp(src), tgrid(*rc))
    jB = el.redistribute(jA, *_jp(dst), comm_precision=cp, path=path)
    tB = et.redistribute(tA, *_tp(dst), comm_precision=cp, path=path)
    return et.storage_numpy(tB), np.asarray(jB.local)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_int8_gathers_bit_equal_to_jax(rc, dtype):
    """The int8 family: every source pair to [STAR,STAR], at ragged and
    multi-tile shapes (the fused 2-D gather and the per-dimension one)."""
    for shape in ((13, 11), (64, 16), (200, 130)):
        F = RNG.normal(size=shape).astype(dtype) * 10
        for src in PAIRS:
            a, b = _storage_pair(rc, src, F, ("STAR", "STAR"), "int8")
            assert np.array_equal(a, b), (shape, src)


_SUBSET = [(("MC", "MR"), ("MR", "STAR")), (("MC", "MR"), ("STAR", "VC")),
           (("VC", "STAR"), ("VR", "STAR")), (("MC", "MR"), ("MR", "MC")),
           (("VC", "STAR"), ("MC", "STAR")), (("STAR", "VR"), ("MC", "MR")),
           (("MR", "STAR"), ("VC", "STAR")), (("STAR", "MC"), ("MC", "MR")),
           (("MC", "STAR"), ("STAR", "MR")), (("MD", "STAR"), ("MC", "MR")),
           (("MC", "MR"), ("MD", "STAR")), (("STAR", "STAR"), ("MC", "MR"))]


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("cp", ["bf16", "int8"])
@pytest.mark.parametrize("path", [None, "direct"])
def test_quantized_pairs_bit_equal_to_jax(rc, cp, path):
    """bf16 on every route, int8 falling back to bf16 off the gather
    family on the chain and riding every slot of a direct plan."""
    for dtype in ("float32", "float64"):
        F = RNG.normal(size=(19, 11)).astype(dtype) * 10
        for src, dst in _SUBSET:
            a, b = _storage_pair(rc, src, F, dst, cp, path)
            assert np.array_equal(a, b), (src, dst, dtype)


@pytest.mark.parametrize("rc", [(2, 2), (2, 4)],
                         ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("cp", ["bf16", "int8"])
def test_panel_spread_bit_equal_to_jax(rc, cp):
    F = RNG.normal(size=(70, 8)).astype(np.float32) * 100
    for conj in (True, False):
        jmc, jmr = el.panel_spread(
            el.from_global(F, el.VC, el.STAR, jgrid(*rc)), conj=conj,
            comm_precision=cp)
        tmc, tmr = et.panel_spread(
            et.from_global(F, et.VC, et.STAR, tgrid(*rc)), conj=conj,
            comm_precision=cp)
        assert np.array_equal(et.storage_numpy(tmc), np.asarray(jmc.local))
        assert np.array_equal(et.storage_numpy(tmr), np.asarray(jmr.local))


def test_knob_does_nothing_where_no_byte_moves():
    arr = RNG.normal(size=(16, 16)).astype(np.float32)
    for cp in ("bf16", "int8"):
        A1 = et.from_global(arr, et.MC, et.MR, tgrid(1, 1))
        with t_engine.redist_trace() as log:
            out = et.redistribute(A1, et.STAR, et.STAR, comm_precision=cp)
            mc, _ = et.panel_spread(et.redistribute(A1, et.VC, et.STAR),
                                    comm_precision=cp)
        assert (et.to_global(out).numpy() == arr).all()
        assert (et.to_global(mc).numpy() == arr).all()
        assert {r.wire_dtype for r in log} == {"float32"}
        ss = et.from_global(arr, et.STAR, et.STAR, tgrid(2, 4))
        out = et.redistribute(ss, et.MC, et.MR, comm_precision=cp)
        assert (et.to_global(out).numpy() == arr).all()
        carr = (arr + 1j * arr).astype(np.complex64)
        Ac = et.from_global(carr, et.MC, et.MR, tgrid(2, 4))
        outc = et.redistribute(Ac, et.STAR, et.STAR, comm_precision=cp)
        assert (et.to_global(outc).numpy() == carr).all()


def test_int8_falls_back_to_bf16_off_the_gather_family():
    A = et.from_global(RNG.normal(size=(32, 32)), et.MC, et.MR, tgrid(2, 4))
    with t_engine.redist_trace() as log:
        et.redistribute(A, et.VC, et.STAR, comm_precision="int8")
        et.redistribute(A, et.STAR, et.STAR, comm_precision="int8")
    assert [r.wire_dtype for r in log] == ["bfloat16", "int8"]
    with t_engine.redist_trace() as full:
        et.redistribute(A, et.STAR, et.STAR)
    # same rounds, an eighth of the float64 bytes
    assert log[1].rounds == full[0].rounds > 0
    assert log[1].wire_bytes * 8 == full[0].wire_bytes


def test_none_is_bit_identical_and_count_equal():
    n, nb = 32, 8
    F = RNG.normal(size=(n, n)).astype(np.float32)
    spd = (F @ F.T / n + n * np.eye(n)).astype(np.float32)
    g = tgrid(2, 4)
    A = et.from_global(F + n * np.eye(n, dtype=np.float32), et.MC, et.MR, g)
    S = et.from_global(spd, et.MC, et.MR, g)
    with t_engine.redist_counts() as c0:
        LU0, p0 = et.lu(A, nb=nb)
        L0 = et.cholesky(S, nb=nb)
    with t_engine.redist_counts() as c1:
        LU1, p1 = et.lu(A, nb=nb, comm_precision=None, redist_path="chain")
        L1 = et.cholesky(S, nb=nb, comm_precision=None, redist_path="chain")
    assert dict(c0) == dict(c1)
    assert torch.equal(LU0.local, LU1.local) and torch.equal(p0, p1)
    assert torch.equal(L0.local, L1.local)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("panel", ["classic", "calu"])
def test_lu_quantized_matches_jax_and_residual_class(mode, panel):
    """The JAX test's setting (n = 64, nb = 16, float32, 2x2): the pivots
    equal the JAX package's, the factor agrees to the wire's rounding (the
    two packages' float32 products differ by an ulp, which a narrow wire
    can turn into a bfloat16 ulp), and the residual is in the documented
    class.  The knob reaches the engine from ``lu`` as in the JAX driver:
    every redistribution record (label, wire dtype, route, rounds, wire
    bytes) equals the JAX package's record of the same call, in order."""
    n = 64
    F = np.random.default_rng(7).normal(size=(n, n)).astype(np.float32)
    with j_engine.redist_trace() as jlog:      # records at trace time
        jLU, jp = jax.jit(lambda a: el.lu(a, nb=16, panel=panel,
                                          comm_precision=mode))(
            el.from_global(F, el.MC, el.MR, jgrid(2, 2)))
    with t_engine.redist_trace() as tlog:
        tLU, tp = et.lu(et.from_global(F, et.MC, et.MR, tgrid(2, 2)),
                        nb=16, panel=panel, comm_precision=mode)

    def wire(log):
        return [(x.label, x.wire_dtype, x.path, x.rounds, x.wire_bytes)
                for x in log]
    assert wire(tlog) == wire(jlog)
    assert any(x.wire_dtype == {"bf16": "bfloat16", "int8": "int8"}[mode]
               for x in tlog)
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    LUh = et.to_global(tLU).numpy().astype(np.float64)
    np.testing.assert_allclose(LUh, np.asarray(el.to_global(jLU)),
                               rtol=0, atol=2.0 ** -5 * np.abs(LUh).max())
    L, U = np.tril(LUh, -1) + np.eye(n), np.triu(LUh)
    res = np.linalg.norm(F[tp.numpy()] - L @ U) / np.linalg.norm(F)
    assert res < 5e-2


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_other_drivers_accept_the_knob(mode):
    n = 32
    rng = np.random.default_rng(9)
    F = rng.normal(size=(n, n)).astype(np.float32)
    spd = (F @ F.T / n + n * np.eye(n)).astype(np.float32)
    g = tgrid(2, 2)
    A = et.from_global(F, et.MC, et.MR, g)
    L = et.cholesky(et.from_global(spd, et.MC, et.MR, g), nb=8,
                    comm_precision=mode)
    Lh = et.to_global(L).numpy()
    assert np.linalg.norm(Lh @ Lh.T - spd) / np.linalg.norm(spd) < 5e-2
    Ap, tau = et.qr(A, nb=8, comm_precision=mode)
    assert np.isfinite(et.to_global(Ap).numpy()).all()
    C = et.gemm(A, A, alg="C", nb=8, comm_precision=mode)
    assert np.linalg.norm(et.to_global(C).numpy() - F @ F) < \
        5e-2 * np.linalg.norm(F @ F)
    H = et.herk("L", A, nb=8, comm_precision=mode)
    assert np.abs(np.tril(et.to_global(H).numpy() - F @ F.T)).max() < \
        5e-2 * np.abs(F @ F.T).max()
    X = et.trsm("L", "L", "N", L, A, nb=8, comm_precision=mode)
    assert np.isfinite(et.to_global(X).numpy()).all()
