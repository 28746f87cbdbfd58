"""The port's matrix gallery (``matrices/basic.py`` and
``matrices/gallery.py``) against the JAX package's
(``tests/matrices/test_gallery.py``).

Every deterministic and host-seeded generator builds the same matrix in
both packages: bit-equal where the formula is integer or rational (or a
numpy draw), within 1e-14 relative in float64 where it calls a
transcendental (``exp``, ``pow``, ``sqrt``) and XLA's CPU kernels may
round differently (1e-13 for ``fox_li``, whose phases reach ~200 rad),
and within 1e-12 for ``haar`` (a QR).  The JAX
references are built once per module on a 1x1 JAX grid, each under one
``jax.jit``; the port builds each on 1x1 and 2x2 grids.  The device-RNG
generators (a per-rank ``torch.Generator``, not JAX's threefry) are held
to the JAX tests' own checks and to seeded determinism."""
import functools

import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu import matrices as JM
from elemental_tpu_torch import matrices as TM

GRIDS = [(1, 1), (2, 2)]

_RNG = np.random.default_rng(0)
_C, _R = _RNG.normal(size=5), _RNG.normal(size=7)
_R[0] = _C[0]
_RH = _RNG.normal(size=6)
_RH[0] = _C[-1]
_X, _Y = _RNG.normal(size=6), _RNG.normal(size=5) + 10
_FC = np.array([0.0, 1.0, 3.0, 7.0, -2.5])

#: name -> (args, kwargs, tolerance); tolerance 0 means bit-equal
CASES = {
    "zeros": ((7, 5), {}, 0), "ones": ((7, 5), {}, 0),
    "identity": ((7, 5), {}, 0), "hilbert": ((9,), {}, 0),
    "lehmer": ((9,), {}, 0), "minij": ((9,), {}, 0),
    "uniform": ((9, 6), {"seed": 3, "lo": -1.0, "hi": 2.0}, 0),
    "gaussian": ((9, 6), {"seed": 4}, 0),
    "gaussian_c": ((6, 5), {"seed": 4, "dtype": "complex128"}, 0),
    "hermitian_uniform_spectrum": ((8,), {"seed": 5}, 0),
    "fourier": ((8,), {}, 1e-14),
    "toeplitz": ((_C, _R), {}, 0), "hankel": ((_C, _RH), {}, 0),
    "circulant": ((_C,), {}, 0), "cauchy": ((_X, _Y), {}, 0),
    "walsh": ((3,), {}, 0), "walsh_binary": ((3,), {"binary": True}, 0),
    "wilkinson": ((3,), {}, 0), "laplacian_1d": ((9,), {}, 0),
    "laplacian_2d": ((3, 4), {}, 0), "jordan": ((5, 2.5), {}, 0),
    "kahan": ((6, 0.5), {}, 1e-14), "grcar": ((7,), {"k": 2}, 0),
    "parter": ((7,), {}, 0), "pei": ((5, 3.0), {}, 0),
    "redheffer": ((8,), {}, 0), "triw": ((6, -2.0), {"k": 2}, 0),
    "gear": ((7,), {"i_off": 2, "j_off": -3}, 0),
    "gepp_growth": ((6,), {}, 0),
    # under jit XLA divides by the constant sqrt(2n) as a multiply by its
    # reciprocal: an ulp apart from the eager division
    "wigner": ((9,), {"seed": 2}, 1e-15),
    "haar": ((8,), {"seed": 6}, 1e-12),
    "normal_uniform_spectrum": ((7,), {"center": 1.0, "radius": 0.5,
                                       "seed": 1}, 0),
    "demmel": ((8,), {}, 1e-14), "druinsky_toledo": ((4,), {}, 1e-14),
    "egorov": ((10,), {}, 1e-14), "extended_kahan": ((4,), {}, 1e-14),
    # phases up to 16 pi * 4 ~ 200 rad, whose ulp is 2.8e-14
    "fiedler": ((_FC,), {}, 0), "fox_li": ((12,), {}, 1e-13),
    # under jit XLA turns x / sqrt(y) into x * rsqrt(y)
    "gks": ((6,), {}, 1e-14), "hanowa": ((8,), {"mu": -1.0}, 0),
    "helmholtz_1d": ((9, 2.5), {}, 0),
    "helmholtz_2d": ((3, 4, 1.5), {}, 0),
    "helmholtz_3d": ((2, 3, 2, 0.5), {}, 0),
    "laplacian_3d": ((3, 3, 3), {}, 0),
    "jordan_cholesky": ((6,), {}, 0),
    "lauchli": ((5,), {"mu": 1e-4}, 0), "legendre": ((12,), {}, 1e-14),
    "lotkin": ((5,), {}, 0), "one_two_one": ((10,), {}, 0),
    "riffle": ((6,), {}, 1e-14), "ris": ((6,), {}, 0),
    "whale": ((12,), {}, 0),
    "hatano_nelson": ((8,), {"g": 0.5, "seed": 3}, 0),
    "hatano_nelson_open": ((8,), {"g": 0.3, "periodic": False,
                                  "shift": 0.25}, 0),
    "three_valued": ((13, 9), {"seed": 4}, 0),
    "kms": ((8, 0.5), {}, 1e-14),
}

#: float64 unless the generator or the case says otherwise
_DTYPES = {"zeros": "float32", "ones": "float32", "identity": "float32",
           "uniform": "float32", "gaussian": "float32",
           "fourier": "complex128", "egorov": "complex128",
           "fox_li": "complex128", "whale": "complex128",
           "normal_uniform_spectrum": "complex128"}


def _fn(mod, name):
    base = name.removesuffix("_c").removesuffix("_binary") \
        .removesuffix("_open")
    return getattr(mod, base)


def _kwargs(name, kw, torch_side):
    kw = dict(kw)
    dt = kw.pop("dtype", _DTYPES.get(name, "float64"))
    if name not in ("toeplitz", "hankel", "circulant", "fiedler"):
        kw["dtype"] = getattr(torch, dt) if torch_side else np.dtype(dt)
    return kw


def _egorov_phase(i, j):
    """A phase function both packages evaluate in float64."""
    x = i * j
    x = x.double() if isinstance(x, torch.Tensor) else x.astype(np.float64)
    return 0.1 * x


@functools.cache
def _jax_all():
    """Every case's JAX matrix on a 1x1 grid, each built under jit."""
    g = el.Grid(jax.devices()[:1], height=1)
    out = {}
    for name, (args, kw, _) in CASES.items():
        fn = _fn(JM, name)
        jkw = _kwargs(name, kw, False)
        if name == "egorov":
            args = (_egorov_phase,) + args
        build = jax.jit(lambda: fn(*args, grid=g, **jkw).local)
        out[name] = np.asarray(build())[: _shape(name)[0], : _shape(name)[1]]
    return out


def _port(name, rc):
    args, kw, _ = CASES[name]
    if name == "egorov":
        args = (_egorov_phase,) + args
    A = _fn(TM, name)(*args, grid=et.Grid(*rc, device="cpu"),
                      **_kwargs(name, kw, True))
    return A


@functools.cache
def _shape(name):
    return _port(name, (1, 1)).gshape


@pytest.mark.parametrize("rc", GRIDS, ids=[f"{r}x{c}" for r, c in GRIDS])
@pytest.mark.parametrize("name", list(CASES))
def test_generator_equals_jax(name, rc):
    A = _port(name, rc)
    got = et.to_global(A).numpy()
    want = _jax_all()[name]
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = CASES[name][2]
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1))
    # the padding of the stacked storage stays zero
    full = A.local.numpy()
    assert np.count_nonzero(full) == np.count_nonzero(got)


# ---------------------------------------------------------------------
# the JAX tests' own checks, on the port
# ---------------------------------------------------------------------

def _t(A):
    return et.to_global(A).numpy()


G22 = et.Grid(2, 2, device="cpu")


def test_fourier_is_the_unitary_dft():
    n = 8
    F = _t(TM.fourier(n, grid=G22))
    ref = np.exp(-2j * np.pi * np.outer(np.arange(n), np.arange(n)) / n) \
        / np.sqrt(n)
    assert np.linalg.norm(F - ref) < 1e-14
    assert np.linalg.norm(F @ F.conj().T - np.eye(n)) < 1e-13


def test_toeplitz_hankel_circulant_cauchy_walsh_wilkinson():
    sla = pytest.importorskip("scipy.linalg")
    assert np.allclose(_t(TM.toeplitz(_C, _R, grid=G22)),
                       sla.toeplitz(_C, _R))
    assert np.allclose(_t(TM.circulant(_C, grid=G22)), sla.circulant(_C))
    assert np.allclose(_t(TM.hankel(_C, _RH, grid=G22)), sla.hankel(_C, _RH))
    C = _t(TM.cauchy(_X, _Y, grid=G22))
    assert np.allclose(C, 1.0 / (_X[:, None] - _Y[None, :]))
    W = _t(TM.walsh(3, grid=G22))
    assert np.allclose(W @ W.T, 8 * np.eye(8))
    Wk = _t(TM.wilkinson(3, grid=G22))
    assert np.allclose(np.diag(Wk), [3, 2, 1, 0, 1, 2, 3])


def test_structured_misc():
    K = _t(TM.kahan(6, 0.5, grid=G22))
    assert np.allclose(np.diag(K), (np.sqrt(0.75)) ** np.arange(6))
    R = _t(TM.redheffer(8, grid=G22))
    assert R[0].sum() == 8 and R[3, 7] == 1 and R[3, 6] == 0
    L2 = _t(TM.laplacian_2d(3, 4, grid=G22))
    assert np.allclose(L2, L2.T) and np.all(np.linalg.eigvalsh(L2) > 0)
    H = _t(TM.hanowa(8, mu=-1.0, grid=G22))
    w = np.linalg.eigvals(H)
    assert np.allclose(np.sort(w.real), -np.ones(8))
    J = _t(TM.legendre(12, grid=G22))
    w = np.linalg.eigvalsh(J)
    assert w.min() > -1 and w.max() < 1
    R6 = _t(TM.riffle(6, grid=G22))
    np.testing.assert_allclose(R6.sum(axis=1), np.ones(6), rtol=1e-12)
    R3 = _t(TM.extended_kahan(4, grid=G22))
    assert np.allclose(np.tril(R3, -1), 0) and np.linalg.matrix_rank(R3) == 12
    A = _t(TM.egorov(_egorov_phase, 10, grid=G22))
    assert np.allclose(np.abs(A), 1.0 / np.sqrt(10))
    with pytest.raises(ValueError):
        TM.hanowa(7, grid=G22)
    with pytest.raises(ValueError):
        TM.extended_kahan(3, grid=G22)
    with pytest.raises(ValueError):
        TM.normal_uniform_spectrum(4, grid=G22, dtype=torch.float64)


def test_wigner_haar_spectrum():
    W = _t(TM.wigner(16, grid=G22))
    assert np.allclose(W, W.T)
    H = _t(TM.haar(12, grid=G22))
    assert np.linalg.norm(H.T @ H - np.eye(12)) < 1e-13
    N = _t(TM.normal_uniform_spectrum(10, center=1.0, radius=0.5, grid=G22))
    ev = np.linalg.eigvals(N)
    assert np.all(np.abs(ev - 1.0) <= 0.5 + 1e-10)
    assert np.linalg.norm(N @ N.conj().T - N.conj().T @ N) < 1e-12


@pytest.mark.parametrize("rc", [(1, 1), (2, 2), (2, 4)],
                         ids=["1x1", "2x2", "2x4"])
def test_device_rng(rc):
    g = et.Grid(*rc, device="cpu")
    A = TM.gaussian_device(64, 48, grid=g, seed=7)
    Ag = _t(A)
    assert 0.85 < Ag.std() < 1.15 and abs(Ag.mean()) < 0.1
    np.testing.assert_array_equal(Ag, _t(TM.gaussian_device(64, 48, grid=g,
                                                            seed=7)))
    assert not np.array_equal(Ag, _t(TM.gaussian_device(64, 48, grid=g,
                                                        seed=8)))
    # padding stays zero (the library invariant)
    assert np.count_nonzero(A.local.numpy()) == np.count_nonzero(Ag)
    U = _t(TM.uniform_device(40, grid=g, lo=2.0, hi=3.0, seed=1))
    assert U.min() >= 2.0 and U.max() <= 3.0 and 2.4 < U.mean() < 2.6
    Rm = _t(TM.rademacher(40, grid=g, seed=2))
    assert set(np.unique(Rm)) == {-1.0, 1.0}
    Bn = _t(TM.bernoulli(40, p=0.25, grid=g, seed=3, dtype=torch.float64))
    assert set(np.unique(Bn)) == {0.0, 1.0} and 0.18 < Bn.mean() < 0.32
    Z = _t(TM.gaussian_device(30, grid=g, seed=4, dtype=torch.complex128))
    assert 0.8 < Z.real.std() < 1.2 and 0.8 < Z.imag.std() < 1.2


def test_device_rng_streams_are_per_rank():
    """A 2x2 grid draws four independent rank blocks: the 1x1 stream of
    the same seed is rank 0's block, and the rank streams differ."""
    A = TM.gaussian_device(8, 8, grid=et.Grid(2, 2, device="cpu"), seed=5)
    B = TM.gaussian_device(4, 4, grid=et.Grid(device="cpu"), seed=5)
    st = A.local.numpy()
    np.testing.assert_array_equal(st[:4, :4], B.local.numpy())
    blocks = [st[r * 4:(r + 1) * 4, c * 4:(c + 1) * 4]
              for r in range(2) for c in range(2)]
    assert all(not np.array_equal(blocks[0], b) for b in blocks[1:])
