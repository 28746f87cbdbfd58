"""Matrix gallery: deterministic generators + per-rank device RNG.

PyTorch port of ``elemental_tpu/matrices/gallery.py`` (Elemental
``src/matrices/**``: ``Fourier``, ``Toeplitz``, ``Hankel``,
``Circulant``, ``Cauchy``, ``Walsh``, ``Wilkinson``, ``Laplacian``,
``Jordan``, ``Kahan``, ``Grcar``, ``Parter``, ``Pei``, ``Redheffer``,
``TriW``, ``Gear``, ``GEPPGrowth``, ``Wigner``, ``Haar``, ``Bernoulli``,
``Rademacher``, ``NormalUniformSpectrum`` and the rest).

Deterministic generators ride :func:`..blas.level1.index_dependent_fill`
on the grid's device, each formula evaluated in the JAX package's order
and precision (float64 where an integer index meets a Python float) and
cast to the requested dtype: where the formula is integer or rational
the storage is bit-equal to the JAX package's; where it calls a
transcendental (``exp``, ``sqrt``, ``pow``) the two agree to rounding.

Random generators come in two flavors.  Those the JAX package draws on
the host (``wigner``, ``haar``, ``normal_uniform_spectrum``,
``hatano_nelson``, ``three_valued``) draw the same numpy streams here.
The device-side ones (``gaussian_device``, ``uniform_device``,
``bernoulli``, ``rademacher``) draw each rank's local block from its own
stream, the reference's rank-seeded per-process PRNGs: the JAX package
folds the rank into a threefry key, which torch cannot reproduce, so the
port seeds one ``torch.Generator`` per rank from ``(seed, rank)``.  Their
values depend on the grid shape and the device type (a CUDA generator
draws other values than the CPU one), are deterministic per (seed, grid,
device), and never leave the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..blas.level1 import (_valid_mask, index_dependent_fill,
                           make_symmetric, shift_diagonal)
from ..core.dist import MC, MR
from ..core.distmatrix import DistMatrix, from_global
from ..core.grid import Grid, default_grid
from ..core.distmatrix import _numpy_dtype
from .basic import _empty, _f64, gaussian as _host_gaussian

_F64 = torch.float64


def _fill(A: DistMatrix, f) -> DistMatrix:
    """``index_dependent_fill`` with ``f``'s result cast to A's dtype."""
    return index_dependent_fill(A, lambda i, j: f(i, j).to(A.dtype))


def _where(cond, a, b):
    """``torch.where`` that lifts Python numbers to float64 tensors (or
    complex128 for complex numbers), as JAX does under x64."""
    def lift(x):
        if isinstance(x, torch.Tensor):
            return x
        dt = torch.complex128 if isinstance(x, complex) else _F64
        return torch.tensor(x, dtype=dt, device=cond.device)
    return torch.where(cond, lift(a), lift(b))


def _vec(x, device, dtype=None) -> torch.Tensor:
    """A 1-D tensor on ``device`` from numpy, a list or a tensor."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


def _parity(x: torch.Tensor) -> torch.Tensor:
    """popcount(x) % 2 of non-negative int64 entries, by folding the
    bits (the JAX package counts them one by one; the parity is the
    same)."""
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[idx]`` with idx clamped into range (JAX's gather clamps; the
    clamped padding positions are masked afterwards)."""
    return v[idx.clamp(0, v.shape[0] - 1)]


# ---------------------------------------------------------------------
# deterministic generators
# ---------------------------------------------------------------------

def fourier(n: int, grid: Grid | None = None, dtype=torch.complex128):
    """Unitary DFT matrix (``El::Fourier``): F[i,j] = e^{-2 pi i ij/n}/sqrt(n)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    w = -2.0 * math.pi / n
    return _fill(A, lambda i, j: torch.exp(1j * w * _f64(i * j))
                 / math.sqrt(n))


def toeplitz(col, row, grid: Grid | None = None, dtype=None):
    """Toeplitz from first column ``col`` and first row ``row``
    (``El::Toeplitz``; row[0] ignored in favor of col[0])."""
    grid = grid or default_grid()
    col = _vec(col, grid.device)
    row = _vec(row, grid.device)
    m, n = col.shape[0], row.shape[0]
    dtype = dtype or torch.promote_types(col.dtype, row.dtype)
    A = _empty(m, n, grid, dtype)
    ext = torch.cat([row[1:].flip(0), col]).to(dtype)
    return _fill(A, lambda i, j: ext[(i - j + n - 1).clamp(0, m + n - 2)])


def hankel(col, row, grid: Grid | None = None, dtype=None):
    """Hankel from first column and last row (``El::Hankel``)."""
    grid = grid or default_grid()
    col = _vec(col, grid.device)
    row = _vec(row, grid.device)
    m, n = col.shape[0], row.shape[0]
    dtype = dtype or torch.promote_types(col.dtype, row.dtype)
    A = _empty(m, n, grid, dtype)
    ext = torch.cat([col, row[1:]]).to(dtype)
    return _fill(A, lambda i, j: ext[(i + j).clamp(0, m + n - 2)])


def circulant(c, grid: Grid | None = None, dtype=None):
    """Circulant with first column ``c`` (``El::Circulant``)."""
    grid = grid or default_grid()
    c = _vec(c, grid.device)
    n = c.shape[0]
    dtype = dtype or c.dtype
    A = _empty(n, n, grid, dtype)
    cd = c.to(dtype)
    return _fill(A, lambda i, j: cd[(i - j) % n])


def cauchy(x, y, grid: Grid | None = None, dtype=torch.float64):
    """C[i,j] = 1/(x_i - y_j) (``El::Cauchy``)."""
    grid = grid or default_grid()
    x = _vec(x, grid.device, dtype)
    y = _vec(y, grid.device, dtype)
    A = _empty(x.shape[0], y.shape[0], grid, dtype)
    return _fill(A, lambda i, j: 1.0 / (_take(x, i) - _take(y, j)))


def walsh(k: int, binary: bool = False, grid: Grid | None = None,
          dtype=torch.float64):
    """2^k x 2^k Walsh matrix (``El::Walsh``): (-1)^{popcount(i & j)}
    (or 0/1 when ``binary``)."""
    n = 1 << k
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        val = 1.0 - 2.0 * _f64(_parity(i & j))
        return (val + 1) / 2 if binary else val

    return _fill(A, f)


def wilkinson(k: int, grid: Grid | None = None, dtype=torch.float64):
    """(2k+1) x (2k+1) Wilkinson eigenvalue test matrix (``El::Wilkinson``)."""
    n = 2 * k + 1
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        diag = (i - k).abs().to(dtype)
        off = ((j == i + 1) | (i == j + 1)).to(dtype)
        return torch.where(i == j, diag, off)

    return _fill(A, f)


def laplacian_1d(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Tridiagonal [-1, 2, -1] (``El::Laplacian`` 1-D)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == j, 2.0, _where((i - j).abs() == 1, -1.0, 0.0)))


def laplacian_2d(nx: int, ny: int, grid: Grid | None = None,
                 dtype=torch.float64):
    """5-point 2-D grid Laplacian of size (nx*ny)^2 (``El::Laplacian``)."""
    n = nx * ny
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        xi, yi = i % nx, i // nx
        xj, yj = j % nx, j // nx
        horiz = (yi == yj) & ((xi - xj).abs() == 1)
        vert = (xi == xj) & ((yi - yj).abs() == 1)
        return _where(i == j, 4.0, _where(horiz | vert, -1.0, 0.0))

    return _fill(A, f)


def jordan(n: int, lam, grid: Grid | None = None, dtype=torch.float64):
    """Jordan block with eigenvalue ``lam`` (``El::Jordan``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    A = shift_diagonal(A, lam, 0)
    return shift_diagonal(A, 1, 1)


def kahan(n: int, phi: float = 0.5, grid: Grid | None = None,
          dtype=torch.float64):
    """Kahan's ill-conditioned triangular matrix (``El::Kahan``)."""
    zeta = math.sqrt(1.0 - phi * phi)
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        zi = torch.tensor(zeta, dtype=dtype, device=i.device) ** i.to(dtype)
        return torch.where(i == j, zi,
                           torch.where(j > i, -phi * zi, torch.zeros_like(zi)))

    return _fill(A, f)


def grcar(n: int, k: int = 3, grid: Grid | None = None, dtype=torch.float64):
    """Grcar nonnormal test matrix (``El::Grcar``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == j + 1, -1.0, _where((j >= i) & (j <= i + k), 1.0, 0.0)))


def parter(n: int, grid: Grid | None = None, dtype=torch.float64):
    """P[i,j] = 1/(i - j + 1/2) (``El::Parter``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: 1.0 / (i.to(dtype) - j.to(dtype) + 0.5))


def pei(n: int, alpha: float = 1.0, grid: Grid | None = None,
        dtype=torch.float64):
    """alpha I + ones (``El::Pei``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(i == j, float(alpha + 1), 1.0))


def redheffer(n: int, grid: Grid | None = None, dtype=torch.float64):
    """R[i,j] = 1 if j == 0 or (j+1) % (i+1) == 0 (``El::Redheffer``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: ((j == 0) | ((j + 1) % (i + 1) == 0)))


def triw(n: int, alpha, k: int | None = None, grid: Grid | None = None,
         dtype=torch.float64):
    """Upper triangular with 1s on the diagonal and ``alpha`` on the next
    ``k`` superdiagonals (``El::TriW``)."""
    k = n - 1 if k is None else k
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == j, 1.0, _where((j > i) & (j <= i + k), alpha, 0.0)))


def gear(n: int, i_off: int = 1, j_off: int = -1, grid: Grid | None = None,
         dtype=torch.float64):
    """Gear matrix (``El::Gear``): sub/super-diagonal of ones plus two
    corner entries."""
    i_idx = abs(i_off) - 1 if i_off != 0 else 0
    j_idx = n - abs(j_off) if j_off != 0 else n - 1
    si = float(np.sign(i_off))
    sj = float(np.sign(j_off))
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        off = ((i == j + 1) | (j == i + 1)).to(_F64)
        c1 = (i == 0) & (j == i_idx)
        c2 = (i == n - 1) & (j == j_idx)
        # corners OVERWRITE (El::Gear uses Set, not Update)
        return _where(c1, si, _where(c2, sj, off))

    return _fill(A, f)


def gepp_growth(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Wilkinson's GEPP growth-factor matrix (``El::GEPPGrowth``):
    identity, lower triangle of -1s, a ones last column."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == j, 1.0, _where(j == n - 1, 1.0, _where(i > j, -1.0, 0.0))))


# ---------------------------------------------------------------------
# random generators (device-side, one stream per rank)
# ---------------------------------------------------------------------

def _rank_seed(seed: int, rank: int) -> int:
    """The 64-bit seed of rank ``rank``'s stream for ``seed``."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)
    return int(state[0])


def _device_random(m: int, n: int, grid: Grid, dtype, seed: int, sampler):
    """Per-rank device-side sampling: rank (r, c) draws its local block
    from the generator seeded by ``(seed, r*width + c)`` into its tile of
    the stacked storage; the global matrix is never formed.  Padding is
    re-zeroed afterwards (the library invariant)."""
    meta = DistMatrix(None, (m, n), MC, MR, 0, 0, grid)
    lr, lc = meta.local_rows, meta.local_cols
    stor = torch.empty((grid.height * lr, grid.width * lc), dtype=dtype,
                       device=grid.device)
    gen = torch.Generator(device=grid.device)
    for r in range(grid.height):
        for c in range(grid.width):
            gen.manual_seed(_rank_seed(seed, r * grid.width + c))
            stor[r * lr:(r + 1) * lr, c * lc:(c + 1) * lc] = \
                sampler(gen, (lr, lc))
    out = meta.with_local(stor)
    return out.with_local(torch.where(_valid_mask(out), stor, 0))


def gaussian_device(m: int, n: int | None = None, grid: Grid | None = None,
                    dtype=torch.float32, seed: int = 0) -> DistMatrix:
    """Device-side standard normal (``El::Gaussian`` with rank seeding);
    a complex dtype draws unit-variance real and imaginary parts."""
    n = n or m
    grid = grid or default_grid()
    dev = grid.device
    if dtype.is_complex:
        rd = torch.empty((), dtype=dtype).real.dtype

        def sampler(gen, shape):
            re = torch.randn(shape, generator=gen, dtype=rd, device=dev)
            im = torch.randn(shape, generator=gen, dtype=rd, device=dev)
            return torch.complex(re, im)
    else:
        def sampler(gen, shape):
            return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    return _device_random(m, n, grid, dtype, seed, sampler)


def uniform_device(m: int, n: int | None = None, grid: Grid | None = None,
                   dtype=torch.float32, seed: int = 0, lo=0.0,
                   hi=1.0) -> DistMatrix:
    """Device-side uniform on [lo, hi) (``El::Uniform`` with rank
    seeding)."""
    n = n or m
    grid = grid or default_grid()
    dev = grid.device

    def sampler(gen, shape):
        u = torch.rand(shape, generator=gen, dtype=dtype, device=dev)
        return u * (hi - lo) + lo

    return _device_random(m, n, grid, dtype, seed, sampler)


def bernoulli(m: int, n: int | None = None, p: float = 0.5,
              grid: Grid | None = None, dtype=torch.float32,
              seed: int = 0) -> DistMatrix:
    """0/1 Bernoulli(p) entries (``El::Bernoulli``), device-side."""
    n = n or m
    grid = grid or default_grid()
    dev = grid.device

    def sampler(gen, shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return (u < p).to(dtype)

    return _device_random(m, n, grid, dtype, seed, sampler)


def rademacher(m: int, n: int | None = None, grid: Grid | None = None,
               dtype=torch.float32, seed: int = 0) -> DistMatrix:
    """+-1 entries (``El::Rademacher``), device-side."""
    n = n or m
    grid = grid or default_grid()
    dev = grid.device

    def sampler(gen, shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return 2 * (u < 0.5).to(dtype) - 1

    return _device_random(m, n, grid, dtype, seed, sampler)


def wigner(n: int, grid: Grid | None = None, dtype=torch.float64,
           seed: int = 0) -> DistMatrix:
    """Symmetric Gaussian (Wigner) matrix (``El::Wigner``), from the
    host-seeded Gaussian."""
    G = _host_gaussian(n, n, grid=grid, dtype=dtype, seed=seed)
    return make_symmetric(G.with_local(G.local / math.sqrt(2.0 * n)), "L",
                          conj=dtype.is_complex)


def haar(n: int, grid: Grid | None = None, dtype=torch.float64,
         seed: int = 0) -> DistMatrix:
    """Haar-distributed orthogonal/unitary matrix via QR of the
    host-seeded Gaussian (``El::Haar``)."""
    from ..lapack.qr import explicit_q
    from ..lapack.qr import qr as _qr
    G = _host_gaussian(n, n, grid=grid, dtype=dtype, seed=seed)
    Ap, tau = _qr(G)
    return explicit_q(Ap, tau)


def normal_uniform_spectrum(n: int, center=0.0, radius: float = 1.0,
                            grid: Grid | None = None,
                            dtype=torch.complex128,
                            seed: int = 0) -> DistMatrix:
    """Normal matrix with eigenvalues uniform in a disk
    (``El::NormalUniformSpectrum``): Q diag(lam) Q^H, Q Haar."""
    if not dtype.is_complex:
        raise ValueError("normal_uniform_spectrum's spectrum is genuinely "
                         "complex; pass a complex dtype")
    rng = np.random.default_rng(seed)
    rad = radius * np.sqrt(rng.uniform(size=n))
    ang = rng.uniform(0, 2 * np.pi, size=n)
    lam = center + rad * np.exp(1j * ang)
    Gq = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    Q, _ = np.linalg.qr(Gq)
    A = (Q * lam) @ Q.conj().T
    return from_global(A.astype(_numpy_dtype(dtype)), MC, MR,
                       grid=grid or default_grid())


# ---------------------------------------------------------------------
# the remaining generators
# ---------------------------------------------------------------------

def demmel(n: int, grid: Grid | None = None, dtype=torch.float64):
    """B[i,j] = beta^{j-i} on and above the diagonal with
    beta = 10^{4/(n-1)} (``El::Demmel``, highly nonnormal)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    beta = 10.0 ** (4.0 / max(n - 1, 1))
    return _fill(A, lambda i, j: _where(j >= i, beta ** (j - i).to(dtype),
                                        0.0))


def druinsky_toledo(k: int, grid: Grid | None = None, dtype=torch.float64):
    """The 2k x 2k Bunch-Kaufman growth example of Druinsky-Toledo
    (``El::DruinskyToledo``): [[T, I], [I, 0]] with T the k x k unit
    lower-triangular accumulation of -alpha powers."""
    n = 2 * k
    A = _empty(n, n, grid or default_grid(), dtype)
    phi = (1.0 + math.sqrt(17.0)) / 8.0

    def f(i, j):
        alpha = torch.tensor(phi, dtype=dtype, device=i.device)
        in_tl = (i < k) & (j < k)
        tl = _where(i == j, 1.0,
                    _where(i > j, -(alpha ** (i - j).to(dtype)), 0.0))
        eye_tr = ((j >= k) & (i == j - k)).to(dtype)
        eye_bl = ((i >= k) & (j == i - k)).to(dtype)
        return torch.where(in_tl, tl, eye_tr + eye_bl)

    return _fill(A, f)


def egorov(fn, n: int, grid: Grid | None = None, dtype=torch.complex128):
    """Egorov Fourier-integral-operator matrix (``El::Egorov``):
    A[i,j] = e^{i phi(i, j)} / sqrt(n) for a caller phase function, which
    receives the int64 global index tensors."""
    A = _empty(n, n, grid or default_grid(), dtype)
    s = 1.0 / math.sqrt(n)
    return _fill(A, lambda i, j: s * torch.exp(1j * fn(i, j)))


def _hadamard_sign(i, j):
    """(-1)^{popcount(i & j)} over 15 bits, as float64."""
    return _where(_parity((i & j) & 0x7FFF) == 0, 1.0, -1.0)


def extended_kahan(k: int, phi: float = 0.6, mu: float = 1e-5,
                   grid: Grid | None = None, dtype=torch.float64):
    """The 3k x 3k extended Kahan RRQR counterexample
    (``El::ExtendedKahan``): diag(zeta^i) [[I, zeta H/sqrt(k), 0],
    [0, phi I, mu H/sqrt(k)], [0, 0, mu I]] with H the k x k
    Walsh-Hadamard matrix; built densely from the closed form."""
    n = 3 * k
    if k & (k - 1):
        raise ValueError("extended_kahan needs k a power of two")
    zeta = math.sqrt(1.0 - phi * phi)
    A = _empty(n, n, grid or default_grid(), dtype)
    sk = 1.0 / math.sqrt(k)

    def f(i, j):
        bi, bj = i // k, j // k
        ii, jj = i % k, j % k
        blk00 = ((bi == 0) & (bj == 0) & (ii == jj)).to(dtype)
        blk01 = _where((bi == 0) & (bj == 1),
                       zeta * sk * _hadamard_sign(ii, jj), 0.0)
        blk11 = _where((bi == 1) & (bj == 1) & (ii == jj), phi, 0.0)
        blk12 = _where((bi == 1) & (bj == 2),
                       mu * sk * _hadamard_sign(ii, jj), 0.0)
        blk22 = _where((bi == 2) & (bj == 2) & (ii == jj), mu, 0.0)
        pre = blk00 + blk01 + blk11 + blk12 + blk22
        return (zeta ** i.to(dtype)) * pre

    return _fill(A, f)


def fiedler(c, grid: Grid | None = None, dtype=None):
    """F[i,j] = |c_i - c_j| (``El::Fiedler``)."""
    grid = grid or default_grid()
    c = _vec(c, grid.device)
    n = c.shape[0]
    dtype = dtype or c.dtype
    A = _empty(n, n, grid, dtype)
    return _fill(A, lambda i, j: (_take(c, i) - _take(c, j)).abs())


def fox_li(n: int, omega: float = 16 * math.pi,
           grid: Grid | None = None, dtype=torch.complex128):
    """Fox-Li laser cavity integral operator (``El::FoxLi``), midpoint
    discretization on [-1, 1]: A[i,j] = sqrt(i w/pi) e^{-i w (x_i-x_j)^2} h."""
    A = _empty(n, n, grid or default_grid(), dtype)
    h = 2.0 / n

    def f(i, j):
        pref = torch.sqrt(torch.tensor(1j * omega / math.pi,
                                       dtype=torch.complex128,
                                       device=i.device))
        xi = -1.0 + (_f64(i) + 0.5) * h
        xj = -1.0 + (_f64(j) + 0.5) * h
        return pref * torch.exp(-1j * omega * (xi - xj) ** 2) * h

    return _fill(A, f)


def gks(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Upper triangular with G[i,i]=1/sqrt(i+1), G[i,j]=-1/sqrt(j+1) for
    j > i (``El::GKS``, a condition-estimator counterexample)."""
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        rsj = 1.0 / torch.sqrt(j.to(dtype) + 1.0)
        return _where(i == j, rsj, _where(j > i, -rsj, 0.0))

    return _fill(A, f)


def hanowa(n: int, mu: float = -1.0, grid: Grid | None = None,
           dtype=torch.float64):
    """[[mu I, -D]; [D, mu I]] with D = diag(1..n/2) (``El::Hanowa``);
    eigenvalues mu +- i k."""
    if n % 2:
        raise ValueError("hanowa needs even n")
    k = n // 2
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        d = (i % k).to(dtype) + 1.0
        diag = _where(i == j, mu, 0.0)
        tr = _where((i < k) & (j == i + k), -d, 0.0)
        bl = _where((i >= k) & (j == i - k), d, 0.0)
        return diag + tr + bl

    return _fill(A, f)


def helmholtz_1d(n: int, shift: float, grid: Grid | None = None,
                 dtype=torch.float64):
    """1-D Laplacian minus a shift (``El::Helmholtz``)."""
    return shift_diagonal(laplacian_1d(n, grid=grid, dtype=dtype), -shift)


def helmholtz_2d(nx: int, ny: int, shift: float, grid: Grid | None = None,
                 dtype=torch.float64):
    """2-D Helmholtz (``El::Helmholtz``)."""
    return shift_diagonal(laplacian_2d(nx, ny, grid=grid, dtype=dtype),
                          -shift)


def helmholtz_3d(nx: int, ny: int, nz: int, shift: float,
                 grid: Grid | None = None, dtype=torch.float64):
    """3-D Helmholtz on the nx*ny*nz grid (7-point stencil)."""
    return shift_diagonal(laplacian_3d(nx, ny, nz, grid=grid, dtype=dtype),
                          -shift)


def laplacian_3d(nx: int, ny: int, nz: int, grid: Grid | None = None,
                 dtype=torch.float64):
    """Negative 3-D Dirichlet Laplacian, 7-point stencil (diag 6, off -1),
    lexicographic (x fastest) ordering (``El::Laplacian`` 3-D overload).
    Like :func:`laplacian_1d` / :func:`laplacian_2d`, UNSCALED."""
    n = nx * ny * nz
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        xi, yi, zi = i % nx, (i // nx) % ny, i // (nx * ny)
        xj, yj, zj = j % nx, (j // nx) % ny, j // (nx * ny)
        diag = _where(i == j, 6.0, 0.0)
        ex = _where((zi == zj) & (yi == yj) & ((xi - xj).abs() == 1),
                    -1.0, 0.0)
        ey = _where((zi == zj) & (xi == xj) & ((yi - yj).abs() == 1),
                    -1.0, 0.0)
        ez = _where((yi == yj) & (xi == xj) & ((zi - zj).abs() == 1),
                    -1.0, 0.0)
        return diag + ex + ey + ez

    return _fill(A, f)


def jordan_cholesky(n: int, grid: Grid | None = None, dtype=torch.float64):
    """J^T J for the Jordan block J with eigenvalue 2 and unit
    superdiagonal (``El::JordanCholesky``): tridiagonal with diagonal
    (4, 5, 5, ..., 5) and off-diagonals 2."""
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        diag = _where(i == j, _where(i == 0, 4.0, 5.0), 0.0)
        off = _where((i - j).abs() == 1, 2.0, 0.0)
        return diag + off

    return _fill(A, f)


def lauchli(n: int, mu: float | None = None, grid: Grid | None = None,
            dtype=torch.float64):
    """(n+1) x n [ones_row; mu I] (``El::Lauchli``), the classic
    normal-equations ill-conditioning example."""
    mu = mu if mu is not None else math.sqrt(np.finfo(np.float64).eps)
    A = _empty(n + 1, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(i == 0, 1.0,
                                        _where(i == j + 1, mu, 0.0)))


def legendre(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Jacobi (tridiagonal) matrix of the Legendre recurrence
    (``El::Legendre``): beta_k = 1/(2 sqrt(1 - (2k)^{-2})) off-diagonal."""
    A = _empty(n, n, grid or default_grid(), dtype)

    def f(i, j):
        k = torch.maximum(i, j).to(dtype)        # = min+1 on the off-diag
        beta = 0.5 / torch.sqrt(1.0 - 1.0 / (4.0 * k * k))
        return _where((i - j).abs() == 1, beta, 0.0)

    return _fill(A, f)


def lotkin(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Hilbert matrix with the first row set to ones (``El::Lotkin``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == 0, 1.0, 1.0 / (i.to(dtype) + j.to(dtype) + 1.0)))


def one_two_one(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Tridiagonal (1, 2, 1) (``El::OneTwoOne``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: _where(
        i == j, 2.0, _where((i - j).abs() == 1, 1.0, 0.0)))


def _log_eulerian(n: int) -> np.ndarray:
    """log A(n, k) for k = 0..n-1 (Eulerian numbers: permutations of n with
    k descents), via ``A(m,k) = (k+1) A(m-1,k) + (m-k) A(m-1,k-1)`` run in
    log space.  O(n^2) host-side, vectorized per row."""
    la = np.zeros(1)                              # A(1, 0) = 1
    for m in range(2, n + 1):
        prev_k = np.concatenate([la, [-np.inf]])       # A(m-1, k)
        prev_k1 = np.concatenate([[-np.inf], la])      # A(m-1, k-1)
        k = np.arange(m, dtype=np.float64)
        la = np.logaddexp(np.log(k + 1) + prev_k,
                          np.log(m - k) + prev_k1)
    return la


def riffle(n: int, grid: Grid | None = None, dtype=torch.float64):
    """Gilbert-Shannon-Reeds riffle-shuffle transition matrix on descent
    classes (``El::Riffle``):

        P[i,j] = 2^{-n} C(n+1, 2i-j+1) A(n,j) / A(n,i)

    with A(n,k) the Eulerian numbers: row-stochastic, with stationary
    distribution ``A(n,i)/n!``."""
    grid = grid or default_grid()
    A = _empty(n, n, grid, dtype)
    lg = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, n + 2)))])
    lgj = torch.as_tensor(lg, device=grid.device)
    lA = torch.as_tensor(_log_eulerian(n) if n > 0 else np.zeros(1),
                         device=grid.device)

    def f(i, j):
        k = 2 * (i + 1) - (j + 1)
        valid = (k >= 0) & (k <= n + 1)
        kc = k.clamp(0, n + 1)
        logbin = lgj[n + 1] - lgj[kc] - lgj[n + 1 - kc]
        return _where(valid, torch.exp(logbin - n * math.log(2.0)
                                       + _take(lA, j) - _take(lA, i)), 0.0)

    return _fill(A, f)


def ris(n: int, grid: Grid | None = None, dtype=torch.float64):
    """R[i,j] = 0.5/(n - i - j - 0.5) (``El::Ris``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: 0.5 / (n - i.to(dtype) - j.to(dtype) - 0.5))


def whale(n: int, grid: Grid | None = None, dtype=torch.complex128):
    """The "whale" pseudospectrum example (Trefethen-Embree): banded
    Toeplitz with symbol z^{-4} + (3+2i) z^{-3} - (1+2i) z^{-2} + z^{-1}
    + 10 z + (3+i) z^2 + 4 z^3 + i z^4 (``El::Whale``)."""
    coef = {-4: 1.0, -3: 3.0 + 2.0j, -2: -(1.0 + 2.0j), -1: 1.0,
            1: 10.0, 2: 3.0 + 1.0j, 3: 4.0, 4: 1.0j}
    # A[i,j] = a_{i-j}: positive symbol powers sit BELOW the diagonal
    col = np.zeros(n, np.complex128)
    row = np.zeros(n, np.complex128)
    for off, v in coef.items():
        if off >= 0 and off < n:
            col[off] = v
        elif off < 0 and -off < n:
            row[-off] = v
    return toeplitz(col, row, grid=grid, dtype=dtype)


def hatano_nelson(n: int, shift: float = 0.0, g: float = 0.5,
                  periodic: bool = True, grid: Grid | None = None,
                  dtype=torch.float64, seed: int = 0):
    """Hatano-Nelson non-Hermitian localization model
    (``El::HatanoNelson``): random diagonal + e^{+-g} hopping."""
    grid = grid or default_grid()
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.uniform(-1, 1, n) - shift,
                        device=grid.device).to(dtype)
    A = _empty(n, n, grid, dtype)
    eg, emg = math.exp(g), math.exp(-g)

    def f(i, j):
        diag = _where(i == j, _take(d, i), 0.0)
        up = _where(j == i + 1, eg, 0.0)
        dn = _where(j == i - 1, emg, 0.0)
        out = diag + up + dn
        if periodic and n > 2:
            out = out + (_where((i == n - 1) & (j == 0), eg, 0.0)
                         + _where((i == 0) & (j == n - 1), emg, 0.0))
        return out

    return _fill(A, f)


def three_valued(m: int, n: int | None = None, p: float = 2.0 / 3.0,
                 grid: Grid | None = None, dtype=torch.float64,
                 seed: int = 0):
    """Random {-1, 0, +1} entries: 0 w.p. 1-p, +-1 w.p. p/2 each
    (``El::ThreeValued``), host-seeded."""
    n = n if n is not None else m
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(m, n))
    vals = np.where(u < p / 2, -1.0, np.where(u < p, 1.0, 0.0))
    return from_global(vals.astype(_numpy_dtype(dtype)), MC, MR,
                       grid=grid or default_grid())


def kms(n: int, rho: float = 0.5, grid: Grid | None = None,
        dtype=torch.float64):
    """Kac-Murdock-Szego Toeplitz K[i,j] = rho^{|i-j|} (``El::KMS``)."""
    A = _empty(n, n, grid or default_grid(), dtype)
    return _fill(A, lambda i, j: rho ** (i - j).abs().to(dtype))
