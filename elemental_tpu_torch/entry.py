"""Driver entry points of the port (the twin of ``__graft_entry__.py``).

``entry(device=None)``        -- ``(fn, args)`` of the flagship forward
                                 step: ``hpd_solve`` (blocked Cholesky +
                                 two sweeps) at n = 256, nb = 64, on a 1x1
                                 grid (``cuda`` unless a device is given).
``dryrun_multichip(n, device=None)`` -- the distributed surface on a
                                 near-square virtual grid of ``n`` ranks,
                                 once, on tiny shapes: HPD solve, LU
                                 solve, QR least squares and the Hermitian
                                 eigensolver, each with a residual check.
"""
from __future__ import annotations

import math

import numpy as np

from .core.dist import MC, MR
from .core.distmatrix import from_global, to_global
from .core.grid import Grid
from .lapack.cholesky import hpd_solve
from .lapack.lu import lu_solve
from .lapack.qr import least_squares
from .lapack.spectral import herm_eig


def _spd(n, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n)).astype(dtype)
    return (G @ G.T) / n + n * np.eye(n, dtype=dtype)


def _near_square_height(p: int) -> int:
    r = math.isqrt(p)
    while p % r:
        r -= 1
    return r


def entry(device=None):
    """``(fn, (A, B))``: ``fn(A, B)`` is ``hpd_solve(A, B, nb=64)`` on a
    256 x 256 SPD ``A`` and 8 right-hand sides, float32."""
    grid = Grid(device=device)
    n, nrhs, nb = 256, 8, 64
    A = from_global(_spd(n), MC, MR, grid=grid)
    B = from_global(np.random.default_rng(1).normal(size=(n, nrhs))
                    .astype(np.float32), MC, MR, grid=grid)

    def fn(a, b):
        return hpd_solve(a, b, nb=nb)

    return fn, (A, B)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the distributed surface once on a near-square r x c virtual grid
    of ``n_devices`` ranks (``cuda`` unless a device is given), with the
    shapes and residual checks of ``__graft_entry__.dryrun_multichip``;
    prints one line.  Raises ``AssertionError`` when a residual fails."""
    r = _near_square_height(n_devices)
    grid = Grid(r, n_devices // r, device=device)
    n, nrhs, nb = 32, 4, 8
    rng = np.random.default_rng(1)
    F = _spd(n)
    ones = np.ones((n, nrhs), np.float32)
    A = from_global(F, MC, MR, grid=grid)
    B = from_global(ones, MC, MR, grid=grid)

    def glob(X):
        return to_global(X).cpu().numpy()

    # 1. Cholesky + triangular sweeps
    X = hpd_solve(A, B, nb=nb)
    r1 = float(np.linalg.norm(F @ glob(X) - 1.0) / np.linalg.norm(ones))
    if not r1 < 1e-2:
        raise AssertionError(f"hpd_solve residual {r1}")

    # 2. LU with partial pivoting
    M = rng.normal(size=(n, n)).astype(np.float32)
    X2 = lu_solve(from_global(M, MC, MR, grid=grid), B, nb=nb)
    r2 = float(np.linalg.norm(M @ glob(X2) - 1.0) / np.linalg.norm(ones))
    if not r2 < 1e-2:
        raise AssertionError(f"lu_solve residual {r2}")

    # 3. QR least squares (tall)
    T = rng.normal(size=(2 * n, n)).astype(np.float32)
    Bt = from_global(np.ones((2 * n, nrhs), np.float32), MC, MR, grid=grid)
    X3 = least_squares(from_global(T, MC, MR, grid=grid), Bt, nb=nb)
    xn = np.linalg.lstsq(T.astype(np.float64), np.ones((2 * n, nrhs)),
                         rcond=None)[0]
    r3 = float(np.linalg.norm(glob(X3) - xn) / max(np.linalg.norm(xn), 1))
    if not r3 < 1e-2:
        raise AssertionError(f"least_squares error {r3}")

    # 4. Hermitian eigensolver (tridiagonal reduction + back-transform)
    w, Z = herm_eig(A, nb=nb)
    Zg = glob(Z)
    r4 = float(np.linalg.norm(F @ Zg - Zg @ np.diag(w.cpu().numpy()))
               / np.linalg.norm(F))
    if not r4 < 1e-2:
        raise AssertionError(f"herm_eig residual {r4}")

    print(f"dryrun_multichip({n_devices}) OK on grid {grid}: "
          f"hpd={r1:.2e} lu={r2:.2e} lstsq={r3:.2e} eig={r4:.2e}")
