"""Shared helpers of the serving tests of the PyTorch port
(``tests/test_torch_serve_*.py``): the same seeded numpy inputs go to
``elemental_tpu.serve`` and ``elemental_tpu_torch.serve``, on a 1x1 JAX
grid and a CPU port grid, under the same injected clock."""
import math

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

#: solutions of the two packages' batched library solves agree to this
#: (f64; the routines are not bit-equal)
X_TOL = 1e-12


class FakeClock:
    """A manually advanced clock (``tests/serve/conftest.py``'s): both
    packages read the same virtual time."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t

    def sleep(self, dt: float) -> None:
        self.advance(dt)


def spd(rng, n: int) -> np.ndarray:
    F = rng.normal(size=(n, n))
    return F @ F.T / n + n * np.eye(n)


def diag_dom(rng, n: int) -> np.ndarray:
    return rng.normal(size=(n, n)) + n * np.eye(n)


def jax_grid():
    """The JAX reference grid: 1x1 (XLA's collective rendezvous can abort
    a busy process on the 2x4 mesh)."""
    return el.Grid(jax.devices()[:1])


def port_grid(r: int = 1, c: int = 1):
    return et.Grid(r, c, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def cpu_default_grid():
    """The port's default grid (where a fleet's ranks, ``build_workload``'s
    dtype and ``donation_safe`` look) on the CPU for the module."""
    from elemental_tpu_torch.core import grid as grid_mod
    prev = grid_mod._default_grid
    et.set_default_grid(port_grid())
    yield
    et.set_default_grid(prev)


def same(a, b, path="doc", rtol=1e-12, atol=1e-12):
    """Recursive equality of two documents: exact for everything but
    floats, which agree to ``rtol``/``atol`` (residuals, health scales:
    the two packages' library routines round differently).  Returns a
    list of the paths that differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        for k in a:
            out += same(a[k], b[k], f"{path}.{k}", rtol, atol)
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: len {len(a)} != {len(b)}"]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += same(x, y, f"{path}[{i}]", rtol, atol)
        return out
    if isinstance(a, bool) or isinstance(b, bool):
        return [] if a == b else [f"{path}: {a!r} != {b!r}"]
    if isinstance(a, (float, np.floating)) or isinstance(b, (float,
                                                            np.floating)):
        if a is None or b is None:
            return [f"{path}: {a!r} != {b!r}"]
        fa, fb = float(a), float(b)
        if math.isnan(fa) and math.isnan(fb):
            return []
        if fa == fb or abs(fa - fb) <= atol + rtol * max(abs(fa), abs(fb)):
            return []
        return [f"{path}: {fa!r} != {fb!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]
