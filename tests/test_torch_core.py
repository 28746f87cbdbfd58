"""The port's core layout against the JAX package: stacked storage built by
``elemental_tpu_torch.from_global`` is bit-equal to ``elemental_tpu``'s,
``to_global`` round-trips, views and view updates give bit-equal storage,
and storage carried across packages (``from_storage`` /
``storage_numpy``) round-trips.  Inputs are numpy arrays from a seed,
handed to both packages."""
import jax
import numpy as np
import pytest
import torch

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.core.view import update_view as jax_update_view
from elemental_tpu.core.view import view as jax_view

GRIDS = [(1, 1), (2, 2), (2, 4)]
PAIRS = [("MC", "MR"), ("STAR", "STAR"), ("VC", "STAR"), ("STAR", "VR"),
         ("STAR", "MR"), ("MC", "STAR"), ("STAR", "MC"), ("MD", "STAR"),
         ("CIRC", "CIRC")]


def jgrid(r, c):
    return el.Grid(jax.devices()[: r * c], height=r)


def tgrid(r, c):
    return et.Grid(r, c, device="cpu")


def _mat(m, n, seed=0):
    return np.random.default_rng(seed).normal(size=(m, n))


def _cases():
    for rc in GRIDS:
        for cd, rd in PAIRS:
            for align in (0, 1):
                if align and ("MD" in (cd, rd) or cd == "CIRC"):
                    continue       # MD/CIRC take no alignment
                yield pytest.param(rc, cd, rd, align,
                                   id=f"{rc[0]}x{rc[1]}-{cd},{rd}-a{align}")


@pytest.mark.parametrize("rc,cd,rd,align", list(_cases()))
def test_from_global_storage_bit_equal(rc, cd, rd, align):
    F = _mat(13, 10, seed=hash((cd, rd)) % 97)
    jA = el.from_global(F, el.Dist[cd], el.Dist[rd], jgrid(*rc),
                        calign=align, ralign=align)
    tA = et.from_global(F, et.Dist[cd], et.Dist[rd], tgrid(*rc),
                        calign=align, ralign=align)
    want = np.asarray(jA.local)
    got = et.storage_numpy(tA)
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(et.to_global(tA).numpy(), F)
    # storage carried across packages round-trips bit for bit
    back = et.from_storage(want, tA.gshape, tA.cdist, tA.rdist, tA.calign,
                           tA.ralign, tA.grid)
    assert np.array_equal(et.storage_numpy(back), want)
    assert np.array_equal(et.to_global(back).numpy(), F)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("rows,cols", [((0, 8), (4, 8)), ((4, 11), (0, 12)),
                                       ((8, 11), (8, 12))])
def test_view_and_update_view_bit_equal(rc, rows, cols):
    F = _mat(11, 12, seed=3)
    P = _mat(rows[1] - rows[0], cols[1] - cols[0], seed=4)
    jA = el.from_global(F, el.MC, el.MR, jgrid(*rc))
    tA = et.from_global(F, et.MC, et.MR, tgrid(*rc))
    jv = jax_view(jA, rows=rows, cols=cols)
    tv = et.view(tA, rows=rows, cols=cols)
    assert tv.gshape == jv.gshape
    assert np.array_equal(et.storage_numpy(tv), np.asarray(jv.local))
    jP = el.from_global(P, el.MC, el.MR, jgrid(*rc))
    tP = et.from_global(P, et.MC, et.MR, tgrid(*rc))
    ju = jax_update_view(jA, jP, rows=rows, cols=cols)
    before = tA.local.clone()
    tu = et.update_view(tA, tP, rows=rows, cols=cols)
    assert np.array_equal(et.storage_numpy(tu), np.asarray(ju.local))
    assert torch.equal(tA.local, before)          # functional update


def test_from_storage_rejects_wrong_shape():
    with pytest.raises(ValueError, match="storage shape"):
        et.from_storage(np.zeros((3, 3)), (4, 4), et.MC, et.MR,
                        grid=tgrid(2, 2))


def test_grid_defaults_to_cuda():
    g = et.Grid()
    assert (g.height, g.width) == (1, 1)
    assert g.device == torch.device("cuda", 0)
    assert et.Grid(2, 4, device="cpu").size == 8


def test_blocksize_stack_feeds_the_policy():
    from elemental_tpu_torch.tune.policy import blocksize_policy
    assert et.blocksize() == 128
    with et.blocksize_scope(24):
        assert blocksize_policy(None, 8, 100) == 24
        assert blocksize_policy(None, 16, 100) == 32    # rounded to grain
    assert blocksize_policy(None, 1, 40) == 40          # clamped to extent
    with pytest.raises(RuntimeError, match="underflow"):
        et.pop_blocksize()
    # an unresolved 'auto' reaching the policy is a driver bug: TypeError,
    # as in the JAX package
    with pytest.raises(TypeError, match="unresolved"):
        blocksize_policy("auto", 1, 40)
