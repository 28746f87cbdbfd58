"""The port's entry twin (``elemental_tpu_torch.entry``) against
``__graft_entry__``: ``entry()`` gives the same flagship step (hpd_solve
at n = 256, nb = 64, float32) and ``dryrun_multichip(8)`` runs the four
distributed steps with their residual checks on a virtual 2x4 grid."""
import numpy as np

import __graft_entry__ as ge
import elemental_tpu as el
import elemental_tpu_torch as et


def test_entry_matches_the_jax_entry():
    fn, (A, B) = et.entry.entry(device="cpu")
    assert A.gshape == (256, 256) and B.gshape == (256, 8)
    assert A.grid == et.Grid(device="cpu")
    jfn, (jA, jB) = ge.entry()
    np.testing.assert_array_equal(et.to_global(A).numpy(),
                                  np.asarray(el.to_global(jA)))
    np.testing.assert_array_equal(et.to_global(B).numpy(),
                                  np.asarray(el.to_global(jB)))
    X = et.to_global(fn(A, B)).numpy()
    jX = np.asarray(el.to_global(jfn(jA, jB)))
    np.testing.assert_allclose(X, jX, rtol=0, atol=1e-5 * np.abs(jX).max())
    F = et.to_global(A).numpy().astype(np.float64)
    res = np.linalg.norm(F @ X - et.to_global(B).numpy()) \
        / (np.linalg.norm(F) * np.linalg.norm(X))
    assert res < 1e-6


def test_dryrun_multichip_on_the_cpu(capsys):
    et.entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(8) OK on grid Grid(2x4, cpu)" in out
    et.entry.dryrun_multichip(4, device="cpu")
    assert "Grid(2x2, cpu)" in capsys.readouterr().out
