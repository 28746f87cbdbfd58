"""The port's lattice tier (``lattice/core.py``) and IO layer
(``io/core.py``) against ``elemental_tpu``, on the inputs of
``tests/lattice/test_lll.py`` and ``tests/core/test_io_mm.py`` (made from
the same seeds with numpy).

* ``lll`` (plain and deep), ``is_lll_reduced`` and ``shortest_vector``:
  the reduced basis, the unimodular U and the info EXACTLY equal to the
  JAX package's (the host sweep is the same float64 code);
* ``'shards'`` checkpoints written by either package restore in the
  other, bit-equal both ways, on 1x1, 2x2 and 2x4 grids (and a grid
  mismatch is refused as in the JAX package); ``'npy'`` files likewise;
* Matrix Market files written by the two packages are byte-equal (dense,
  complex, sparse), and each package reads the other's;
* ``print_matrix`` prints the same text; ``display`` / ``spy`` write
  their images (when matplotlib is there).
"""
import io

import jax
import numpy as np
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et

GRIDS = [(1, 1), (2, 2), (2, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]


def _jgrid(r=1, c=1):
    return el.Grid(jax.devices()[:r * c], height=r)


def _tgrid(r=1, c=1):
    return et.Grid(r, c, device="cpu")


def _jd(F, rc=(1, 1)):
    return el.from_global(np.asarray(F), el.MC, el.MR, grid=_jgrid(*rc))


def _td(F, rc=(1, 1)):
    return et.from_global(np.asarray(F), et.MC, et.MR, grid=_tgrid(*rc))


def _basis(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    B = rng.integers(lo, hi, (n, n)).astype(np.float64)
    while abs(np.linalg.det(B)) < 1:
        B = rng.integers(lo, hi, (n, n)).astype(np.float64)
    return B


def _knapsack(n=6, seed=1):
    rng = np.random.default_rng(seed)
    big = 1000
    a = rng.integers(100, 500, n)
    x = rng.integers(0, 2, n)
    B = np.zeros((n + 1, n + 1))
    B[:n, :n] = np.eye(n)
    B[n, :n] = big * a
    B[n, n] = -big * int(a @ x)
    return B


@pytest.mark.parametrize("rc", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("case", ["identities", "knapsack", "deep", "capped"])
def test_lll_matches_jax_exactly(case, rc):
    B = _knapsack() if case == "knapsack" else _basis(
        2 if case == "deep" else 0, 6 if case == "deep" else 8,
        -20 if case == "deep" else -30, 20 if case == "deep" else 30)
    kw = {"deep": {"deep": True}, "capped": {"max_sweeps": 0}}.get(case, {})
    R, U, info = et.lll(_td(B, rc), **kw)
    Rj, Uj, ij = el.lll(_jd(B), **kw)
    assert np.array_equal(et.to_global(R).numpy(), np.asarray(el.to_global(Rj)))
    assert np.array_equal(et.to_global(U).numpy(), np.asarray(el.to_global(Uj)))
    assert info == ij
    assert et.is_lll_reduced(R) == el.is_lll_reduced(Rj) \
        == (case != "capped")
    Rg, Ug = et.to_global(R).numpy(), et.to_global(U).numpy()
    assert np.allclose(Rg, B @ Ug, atol=1e-6)
    assert abs(abs(np.linalg.det(Ug)) - 1.0) < 1e-6
    if case == "knapsack":
        assert np.linalg.norm(Rg, axis=0).min() <= np.sqrt(6) + 1e-6


def test_shortest_vector_matches_jax():
    B = _basis(2, 6, -20, 20)
    v, nv = et.shortest_vector(_td(B, (2, 2)))
    vj, nvj = el.shortest_vector(_jd(B))
    assert np.array_equal(v, np.asarray(vj)) and nv == nvj
    coef = np.linalg.solve(B, v)
    assert np.allclose(coef, np.round(coef), atol=1e-6)


@pytest.mark.parametrize("rc", GRIDS, ids=IDS)
def test_shard_checkpoints_restore_across_packages(rc, tmp_path):
    rng = np.random.default_rng(3)
    F = rng.normal(size=(13, 9))
    G = rng.normal(size=(7, 20)).astype(np.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    el.checkpoint(jdir, A=_jd(F, rc), B=_jd(G, rc))
    et.checkpoint(tdir, A=_td(F, rc), B=_td(G, rc))
    from_jax = et.restore(jdir, ["A", "B"], grid=_tgrid(*rc))
    from_torch = el.restore(tdir, ["A", "B"], grid=_jgrid(*rc))
    for name, M in (("A", F), ("B", G)):
        t, j = from_jax[name], from_torch[name]
        assert t.dtype == et.from_global(M, et.MC, et.MR, _tgrid()).dtype
        assert np.array_equal(et.storage_numpy(t),
                              np.asarray(_jd(M, rc).local))
        assert np.array_equal(np.asarray(j.local),
                              et.storage_numpy(_td(M, rc)))
        assert t.gshape == j.gshape and t.dist == (et.MC, et.MR)
    with pytest.raises(ValueError):
        et.restore(jdir, ["A"], grid=_tgrid(4, 1) if rc != (4, 1)
                   else _tgrid(1, 1))
    # the global 'npy' format
    p_t, p_j = str(tmp_path / "t"), str(tmp_path / "j")
    et.write_matrix(_td(F, rc), p_t)
    el.write_matrix(_jd(F, rc), p_j)
    assert open(p_t + ".npy", "rb").read() == open(p_j + ".npy", "rb").read()
    back = et.read_matrix(p_j, grid=_tgrid(*rc))
    assert np.array_equal(et.to_global(back).numpy(), F)


def _sparse_coo(seed=2, m=20, n=14, nnz=60, cplx=False):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    if cplx:
        vals = vals + 1j * rng.normal(size=nnz)
    return rows, cols, vals, m, n


@pytest.mark.parametrize("kind", ["dense", "complex", "sparse",
                                  "sparse_complex"])
def test_matrix_market_files_are_byte_equal(kind, tmp_path):
    rng = np.random.default_rng(0)
    pt, pj = str(tmp_path / "t.mtx"), str(tmp_path / "j.mtx")
    if kind in ("dense", "complex"):
        F = rng.normal(size=(9, 5))
        if kind == "complex":
            F = F + 1j * rng.normal(size=(9, 5))
        et.write_matrix_market(_td(F, (2, 2)), pt, comment="test")
        el.write_matrix_market(_jd(F, (2, 2)), pj, comment="test")
        ref = F
    else:
        rows, cols, vals, m, n = _sparse_coo(cplx=kind == "sparse_complex")
        et.write_matrix_market(et.dist_sparse_from_coo(
            rows, cols, vals, m, n, grid=_tgrid(2, 2)), pt)
        el.write_matrix_market(el.dist_sparse_from_coo(
            rows, cols, vals, m, n, grid=_jgrid(2, 2)), pj)
        ref = np.zeros((m, n), vals.dtype)
        np.add.at(ref, (rows, cols), vals)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    B = et.read_matrix_market(pj, grid=_tgrid(2, 2))
    dense = B.to_dense() if isinstance(B, et.DistSparseMatrix) else B
    assert np.allclose(et.to_global(dense).numpy(), ref)
    if kind.startswith("sparse"):
        Bj = el.read_matrix_market(pt, grid=_jgrid(2, 2))
        assert np.array_equal(np.asarray(Bj.vals), B.vals.numpy())
        Bd = et.read_matrix_market(pt, grid=_tgrid(), sparse=False)
        assert np.allclose(et.to_global(Bd).numpy(), ref)


@pytest.mark.parametrize("symm", ["symmetric", "hermitian",
                                  "skew-symmetric", "pattern"])
def test_matrix_market_reader_expands_like_jax(symm, tmp_path):
    p = str(tmp_path / "s.mtx")
    field = {"hermitian": "complex", "pattern": "pattern"}.get(symm, "real")
    with open(p, "w") as f:
        head = "general" if symm == "pattern" else symm
        f.write(f"%%MatrixMarket matrix coordinate {field} {head}\n% c\n")
        if field == "complex":
            f.write("3 3 3\n1 1 2.0 0.0\n2 1 -1.0 0.5\n3 2 -1.0 -2.0\n")
        elif field == "pattern":
            f.write("3 3 3\n1 1\n2 1\n3 2\n")
        else:
            f.write("3 3 3\n1 1 2.0\n2 1 -1.0\n3 2 -1.5\n")
    got = et.to_global(et.read_matrix_market(p, grid=_tgrid(), sparse=False))
    want = el.to_global(el.read_matrix_market(p, grid=_jgrid(), sparse=False))
    assert np.array_equal(got.numpy(), np.asarray(want))
    q = str(tmp_path / "a.mtx")                    # packed dense array
    with open(q, "w") as f:
        f.write("%%MatrixMarket matrix array real symmetric\n3 3\n"
                "1\n2\n3\n4\n5\n6\n")
    assert np.array_equal(
        et.to_global(et.read_matrix_market(q, grid=_tgrid())).numpy(),
        np.asarray(el.to_global(el.read_matrix_market(q, grid=_jgrid()))))
    with open(q, "w") as f:
        f.write("not a matrix market file\n")
    with pytest.raises(ValueError):
        et.read_matrix_market(q)


def test_print_matrix_matches_jax():
    F = np.random.default_rng(4).normal(size=(5, 4))
    st, sj = io.StringIO(), io.StringIO()
    et.print_matrix(_td(F, (2, 2)), "A", stream=st)
    el.print_matrix(_jd(F, (2, 2)), "A", stream=sj)
    assert st.getvalue() == sj.getvalue()


def test_display_and_spy(tmp_path):
    pytest.importorskip("matplotlib")
    F = np.random.default_rng(5).normal(size=(12, 9))
    F[np.abs(F) < 0.5] = 0
    out = et.display(_td(F, (2, 2)), "A", path=str(tmp_path / "a.png"))
    assert out.endswith("a.png") and (tmp_path / "a.png").stat().st_size
    out = et.spy(_td(F), path=str(tmp_path / "s.png"))
    assert (tmp_path / "s.png").stat().st_size
    rows, cols, vals, m, n = _sparse_coo()
    S = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=_tgrid(2, 2))
    assert et.spy(S, path=str(tmp_path / "ss.png")).endswith("ss.png")
    assert et.display(S, path=str(tmp_path / "sd.png")).endswith("sd.png")
