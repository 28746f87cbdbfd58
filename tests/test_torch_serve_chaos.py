"""The port's chaos matrix against the JAX package's: each cell's
``chaos_report/v1`` outcome classes (verdict, per-request outcomes,
fired events, ok count, violations; the qr column's abft / health
records) equal on the same seeded workloads and fault plans, the fleet
column's cells equal under the virtual clock (the grid-loss cell's
flight dump included), and the replays identical."""
import numpy as np
import pytest

import elemental_tpu.serve.chaos as jchaos
import elemental_tpu_torch.serve as tserve
import elemental_tpu_torch.serve.chaos as tchaos

from .torch_serve_common import (cpu_default_grid, jax_grid,  # noqa: F401
                                 port_grid, same)

#: the cell keys that classify outcomes (``chaos_matrix``'s grading)
CLASS_KEYS = ("kind", "target", "mode", "op", "requests", "ok", "fired",
              "outcomes", "verdict", "violations", "column", "batches",
              "flushed", "health_flags", "abft", "residual")


def _classes(cell: dict) -> dict:
    return {k: cell[k] for k in CLASS_KEYS if k in cell}


def _both(fn, *a, **kw):
    return (_classes(fn(jchaos, jax_grid())(*a, **kw)[0]),
            _classes(fn(tchaos, port_grid())(*a, **kw)[0]))


def _cell(mod, grid):
    return lambda **kw: mod.run_cell(grid, **kw)


@pytest.mark.parametrize("target,kind,mode", [
    ("redistribute", k, "oneshot") for k in ("bitflip", "scale", "nan")
] + [("compute", k, m) for k in ("bitflip", "scale", "nan")
     for m in ("oneshot", "persistent")])
def test_matrix_cell_outcomes_equal(target, kind, mode):
    j, t = _both(_cell, kind=kind, target=target, mode=mode,
                 call=2 if target == "redistribute" else 0)
    assert same(t, j) == []
    assert t["fired"] > 0 and t["violations"] == []


@pytest.mark.parametrize("kind", ["bitflip", "scale", "nan"])
def test_persistent_redistribute_cells_match_the_jax_outcomes(kind):
    kw = dict(kind=kind, target="redistribute", mode="persistent", call=2)
    j = _classes(jchaos.run_cell(jax_grid(), **kw)[0])
    cell, plan, svc = tchaos.run_cell(port_grid(), **kw)
    assert same(_classes(cell), j) == []
    assert cell["verdict"] == "surfaced" and cell["fired"] > 0
    assert cell["violations"] == [] and cell["ok"] == 0
    assert len(svc.results) == cell["requests"] == 4
    for doc in svc.results.values():
        assert doc["status"] == "failed"
        assert doc["certificate"]["failing_phase"] is not None


@pytest.mark.parametrize("kind", ["bitflip", "scale", "nan"])
def test_qr_column_cell_outcomes_equal(kind):
    j, t = _both(lambda m, g: (lambda **kw: m.run_qr_cell(g, **kw)),
                 kind=kind, target="compute")
    assert same(t, j, rtol=1e-6, atol=1e-14) == []
    assert t["verdict"] == "absorbed" and t["abft"]["recompute_count"] == 1


def test_async_column_and_hard_stop_outcomes_equal():
    for kind, mode in (("nan", "oneshot"), ("scale", "persistent")):
        j, t = _both(lambda m, g: (lambda **kw: m.run_async_cell(g, **kw)),
                     kind=kind, mode=mode, requests=8)
        assert same(t, j) == []
    j, t = _both(lambda m, g: (
        lambda **kw: m.run_async_shutdown_cell(g, **kw)), requests=12)
    assert same(t, j) == [] and t["verdict"] == "isolated"


def test_fleet_cells_equal_under_the_virtual_clock():
    jg, _ = jchaos.run_fleet_grid_loss_cell()
    tg, fleet = tchaos.run_fleet_grid_loss_cell()
    assert same(tg, jg) == []
    assert tg["verdict"] == "isolated" and tg["flight"] is not None
    js, _ = jchaos.run_fleet_saturation_cell()
    ts, _ = tchaos.run_fleet_saturation_cell()
    assert same(ts, js) == []
    assert sum(w["sheds"] for w in ts["waves"]) > 0


def test_replays_are_identical_and_the_port_matrix_is_clean():
    assert tserve.replay_identical(port_grid())
    assert tserve.fleet_replay_identical()
    report = tserve.chaos_matrix(port_grid(2, 2))
    assert report["schema"] == "chaos_report/v1" == tserve.CHAOS_SCHEMA
    assert report["ok"] and report["vacuous_cells"] == 0
    assert report["grid"] == [2, 2] and len(report["cells"]) == 25
    np.testing.assert_array_equal(
        tserve.build_workload("hpd", 8, 2, 2, 5)[1][0],
        jchaos.build_workload("hpd", 8, 2, 2, 5, dtype=np.float64)[1][0])
