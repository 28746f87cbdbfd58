"""Driver call-count parity: for every comm-plan golden (the ``*_abft``
ones of the checksum-guarded drivers included), the port's
``redist_trace`` label counts of the same call on the same grid
(``elemental_tpu_torch.analysis.trace_driver``, which runs the port's
registered twin once) equal the ``redistributes`` map of the JAX
package's live trace of that call (``analysis.drivers.trace_driver``,
which traces under ``jax.make_jaxpr`` and runs no collective).

The live trace, not the golden file, is the reference: where a golden's
map disagrees with it, that is a finding of the JAX package
(ROADMAP section 3), and the golden stays as it is."""
import functools
import json
import pathlib
from collections import Counter

import jax
import pytest

import elemental_tpu as el
import elemental_tpu_torch as et
from elemental_tpu.analysis.drivers import DRIVERS, trace_driver
from elemental_tpu_torch.analysis import drivers as t_drivers

GOLDEN = pathlib.Path(__file__).parent / "golden" / "comm_plans"
NAMES = sorted({p.name.split("__")[0] for p in GOLDEN.glob("*.json")})
GRIDS = [(1, 1), (2, 2)]


@functools.cache
def _jax_labels(name, rc):
    grid = el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])
    _, _, log = trace_driver(name, grid)
    return Counter(rec.label for rec in log)


def test_every_golden_driver_has_a_port_twin():
    assert NAMES and set(NAMES) <= set(DRIVERS) == set(t_drivers.DRIVERS)
    assert {"lu_abft", "cholesky_abft", "qr_abft"} <= set(NAMES)


@pytest.mark.parametrize("rc", GRIDS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_port_counts_equal_the_live_jax_trace(name, rc):
    want = _jax_labels(name, rc)
    _, log, _ = t_drivers.trace_driver(name, et.Grid(*rc, device="cpu"))
    assert Counter(rec.label for rec in log) == want


@pytest.mark.parametrize("name", ["lu_calu", "cholesky_lookahead_commq",
                                  "qr_tsqr"])
def test_golden_maps_that_agree_with_the_live_trace(name):
    """The goldens of this slice's new paths agree with the live trace on
    both grids (so the port, held to the live trace, matches them too)."""
    for rc in GRIDS:
        doc = json.loads((GOLDEN / f"{name}__{rc[0]}x{rc[1]}.json").read_text())
        assert Counter(doc["redistributes"]) == _jax_labels(name, rc)
