"""The JAX package's live analysis traces, shared by the port's analysis
tests: each (driver, grid) is traced once per process."""
import functools

import jax

import elemental_tpu as el
from elemental_tpu import analysis as jan


def jax_grid(rc):
    return el.Grid(jax.devices()[: rc[0] * rc[1]], height=rc[0])


@functools.cache
def jax_trace(name, rc):
    """``(CommPlan, closed_jaxpr, redist_log)`` of the JAX registry's
    ``name`` on an r x c grid."""
    return jan.trace_driver(name, jax_grid(rc))
