"""The port's public names cover the JAX package's.

For the top-level package and each of its sixteen subpackages, every
public name of ``elemental_tpu`` (``dir()`` without a leading
underscore) must be a public name of the ``elemental_tpu_torch`` twin,
or a submodule of it where the JAX name is a submodule, or one of the
documented exceptions of :data:`EXCEPTIONS` -- names that exist only for
jaxprs, ``shard_map`` or the TPU's VMEM, each with the reason it has no
twin.  One case per package.
"""
import importlib
import importlib.util
import types

import pytest

SUBPACKAGES = ("", "analysis", "blas", "control", "core", "io", "kernels",
               "lapack", "lattice", "matrices", "obs", "optimization",
               "redist", "resilience", "serve", "sparse", "tune")

#: JAX public names with no twin in the port, by subpackage, each with
#: the reason
EXCEPTIONS = {
    "analysis": {
        "PANEL_GATE_COPIES": "the VMEM gate's copy counts; the port's kernels have no size gate",
        "PanelVmemCheck": "a VMEM-gate record; the port's kernels have no size gate",
        "WalkStats": "statistics of a jaxpr walk; the port walks recorded runs (record_walk)",
        "analyze_jaxpr": "takes a closed jaxpr; the port has no jaxprs",
        "check_panel_vmem": "checks the Pallas kernels' VMEM budget, which the CUDA kernels do not have",
        "count_pjit_calls": "counts pjit equations of a jaxpr; the port counts records (count_record_calls)",
        "jaxpr_walk": "the jaxpr walker module; replaced by analysis/record_walk.py",
        "kernel_vmem_bytes": "VMEM bytes of a Pallas kernel; no VMEM on the card",
        "panel_vmem_checks": "VMEM-gate checks of a driver's panels; no VMEM on the card",
    },
    "core": {
        "compat": "jax / shard_map version shims; the port has no JAX",
    },
    "kernels": {
        "LANE": "the TPU's 128-lane tiling",
        "PANEL_VMEM_BUDGET": "the 16 MiB VMEM budget of the Pallas kernels; the CUDA kernels have no size gate",
        "SUBLANE": "the TPU's 8-sublane tiling",
        "interpret_default": "Pallas interpret mode; on a CPU tensor the port runs each kernel's plain version",
        "jnp": "jax.numpy imported into the module; the port imports no JAX",
        "pad_square": "pads a block to the TPU's (8, 128) tiles",
        "pad_tiles": "pads a panel to the TPU's (8, 128) tiles",
        "panel_fits": "the VMEM size gate; the CUDA kernels have no size gate",
        "round_up": "a tiling helper of the VMEM gate",
    },
}


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")}


def _covered(sub: str, name: str, value, port) -> bool:
    if name in _public(port):
        return True
    # a JAX submodule that no import has bound on the port's package yet
    prefix = "elemental_tpu" + (f".{sub}" if sub else "")
    return (isinstance(value, types.ModuleType)
            and value.__name__ == f"{prefix}.{name}"
            and importlib.util.find_spec(
                f"elemental_tpu_torch{'.' + sub if sub else ''}.{name}")
            is not None)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_port_covers_the_jax_public_names(sub):
    suffix = f".{sub}" if sub else ""
    jax_mod = importlib.import_module("elemental_tpu" + suffix)
    port = importlib.import_module("elemental_tpu_torch" + suffix)
    excused = EXCEPTIONS.get(sub, {})
    missing = sorted(n for n in _public(jax_mod) - set(excused)
                     if not _covered(sub, n, getattr(jax_mod, n), port))
    assert not missing, (f"elemental_tpu_torch{suffix} lacks {missing}")
    # an exception names something the JAX package really has
    assert set(excused) <= _public(jax_mod), set(excused) - _public(jax_mod)


def test_top_level_resilience_names_are_the_subpackage_objects():
    import elemental_tpu_torch as et
    for name in ("certified_solve", "HealthMonitor", "last_health_report",
                 "FaultPlan", "FaultSpec", "fault_injection"):
        assert getattr(et, name) is getattr(et.resilience, name), name
