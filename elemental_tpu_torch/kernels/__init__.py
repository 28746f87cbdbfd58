"""The port's hand-written Hopper kernels and their dispatch.

PyTorch port of ``elemental_tpu/kernels/__init__.py``: the
``panel_impl`` knob of the drivers turns into a :class:`PanelPlan`, and
each call site asks ``plan.use_kernel(dtype)`` -- a static gate on dtype
(the kernel has no size gate: see ``common.py``).

* :func:`potrf_inv` -- lower Cholesky factor + inverse of a diagonal
  block, a CUDA kernel for ``sm_90a`` (``csrc/potrf_inv.cu``), twin of
  :func:`potrf_inv_reference` (residual-bounded).

``panel_impl`` values: ``'torch'`` (the plain PyTorch path, the explicit
counterpart of the JAX package's ``'xla'``), ``'kernel'`` (the
hand-written kernel, the counterpart of ``'pallas'``), and ``None`` /
``'auto'``, which resolve by device: ``'kernel'`` for a real dtype on a
CUDA device, ``'torch'`` on the CPU.  A complex dtype never reaches the
kernel: it resolves to ``'torch'`` with ``source='complex-torch'``.  On a
CPU tensor the kernel wrapper itself runs the plain version, so the CPU
tests drive the same call sites.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .chol_panel import potrf_inv, potrf_inv_reference

#: implementations the ``panel_impl`` knob enumerates ('auto' and None
#: resolve to one of these by device)
PANEL_IMPLS = ("torch", "kernel")


@dataclass(frozen=True)
class PanelPlan:
    """Resolved panel-implementation choice plus its provenance
    (``source``: 'default', 'explicit' or 'complex-torch')."""

    impl: str = "torch"
    source: str = "default"

    def use_kernel(self, dtype) -> bool:
        """Static per-call-site gate: the kernel for every real dtype,
        whatever the block size; an allocation failure raises."""
        return self.impl == "kernel" and not dtype.is_complex


def resolve_panel(panel_impl=None, *, dtype=None, device=None,
                  source: str | None = None) -> PanelPlan:
    """Turn a ``panel_impl`` knob value into a :class:`PanelPlan` for
    operands of ``dtype`` on ``device``."""
    if panel_impl not in (None, "auto") + PANEL_IMPLS:
        raise ValueError(
            f"panel_impl must be one of {PANEL_IMPLS + ('auto', None)}, "
            f"got {panel_impl!r}")
    if panel_impl in (None, "auto"):
        on_card = device is not None and torch.device(device).type == "cuda"
        impl = "kernel" if on_card else "torch"
        src = "default"
    else:
        impl, src = panel_impl, "explicit"
    if source is not None:
        src = source
    if impl == "kernel" and dtype is not None and dtype.is_complex:
        impl, src = "torch", "complex-torch"
    return PanelPlan(impl=impl, source=src)
