"""The port's hand-written Hopper kernels and their dispatch.

PyTorch port of ``elemental_tpu/kernels/__init__.py``: the
``panel_impl`` knob of the drivers turns into a :class:`PanelPlan`, and
each call site asks ``plan.use_kernel(dtype)`` -- a static gate on dtype
(the kernel has no size gate: see ``common.py``).

* :func:`potrf_inv` -- lower Cholesky factor + inverse of a diagonal
  block, a CUDA kernel for ``sm_90a`` (``csrc/potrf_inv.cu``), twin of
  :func:`potrf_inv_reference` (residual-bounded);
* :func:`lu_panel` -- partial-pivot LU of an (M, nbw) panel, a
  cooperative CUDA kernel for ``sm_90a`` (``csrc/lu_panel.cu``), twin of
  :func:`lu_panel_reference` (same pivots, residual-bounded factor);
* :func:`qr_panel` -- Householder QR of an (M, k) panel with the triangle
  T of its block reflector, a cooperative CUDA kernel for ``sm_90a``
  (``csrc/qr_panel.cu``), twin of :func:`qr_panel_reference` =
  ``_panel_qr`` + ``_larft`` (residual-bounded).

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
from .lu_panel import lu_panel, lu_panel_reference
from .qr_panel import qr_panel, qr_panel_reference

#: implementations the ``panel_impl`` knob enumerates ('auto' and None
#: resolve to one of these by device)
PANEL_IMPLS = ("torch", "kernel")

#: LU panel chunk-width ladder of the plain path (the JAX package's
#: pinned ``DEFAULT_INNERS``); the kernel's chunk is its finest rung
DEFAULT_INNERS = (512, 64)


def default_inners() -> tuple:
    """The LU panel chunk ladder (see :data:`DEFAULT_INNERS`)."""
    return DEFAULT_INNERS


@dataclass(frozen=True)
class PanelPlan:
    """Resolved panel-implementation choice plus its provenance
    (``source``: 'default', 'explicit' or 'complex-torch').  ``inners``
    is the LU chunk ladder the plain path recurses on; the LU kernel
    chunks at :attr:`kernel_inner`."""

    impl: str = "torch"
    inners: tuple = DEFAULT_INNERS
    source: str = "default"

    def use_kernel(self, dtype) -> bool:
        """Static per-call-site gate: the kernel for every real dtype,
        whatever the block size; an allocation failure raises."""
        return self.impl == "kernel" and not dtype.is_complex

    @property
    def kernel_inner(self) -> int:
        """Chunk width of the LU kernel: the finest rung of the ladder
        (the counterpart of the JAX plan's ``pallas_inner``)."""
        return int(self.inners[-1]) if self.inners else 0


def resolve_panel(panel_impl=None, *, dtype=None, device=None, inners=None,
                  source: str | None = None) -> PanelPlan:
    """Turn a ``panel_impl`` knob value into a :class:`PanelPlan` for
    operands of ``dtype`` on ``device``; ``inners`` overrides the LU
    chunk ladder (:data:`DEFAULT_INNERS`)."""
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
    lad = DEFAULT_INNERS if inners is None else tuple(int(i) for i in inners)
    return PanelPlan(impl=impl, inners=lad, source=src)
