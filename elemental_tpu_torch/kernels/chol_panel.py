"""``potrf_inv``: lower Cholesky factor of a diagonal block AND its
inverse -- a hand-written CUDA kernel for Hopper, and its plain version.

Replaces the Pallas kernel ``elemental_tpu/kernels/chol_panel.py::
potrf_inv``.  The kernel (``csrc/potrf_inv.cu``) computes the same
function, ``(L, L^{-1})`` of the block symmetrized from its lower
triangle, in one cooperative launch: right-looking over 32-column
diagonal blocks for the factor and the inverse, worked in place in
``L`` and ``L^{-1}``.  One thread block factors and inverts each
diagonal block (one warp, in registers) while the others apply the
previous block's update in register tiles (look-ahead); every product
tile waits on one round trip to L2.  In float64 the same schedule runs
its products on Hopper's FP64 tensor cores (DMMA) and factors each
diagonal block in two 16-column halves.  The source's header comment
gives the bound and what the design leaves on the table.

:func:`potrf_inv_reference` is the plain PyTorch version (the port of
``elemental_tpu.lapack.cholesky._potrf_inv_impl``).  The wrapper
:func:`potrf_inv` uses it for a CPU tensor; for a CUDA tensor it launches
the kernel or raises -- there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .common import check_launch, load

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int)
_ROWBUF = ([ctypes.c_int], ctypes.c_longlong)
_ENTRY = {torch.float32: "potrf_inv_f32", torch.float64: "potrf_inv_f64"}


def _library():
    sigs = {fn: _SIGNATURE for fn in _ENTRY.values()}
    sigs["potrf_inv_rowbuf"] = _ROWBUF
    return load("potrf_inv", sigs)


def _sym_lower(d):
    """The Hermitian matrix whose lower triangle is ``d``'s."""
    t = torch.tril(d)
    return t + torch.tril(t, -1).mH


def _chol_inv_block(d):
    """Cholesky factor and its inverse of one Hermitian block.  A block
    that is not positive definite yields NaNs (as XLA's potrf does)
    instead of raising."""
    Lkk, info = torch.linalg.cholesky_ex(d)
    Lkk = torch.where(info == 0, Lkk, torch.full_like(Lkk, float("nan")))
    eye = torch.eye(d.shape[0], dtype=d.dtype, device=d.device)
    return Lkk, torch.linalg.solve_triangular(Lkk, eye, upper=False)


def potrf_inv_reference(D, precision=None, bs: int = 512):
    """Blocked lower Cholesky of a (w, w) Hermitian block (lower triangle
    valid) returning ``(L, L^{-1})``: ``bs``-sized diagonal blocks through
    ``cholesky_ex`` + ``solve_triangular``, the panel solve, trailing
    update and inverse assembly as matmuls.  Real and complex dtypes."""
    w = D.shape[0]
    d = _sym_lower(D)
    if w <= bs:
        return _chol_inv_block(d)
    L = torch.zeros_like(d)
    Li = torch.zeros_like(d)
    T = d
    for s in range(0, w, bs):
        e = min(s + bs, w)
        wb = e - s
        Lkk, Likk = _chol_inv_block(_sym_lower(T[:wb, :wb]))
        L[s:e, s:e] = Lkk
        # inverse assembly: Li[s:e, :s] = -Likk @ L[s:e, :s] @ Li[:s, :s]
        if s > 0:
            Li[s:e, :s] = -(Likk @ (L[s:e, :s] @ Li[:s, :s]))
        Li[s:e, s:e] = Likk
        if e < w:
            B21 = T[wb:, :wb] @ Likk.mH
            L[e:, s:e] = B21
            T = T[wb:, wb:] - B21 @ B21.mH
    return L, Li


def potrf_inv(D, precision=None, *, bs: int = 512):
    """``(L, L^{-1})`` of a (w, w) symmetric block whose lower triangle is
    valid.  A CPU tensor goes to :func:`potrf_inv_reference`; a CUDA
    tensor (float32 or float64) launches the kernel, and anything the
    kernel does not take raises.  ``bs`` only caps the columns one warp
    factors at a time inside the kernel's fixed 32-column diagonal blocks
    (``NB`` in the source; at most 16 in float64, ``NB64_BASE``); the
    result is the same function for any ``bs >= 1``, only the rounding
    differs."""
    if D.dim() != 2 or D.shape[0] != D.shape[1]:
        raise ValueError(f"potrf_inv needs a square block, got {tuple(D.shape)}")
    if D.device.type == "cpu":
        return potrf_inv_reference(D, precision, bs)
    if D.device.type != "cuda":
        raise ValueError(f"potrf_inv runs on cpu or cuda, got {D.device}")
    if D.is_complex():
        raise ValueError("the CUDA potrf_inv is real-only; the panel_impl "
                         "dispatch sends complex dtypes to the torch path")
    fn_name = _ENTRY.get(D.dtype)
    if fn_name is None:
        raise ValueError(f"the CUDA potrf_inv takes float32/float64, "
                         f"got {D.dtype}")
    if bs < 1:
        raise ValueError(f"bs must be >= 1, got {bs}")
    w = D.shape[0]
    if w == 0:
        return D.new_empty((0, 0)), D.new_empty((0, 0))
    if D.stride(1) != 1 or D.stride(0) < w:
        D = D.contiguous()
    L = torch.empty((w, w), dtype=D.dtype, device=D.device)
    Li = torch.empty_like(L)
    lib = _library()
    # the next diagonal block's rows of the inverse right-hand sides
    Rb = torch.empty(lib.potrf_inv_rowbuf(w), dtype=D.dtype, device=D.device)
    bar = torch.zeros(2, dtype=torch.int32, device=D.device)  # grid barrier
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream(D.device).cuda_stream
        err = getattr(lib, fn_name)(D.data_ptr(), D.stride(0), w, int(bs),
                                    L.data_ptr(), Li.data_ptr(),
                                    Rb.data_ptr(), bar.data_ptr(), stream)
    check_launch(err, "potrf_inv")
    potrf_inv.launches += 1
    return L, Li


#: kernel launches (one per call that reached the CUDA kernel)
potrf_inv.launches = 0
