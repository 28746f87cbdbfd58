"""``lu_panel``: partial-pivot LU of an (M, nbw) panel -- a hand-written
CUDA kernel for Hopper, and its plain version.

Replaces the Pallas kernel ``elemental_tpu/kernels/lu_panel.py::
lu_panel``.  The kernel (``csrc/lu_panel.cu``) computes the same
function as ``_panel_lu(P, nbw, None, (KERNEL_OUTER_BLOCK, inner))``:
per column a |max| pivot search (first maximum on ties, NaN above every
number), a swap of whole panel rows, a column scale by division and a
rank-1 update inside the current ``inner``-wide chunk; per chunk a
unit-lower solve and one product on the rest of its 128-column outer
block; per outer block its composed row swaps on the panel's other
columns, a solve for U12 and one product of depth 128 on the rest of the
panel.  The pivot search spans the whole panel height, so each chunk
runs as ONE cooperative launch whose thread blocks own slabs of rows
and meet once per column at a split grid barrier: in float32 every
block raises one 64-bit key per column, (|v|, -row) packed in order, by
``atomicMax``, and applies the rest of the column's update while the
others arrive.  The source's header comment gives the bound.

:func:`_panel_lu_unb` and :func:`_panel_lu` are the plain PyTorch
versions (ports of ``elemental_tpu.lapack.lu._panel_lu_unb`` /
``_panel_lu``); :func:`lu_panel_reference` is the latter at the
kernel's two levels.  The wrapper :func:`lu_panel` uses it for a CPU
tensor; for a CUDA tensor it launches the kernel or raises -- there is
no fallback.  No function here calls ``.item()`` or otherwise syncs
with the host.
"""
from __future__ import annotations

import ctypes

import torch

from .common import check_launch, load

#: widest chunk the kernel takes (``CW`` in the source)
KERNEL_MAX_INNER = 64
#: the kernel's outer block (``OB`` in the source): the plain version
#: recurses on ``(KERNEL_OUTER_BLOCK, inner)``
KERNEL_OUTER_BLOCK = 128

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_SCRATCH = ([ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
_ENTRY = {torch.float32: "lu_panel_f32", torch.float64: "lu_panel_f64"}


def _library():
    sigs = {fn: _SIGNATURE for fn in _ENTRY.values()}
    sigs["lu_panel_scratch"] = sigs["lu_panel_words"] = _SCRATCH
    sigs["lu_panel_smem"] = ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
    return load("lu_panel", sigs)


def smem_constants(dtype=torch.float32, device=None) -> dict:
    """The numbers the kernel's slab test reads on the current card:
    ``{"sm_count", "smem_optin", "static_smem"}`` (the static shared
    memory of its in-shared-memory column kernel for ``dtype``).  Builds
    the kernel; CUDA only."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device if device is not None else 0):
        err = lib.lu_panel_smem(int(dtype == torch.float64), out)
    check_launch(err, "lu_panel_smem")
    return {"sm_count": out[0], "smem_optin": out[1], "static_smem": out[2]}


def _swap(x, i, p):
    """Swap entries (rows) ``i`` and ``p`` of ``x`` in place; ``p`` is a
    0-d index tensor, so nothing syncs with the host."""
    idx = torch.stack((torch.full_like(p, i), p))
    x.index_copy_(0, idx.flip(0), x.index_select(0, idx))


def _panel_lu_unb(P, nbw: int):
    """Unblocked partial-pivot LU of an (M, nbw) panel (the JAX package's
    ``_panel_lu_unb``).  Returns a new packed L\\U panel and the composed
    row permutation: output row i came from input row perm[i]."""
    M = P.shape[0]
    P = P.clone()
    dev = P.device
    ridx = torch.arange(M, device=dev)
    cidx = torch.arange(P.shape[1], device=dev)
    perm = torch.arange(M, device=dev)
    ninf = torch.tensor(-float("inf"), dtype=P.real.dtype, device=dev)
    for j in range(nbw):
        cand = torch.where(ridx >= j, P[:, j].abs(), ninf)
        p = torch.argmax(cand)
        _swap(P, j, p)
        _swap(perm, j, p)
        below = ridx > j
        l = torch.where(below, P[:, j] / P[j, j], torch.zeros_like(P[:, j]))
        P[:, j] = torch.where(below, l, P[:, j])
        urow = torch.where(cidx > j, P[j], torch.zeros_like(P[j]))
        P -= torch.outer(l, urow)
    return P, perm


def _panel_lu(P, nbw: int, precision=None, inners=(512, 64)):
    """Multi-level blocked panel (the JAX package's ``_panel_lu``):
    ``inners``-wide chunk recursion, each chunk's swaps applied to whole
    panel rows, then a unit-lower solve for U12 and one trailing matmul.
    Returns (new packed panel, composed row permutation)."""
    if not inners or nbw <= inners[-1]:
        return _panel_lu_unb(P, nbw)
    step, rest = inners[0], tuple(inners[1:])
    if nbw <= step:
        return _panel_lu(P, nbw, precision, rest)
    M = P.shape[0]
    P = P.clone()
    perm = torch.arange(M, device=P.device)
    for s in range(0, nbw, step):
        e = min(s + step, nbw)
        w = e - s
        sub, sperm = _panel_lu(P[s:, s:e], w, precision, rest)
        rows = P[s:].index_select(0, sperm)         # swaps on the block-row
        rows[:, s:e] = sub
        if e < nbw:
            L11 = sub[:w]
            U12 = torch.linalg.solve_triangular(L11, rows[:w, e:], upper=False,
                                                unitriangular=True)
            rows[:w, e:] = U12
            rows[w:, e:] -= sub[w:, :w] @ U12
        P[s:] = rows
        perm[s:] = perm[s:].index_select(0, sperm)
    return P, perm


def lu_panel_reference(P, nbw: int, inner: int):
    """The plain version of the kernel: ``_panel_lu(P, nbw, None,
    (KERNEL_OUTER_BLOCK, inner))``, or :func:`_panel_lu_unb` when
    ``inner`` is 0."""
    inners = (KERNEL_OUTER_BLOCK, int(inner)) if inner else ()
    return _panel_lu(P, nbw, None, inners)


def lu_panel(P, nbw: int, precision=None, *, inner: int):
    """``(packed L\\U, composed row permutation)`` of an (M, nbw) panel,
    ``M >= nbw``, chunked at ``inner`` columns; real dtypes only.  A CPU
    tensor goes to :func:`lu_panel_reference`; a CUDA tensor (float32 or
    float64, any strides: it is copied once) launches the kernel, which
    takes ``1 <= inner <= 64``, and anything it does not take raises.
    The input is never written."""
    if P.dim() != 2 or P.shape[1] != nbw or P.shape[0] < nbw:
        raise ValueError(f"lu_panel needs an (M, nbw) panel with M >= nbw, "
                         f"got {tuple(P.shape)} with nbw={nbw}")
    if P.is_complex():
        raise ValueError("lu_panel is real-only, as its Pallas twin; the "
                         "panel_impl dispatch sends complex dtypes to the "
                         "plain ladder")
    if P.device.type == "cpu":
        return lu_panel_reference(P, nbw, inner)
    if P.device.type != "cuda":
        raise ValueError(f"lu_panel runs on cpu or cuda, got {P.device}")
    fn_name = _ENTRY.get(P.dtype)
    if fn_name is None:
        raise ValueError(f"the CUDA lu_panel takes float32/float64, "
                         f"got {P.dtype}")
    if not 1 <= inner <= KERNEL_MAX_INNER:
        raise ValueError(f"the CUDA lu_panel chunks at 1 <= inner <= "
                         f"{KERNEL_MAX_INNER}, got inner={inner}")
    M = P.shape[0]
    out = P.clone(memory_format=torch.contiguous_format)
    perm = torch.empty(M, dtype=torch.int64, device=P.device)
    if nbw == 0:
        return out, torch.arange(M, device=P.device)
    lib = _library()
    gmax = torch.cuda.get_device_properties(P.device).multi_processor_count
    # published rows and candidates, the displaced rows of the swaps; and,
    # zeroed, the pivot keys, the barrier counter and the pivot rows
    ws = torch.empty(lib.lu_panel_scratch(nbw, gmax), dtype=P.dtype,
                     device=P.device)
    wz = torch.zeros(lib.lu_panel_words(nbw, gmax), dtype=torch.int64,
                     device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = getattr(lib, fn_name)(out.data_ptr(), out.stride(0), M, nbw,
                                    int(inner), perm.data_ptr(),
                                    ws.data_ptr(), wz.data_ptr(), gmax,
                                    stream)
    check_launch(err, "lu_panel")
    lu_panel.launches += 1
    return out, perm


#: kernel launches (one per call that reached the CUDA kernel)
lu_panel.launches = 0
