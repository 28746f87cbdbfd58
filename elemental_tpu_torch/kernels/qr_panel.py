"""``qr_panel``: Householder QR of an (M, k) panel with its block
reflector triangle -- a hand-written CUDA kernel for Hopper, and its
plain version.

Replaces the Pallas kernel ``elemental_tpu/kernels/qr_panel.py::
qr_panel``.  The kernel (``csrc/qr_panel.cu``) computes what
:func:`_panel_qr` followed by ``_larft(_panel_v(packed), tau)`` computes:
the larfg reflector chain over the k columns, each reflector applied as
H^H to the columns on its right, then T with ``Q = I - V T V^H``.  It is
blocked at two levels.  32-column inner chunks are factored column by
column in ONE cooperative launch each, whose thread blocks own slabs of
rows and meet at one grid-wide barrier per column; each inner chunk's
block reflector goes only to the rest of its 128-column outer block,
which stays in L2.  Each outer block's reflector then goes to the rest of
the panel with register-tiled products of depth 128, and T is assembled
per outer block from the inner blocks' larft recurrences and the grams
the products already hold.  The source's header comment gives the bound.

:func:`_panel_qr`, :func:`_larft` and :func:`_panel_v` are the plain
PyTorch versions (ports of ``elemental_tpu.lapack.qr``'s functions of
the same names, complex-capable); :func:`qr_panel_reference` is the
kernel's plain version.  The wrapper :func:`qr_panel` uses it for a CPU
tensor; for a CUDA tensor it launches the kernel or raises -- there is
no fallback.  No function here calls ``.item()`` or otherwise syncs with
the host.
"""
from __future__ import annotations

import ctypes

import torch

from .common import check_launch, load

_SIGNATURE = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_SCRATCH = ([ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
_ENTRY = {torch.float32: "qr_panel_f32", torch.float64: "qr_panel_f64"}


def _library():
    sigs = {fn: _SIGNATURE for fn in _ENTRY.values()}
    sigs["qr_panel_scratch"] = _SCRATCH
    return load("qr_panel", sigs)


def _panel_qr(P):
    """Unblocked Householder QR of an (M, k) panel (the JAX package's
    ``_panel_qr``).  Returns a new packed V\\R panel and tau.  LAPACK
    larfg conventions: real beta, H_j = I - tau_j v_j v_j^H applied as
    H^H, so the panel ends as Q^H P with Q = H_0 ... H_{k-1}.

    The JAX loop updates the whole panel under a mask; here each step
    touches only rows >= j of columns > j, where the mask lets the
    update through (elsewhere v or the mask is zero), so the values are
    the same up to the order of the sums."""
    M, k = P.shape
    P = P.clone()
    dev = P.device
    tau = torch.zeros(k, dtype=P.dtype, device=dev)
    for j in range(k):
        col = P[j:, j]
        alpha = col[0]
        sigma = (col[1:].abs() ** 2).sum()
        anorm = torch.sqrt(alpha.abs() ** 2 + sigma)
        re_a = alpha.real
        beta = -torch.sign(torch.where(re_a == 0, 1.0, re_a)) * anorm  # real
        degenerate = anorm == 0
        safe_beta = torch.where(degenerate, 1.0, beta)
        tau_j = torch.where(degenerate, 0.0, (safe_beta - alpha) / safe_beta)
        denom = alpha - safe_beta
        safe_denom = torch.where(denom == 0, 1.0, denom)
        v = col / safe_denom
        v[0] = torch.where(degenerate, 0.0, 1.0)
        if j + 1 < k:
            # apply H_j^H = I - conj(tau) v v^H to the trailing columns
            w = v.conj() @ P[j:, j + 1:]
            P[j:, j + 1:] -= torch.outer(tau_j.conj() * v, w)
        # store [beta; v-tail] in column j
        P[j + 1:, j] = v[1:]
        P[j, j] = beta
        tau[j] = tau_j
    return P, tau


def _larft(V, tau):
    """Forward-columnwise block-reflector triangle (the JAX package's
    ``_larft``): Q = I - V T V^H, T upper triangular with diagonal tau.

    The JAX package runs the column recurrence ``T[:i, i] = -tau_i
    T[:i, :i] (V^H V)[:i, i]``, k dependent steps.  Here T is built
    bottom-up over levels b = 1, 2, 4, ... from the Gram B = V^H V: two
    adjacent diagonal blocks T11, T22 of width b join into one of width
    2b with ``T12 = -T11 B12 T22`` (B12 = V1^H V2), the same triangle in
    exact arithmetic, and every pair of a level is one batched product
    pair.  k is padded to a power of two with zero tau, whose rows and
    columns of T stay zero.  So a panel takes ~4 log2(k) launches, not
    ~2 k."""
    k = tau.shape[0]
    if k == 0:
        return V.new_zeros((0, 0))
    K = 1 << (k - 1).bit_length()
    B = V.new_zeros((K, K))
    torch.matmul(V.conj().mT, V, out=B[:k, :k])
    T = V.new_zeros((K, K))
    T.diagonal()[:k] = tau
    b = 1
    while b < K:
        p = K // (2 * b)
        # the p diagonal (2b x 2b) blocks of T and B, as (p, 2b, 2b) views
        Td = T.view(p, 2 * b, p, 2 * b).diagonal(dim1=0, dim2=2) \
            .permute(2, 0, 1)
        Bd = B.view(p, 2 * b, p, 2 * b).diagonal(dim1=0, dim2=2) \
            .permute(2, 0, 1)
        T12 = torch.bmm(torch.bmm(Td[:, :b, :b], Bd[:, :b, b:]),
                        Td[:, b:, b:])
        Td[:, :b, b:] = T12.neg_()
        b *= 2
    return T[:k, :k].contiguous()


def _panel_v(Pf):
    """Unit-lower V from a packed panel."""
    M, k = Pf.shape
    return torch.tril(Pf, -1) + torch.eye(M, k, dtype=Pf.dtype,
                                          device=Pf.device)


def qr_panel_reference(P):
    """The plain version of the kernel: ``(packed, tau, T)`` from
    :func:`_panel_qr` and ``_larft(_panel_v(packed), tau)``."""
    packed, tau = _panel_qr(P)
    return packed, tau, _larft(_panel_v(packed), tau)


def qr_panel(P):
    """``(packed V\\R, tau, T)`` of an (M, k) panel, ``M >= k``, real
    dtypes only (as its Pallas twin).  A CPU tensor goes to
    :func:`qr_panel_reference`; a CUDA tensor (float32 or float64, any
    strides: it is copied once) launches the kernel, and anything it
    does not take raises.  The input is never written; the outputs are
    new tensors."""
    if P.dim() != 2 or P.shape[0] < P.shape[1]:
        raise ValueError(f"qr_panel needs an (M, k) panel with M >= k, "
                         f"got {tuple(P.shape)}")
    if P.is_complex():
        raise ValueError("qr_panel is real-only, as its Pallas twin; the "
                         "panel_impl dispatch sends complex dtypes to the "
                         "plain recurrence")
    if P.device.type == "cpu":
        return qr_panel_reference(P)
    if P.device.type != "cuda":
        raise ValueError(f"qr_panel runs on cpu or cuda, got {P.device}")
    fn_name = _ENTRY.get(P.dtype)
    if fn_name is None:
        raise ValueError(f"the CUDA qr_panel takes float32/float64, "
                         f"got {P.dtype}")
    M, k = P.shape
    out = P.clone(memory_format=torch.contiguous_format)
    tau = torch.zeros(k, dtype=P.dtype, device=P.device)
    T = torch.zeros((k, k), dtype=P.dtype, device=P.device)
    if k == 0:
        return out, tau, T
    lib = _library()
    gmax = torch.cuda.get_device_properties(P.device).multi_processor_count
    ws = torch.empty(lib.qr_panel_scratch(M, k, gmax), dtype=P.dtype,
                     device=P.device)
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = getattr(lib, fn_name)(out.data_ptr(), out.stride(0), M, k,
                                    tau.data_ptr(), T.data_ptr(),
                                    ws.data_ptr(), gmax, stream)
    check_launch(err, "qr_panel")
    qr_panel.launches += 1
    return out, tau, T


#: kernel launches (one per call that reached the CUDA kernel)
qr_panel.launches = 0
