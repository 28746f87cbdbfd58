"""Time builds of a kernel source from several source directories against
each other, on one card, in one process.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 -m elemental_tpu_torch.kernels.ab_timing DIR [DIR ...] \
        [--unchecked DIR ...] [--kernel lu|qr|potrf]

Each DIR holds the kernel's source (``lu_panel.cu``, ``qr_panel.cu``
with ``--kernel qr`` or ``potrf_inv.cu`` with ``--kernel potrf``) and the headers it includes (missing headers
are taken from ``csrc/``): the committed source, an earlier revision
from git history, or a copy with one change to try.  Every source is
built with the port's ``nvcc`` flags into ``kernels/build/ab_timing/``
(ignored by git), one ``nvcc`` per source, all at once.  The builds are
timed with CUDA events in turns, first to last then last to first, so
that drift on the card falls on every build alike, and each build's
result is held against the plain version's (a build named in
``--unchecked`` is timed only: a change that drops part of the
arithmetic to see what it costs).

``lu``: the panels of :data:`PANELS` (three float32 panels of 2048
columns, 32768, 8192 and 2048 rows, and the float64 route's 16384 x 1024,
the ``lu`` example's first panel; ``inner`` = 64), each build's pivots
equal to the plain version's.  ``qr``: the panels of :data:`QR_PANELS`
(the float64 route's 32768 x 128, 16384 x 128 and 4096 x 512, and the
float32 main path's 65536 x 2048 with 16384 x 128 beside it), each
build's factor within :data:`QR_TOL` (scaled with M / 256) of the panel
in the relative residual ``||P - Q R|| / ||P||``.  Both time the plain
version and one library call (``lu_factor``, ``geqrf``) beside them and
give the bound as ``chip_smoke.py`` phase 2 gives it.
``potrf``: the blocks of :data:`POTRF_BLOCKS` (the float64 route's main
paths, w = 2048, 512 and 128, and the float32 main path's 2048), each
build's ``(L, L^-1)`` within :data:`POTRF_TOL` of the plain version's,
elementwise relative to the largest entry; the plain version and one
library call (``cholesky`` + ``solve_triangular``) are timed beside
them, and the bound is given as ``chip_smoke.py`` phase 2 gives it.
One JSON line per panel or block gives the mean time of each turn per
build, in ms, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PANELS = ((32768, 2048, "float32"), (8192, 2048, "float32"),
          (2048, 2048, "float32"), (16384, 1024, "float64"))
QR_PANELS = ((32768, 128, "float64"), (16384, 128, "float64"),
             (4096, 512, "float64"), (65536, 2048, "float32"),
             (16384, 128, "float32"))
#: qr: a build's relative residual bound at M = 256 (``chip_smoke.py``'s
#: QR_RES_TOL), scaled with M / 256 and capped as QR_RES_CAP caps it
QR_TOL = {"float32": 3e-6, "float64": 1e-12}
QR_CAP = {"float32": 1e-4, "float64": 1e-10}
INNER = 64
REPS = 5
#: potrf_inv's blocks (w, dtype name), and the elementwise tolerance of a
#: build against the plain version (``chip_smoke.py``'s ELEM_TOL)
POTRF_BLOCKS = ((2048, "float64"), (512, "float64"), (128, "float64"),
                (2048, "float32"))
POTRF_TOL = {"float32": 1e-4, "float64": 1e-11}
#: the data-sheet peaks of ``chip_smoke.py`` (FP32 FMA, FP64 tensor
#: cores; HBM3)
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


def _build(dirs, name="lu_panel") -> list:
    from . import common
    out = common.BUILD_DIR / "ab_timing" / name
    procs = []
    for i, d in enumerate(dirs):
        work = out / str(i)
        work.mkdir(parents=True, exist_ok=True)
        for src in list(common.CSRC.glob("*.cuh")) + list(d.glob("*.cuh")):
            shutil.copy(src, work / src.name)
        shutil.copy(d / f"{name}.cu", work / f"{name}.cu")
        lib = work / f"lib{name}.so"
        procs.append((subprocess.Popen(
            [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib),
             str(work / f"{name}.cu")]), lib))
    libs = []
    for proc, lib in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"ab_timing: the build of {lib} failed")
        libs.append(ctypes.CDLL(str(lib)))
    if name == "potrf_inv":
        for lib in libs:
            lib.potrf_inv_rowbuf.argtypes = [ctypes.c_int]
            lib.potrf_inv_rowbuf.restype = ctypes.c_longlong
            for fn in (lib.potrf_inv_f32, lib.potrf_inv_f64):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int] + \
                    [ctypes.c_void_p] * 5
                fn.restype = ctypes.c_int
        return libs
    if name == "qr_panel":
        for lib in libs:
            lib.qr_panel_scratch.argtypes = [ctypes.c_int] * 3
            lib.qr_panel_scratch.restype = ctypes.c_longlong
            for fn in (lib.qr_panel_f32, lib.qr_panel_f64):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
        return libs
    for lib in libs:
        for f in (lib.lu_panel_scratch, lib.lu_panel_words):
            f.argtypes = [ctypes.c_int] * 2
            f.restype = ctypes.c_longlong
        for fn in (lib.lu_panel_f32, lib.lu_panel_f64):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return libs


def _factor(lib, P, nbw, gmax):
    """One call of a build, as the wrapper makes it (clone, scratch)."""
    import torch
    M = P.shape[0]
    out = P.clone()
    perm = torch.empty(M, dtype=torch.int64, device=P.device)
    ws = torch.empty(lib.lu_panel_scratch(nbw, gmax), dtype=P.dtype,
                     device=P.device)
    wz = torch.zeros(lib.lu_panel_words(nbw, gmax), dtype=torch.int64,
                     device=P.device)
    fn = lib.lu_panel_f64 if P.dtype == torch.float64 else lib.lu_panel_f32
    err = fn(out.data_ptr(), nbw, M, nbw, INNER, perm.data_ptr(),
             ws.data_ptr(), wz.data_ptr(), gmax,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ab_timing: CUDA error {err}")
    return out, perm


def _qr(lib, P, gmax):
    """One call of a ``qr_panel`` build, as the wrapper makes it (clone,
    outputs, scratch)."""
    import torch
    M, k = P.shape
    out = P.clone()
    tau = torch.zeros(k, dtype=P.dtype, device=P.device)
    T = torch.zeros(k, k, dtype=P.dtype, device=P.device)
    ws = torch.empty(lib.qr_panel_scratch(M, k, gmax), dtype=P.dtype,
                     device=P.device)
    fn = lib.qr_panel_f64 if P.dtype == torch.float64 else lib.qr_panel_f32
    err = fn(out.data_ptr(), k, M, k, tau.data_ptr(), T.data_ptr(),
             ws.data_ptr(), gmax, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ab_timing: CUDA error {err}")
    return out, tau, T


def qr_residual(P, packed, tau, T) -> float:
    """``||P - Q [R; 0]|| / ||P||`` with Q = I - V T V^T, in float64."""
    import torch
    from .qr_panel import _panel_v
    k = P.shape[1]
    R = torch.triu(packed[:k].double())
    V = _panel_v(packed.double())
    QR = -(V @ (T.double() @ (V[:k].T @ R)))
    QR[:k] += R
    F = P.double()
    return float(torch.linalg.norm(F - QR) / torch.linalg.norm(F))


def _potrf(lib, D):
    """One call of a ``potrf_inv`` build, as the wrapper makes it (its
    outputs, row buffer and barrier words allocated here; bs = 512)."""
    import torch
    w = D.shape[0]
    L, Li = torch.empty_like(D), torch.empty_like(D)
    Rb = torch.empty(lib.potrf_inv_rowbuf(w), dtype=D.dtype, device=D.device)
    bar = torch.zeros(2, dtype=torch.int32, device=D.device)
    fn = lib.potrf_inv_f64 if D.dtype == torch.float64 else lib.potrf_inv_f32
    err = fn(D.data_ptr(), w, w, 512, L.data_ptr(), Li.data_ptr(),
             Rb.data_ptr(), bar.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ab_timing: CUDA error {err}")
    return L, Li


def _time_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _potrf_blocks(dirs, libs, unchecked, order, card) -> None:
    import torch
    from .chol_panel import potrf_inv_reference
    for w, name in POTRF_BLOCKS:
        dt = getattr(torch, name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(w)
        G = torch.randn(w, w, generator=gen, device="cuda", dtype=dt)
        D = G @ G.T / w + w * torch.eye(w, device="cuda", dtype=dt)
        Lp, Lip = potrf_inv_reference(D)
        reps = 20 if w <= 512 else 10
        ms = {str(d): [] for d in dirs}
        for i in order:
            if dirs[i].resolve() not in unchecked:
                L, Li = _potrf(libs[i], D)
                err = max(float((L - Lp).abs().max() / Lp.abs().max()),
                          float((Li - Lip).abs().max() / Lip.abs().max()))
                if not err <= POTRF_TOL[name]:
                    raise AssertionError(f"ab_timing: {dirs[i]} is {err:.2e} "
                                         f"from the plain version at w={w} "
                                         f"{name}")
            ms[str(dirs[i])].append(
                _time_ms(lambda: _potrf(libs[i], D), reps))
        eye = torch.eye(w, dtype=dt, device="cuda")
        plain = _time_ms(lambda: potrf_inv_reference(D), reps)
        library = _time_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(D), eye, upper=False), reps)
        bound = max(2 * w ** 3 / 3 / PEAK_FLOPS,
                    2.5 * w * w * D.element_size() / PEAK_BYTES) * 1e3
        print(json.dumps({"block": [w, name], "ms": ms, "plain_ms": plain,
                          "library_ms": library, "bound_ms": bound,
                          "card": card}), flush=True)


def _lu_panels(dirs, libs, unchecked, order, card, gmax) -> None:
    import torch
    from .lu_panel import lu_panel_reference
    for M, nbw, name in PANELS:
        dt = getattr(torch, name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(M + nbw)
        P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dt)
        _, rperm = lu_panel_reference(P, nbw, INNER)
        ms = {str(d): [] for d in dirs}
        for i in order:
            if dirs[i].resolve() not in unchecked:
                _, perm = _factor(libs[i], P, nbw, gmax)
                if not torch.equal(perm, rperm):
                    raise AssertionError(f"ab_timing: {dirs[i]} gives other "
                                         f"pivots than the plain version")
            ms[str(dirs[i])].append(
                _time_ms(lambda: _factor(libs[i], P, nbw, gmax)))
        plain = _time_ms(lambda: lu_panel_reference(P, nbw, INNER), 1)
        library = _time_ms(lambda: torch.linalg.lu_factor(P))
        bound = max((M * nbw ** 2 - nbw ** 3 / 3) / PEAK_FLOPS,
                    2 * M * nbw * P.element_size() / PEAK_BYTES) * 1e3
        print(json.dumps({"panel": [M, nbw, name], "inner": INNER, "ms": ms,
                          "plain_ms": plain, "library_ms": library,
                          "bound_ms": bound, "card": card}), flush=True)


def _qr_panels(dirs, libs, unchecked, order, card, gmax) -> None:
    import torch
    from .qr_panel import qr_panel_reference
    for M, k, name in QR_PANELS:
        dt = getattr(torch, name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(M + k)
        P = torch.randn(M, k, generator=gen, device="cuda", dtype=dt)
        tol = min(QR_TOL[name] * max(1.0, M / 256), QR_CAP[name])
        reps = 20 if M * k <= 2 ** 22 else REPS
        ms = {str(d): [] for d in dirs}
        for i in order:
            if dirs[i].resolve() not in unchecked:
                res = qr_residual(P, *_qr(libs[i], P, gmax))
                if not res <= tol:
                    raise AssertionError(f"ab_timing: {dirs[i]} residual "
                                         f"{res:.3e} > {tol:.1e} at "
                                         f"{M}x{k} {name}")
            ms[str(dirs[i])].append(
                _time_ms(lambda: _qr(libs[i], P, gmax), reps))
        plain = _time_ms(lambda: qr_panel_reference(P), 1)
        library = _time_ms(lambda: torch.geqrf(P), reps)
        bound = max((3 * M * k * k - k ** 3) / PEAK_FLOPS,
                    (2 * M * k + k * k + k) * P.element_size()
                    / PEAK_BYTES) * 1e3
        print(json.dumps({"panel": [M, k, name], "ms": ms, "plain_ms": plain,
                          "library_ms": library, "bound_ms": bound,
                          "card": card}), flush=True)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(prog="ab_timing")
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--unchecked", nargs="*", type=Path, default=[])
    ap.add_argument("--kernel", choices=("lu", "qr", "potrf"), default="lu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_timing: no CUDA device", file=sys.stderr)
        return 1
    dirs = list(args.dirs)
    libs = _build(dirs, {"potrf": "potrf_inv", "qr": "qr_panel"}.get(
        args.kernel, "lu_panel"))
    unchecked = {d.resolve() for d in args.unchecked}
    gmax = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    order = list(range(len(dirs))) + list(reversed(range(len(dirs))))
    if args.kernel == "potrf":
        _potrf_blocks(dirs, libs, unchecked, order, card)
    elif args.kernel == "qr":
        _qr_panels(dirs, libs, unchecked, order, card, gmax)
    else:
        _lu_panels(dirs, libs, unchecked, order, card, gmax)
    return 0


if __name__ == "__main__":
    sys.exit(main())
