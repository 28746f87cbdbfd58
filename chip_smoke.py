#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``elemental_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. set-up: the card's name and power limit, the torch and CUDA versions,
   ``allow_tf32 = False``, and the build of every CUDA kernel from the
   sources in the checkout (one ``nvcc`` per source, all at once; timed);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it and a ladder around them, with its time,
   the plain version's, one library call's and the least time the card
   could take (``bound_ms``): ``potrf_inv`` (w = 64 ... 2048) and
   ``lu_panel`` (32768 x 2048 ... a panel of constructed ties);
3. the Cholesky main path at full width: ``hpd_solve(A, B, nb=2048)`` on
   the 1x1 grid, N = 32768 float32, nrhs = 8, A = G G^T / N + N I from a
   seeded generator; the factor gate of ``bench.py``, a solve residual,
   and ``potrf_inv``'s launch count on that run;
3b. the LU main path at full width: ``lu_solve(A, B, nb=2048)`` on the
   1x1 grid, N = 32768 float32, nrhs = 8, A and B normal from a seeded
   generator; ``bench.py``'s LU factor gate, HPL's scaled residual and
   ``lu_panel``'s launch count on that run;
4. the distributed branches: ``hpd_solve`` and ``lu`` + ``lu_solve_after``
   on a virtual 2x2 grid on the card, N = 1024 float64, nb = 128, with
   and without the crossover, against ``torch.linalg.solve``.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the JSON
object of per-kernel numbers.  With no card, or without the package
beside this file, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

#: data-sheet peaks of one H100 SXM at 700 W (dense, no sparsity): FP32
#: outside the tensor cores, FP64 on the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12

#: kernel-vs-plain residual contract of the CPU tests, scaled with w / 256
#: (the tests' bound is set at w <= 256)
RES_TOL = {"float32": 3e-6, "float64": 1e-12}
#: largest elementwise difference, relative to the largest entry, between
#: the kernel's (L, L^-1) and the plain version's
ELEM_TOL = {"float32": 1e-4, "float64": 1e-11}
#: lu_panel's residual ||P[perm] - L U|| / ||P|| of the CPU tests, scaled
#: with M / 256 (the tests' bound is set at M <= 256)
LU_RES_TOL = {"float32": 1e-5, "float64": 1e-12}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up,
    with CUDA events."""
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


def _device_breakdown(fn) -> dict:
    """One profiled call of ``fn``: its wall time, the device time summed
    per kernel name, and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:60]
        n, ms = per_kernel.get(name, (0, 0.0))
        per_kernel[name] = (n + 1, ms + ev.time_range.elapsed_us() / 1e3)
    busy_ms = sum(ms for _, ms in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "top_kernels": [[k, n, ms] for k, (n, ms) in top]}


def _spd(n: int, dtype, seed: int):
    """bench.py's SPD matrix, G G^T / n + n I, made on the card."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    G = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    A = G @ G.T
    del G
    A.div_(n)
    A.diagonal().add_(n)
    return A, gen


def phase_kernels(et) -> list:
    """``potrf_inv`` against its plain version; returns the per-shape rows."""
    import torch
    from elemental_tpu_torch.kernels import potrf_inv, potrf_inv_reference
    rows = []
    for w, dt in ((64, torch.float32), (512, torch.float32),
                  (2048, torch.float32), (512, torch.float64)):
        name = str(dt).replace("torch.", "")
        D, _ = _spd(w, dt, seed=w)
        eye = torch.eye(w, dtype=dt, device="cuda")
        L, Li = potrf_inv(D)
        torch.cuda.synchronize()
        Lp, Lip = potrf_inv_reference(D)

        def res(L, Li):
            return max(float(torch.linalg.norm(L @ L.T - D)
                             / torch.linalg.norm(D)),
                       float(torch.linalg.norm(Li @ L - eye) / w ** 0.5))

        rk, rp = res(L, Li), res(Lp, Lip)
        tol = RES_TOL[name] * max(1.0, w / 256)
        if not (rk <= tol and rp <= tol and rk <= 10 * rp + tol):
            raise AssertionError(f"potrf_inv w={w} {name}: kernel residual "
                                 f"{rk:.3e}, plain {rp:.3e}, tolerance {tol:.1e}")
        abs_err = max(float((L - Lp).abs().max()), float((Li - Lip).abs().max()))
        rel_err = max(float((L - Lp).abs().max() / Lp.abs().max()),
                      float((Li - Lip).abs().max() / Lip.abs().max()))
        if not rel_err <= ELEM_TOL[name]:
            raise AssertionError(f"potrf_inv w={w} {name}: elementwise "
                                 f"difference {rel_err:.3e} > {ELEM_TOL[name]}")
        reps = 20 if w <= 512 else 10
        kernel_ms = _time_ms(lambda: potrf_inv(D), reps)
        plain_ms = _time_ms(lambda: potrf_inv_reference(D), reps)

        def library():
            Lc = torch.linalg.cholesky(D)
            return torch.linalg.solve_triangular(Lc, eye, upper=False)

        library_ms = _time_ms(library, reps)
        itemsize = D.element_size()
        flop_ms = (2 * w ** 3 / 3) / PEAK_FLOPS[name] * 1e3
        # bytes: D's lower triangle read (w^2 / 2), L and Li written (2 w^2)
        byte_ms = 2.5 * w * w * itemsize / PEAK_BYTES * 1e3
        row = {"w": w, "dtype": name, "kernel_residual": rk,
               "plain_residual": rp, "max_abs_err": abs_err,
               "max_rel_err": rel_err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
        print("phase 2 potrf_inv " + json.dumps(row), flush=True)
        if w == 2048:
            print("phase 2 potrf_inv breakdown " + json.dumps(
                _device_breakdown(lambda: potrf_inv(D))), flush=True)
        rows.append(row)
    return rows


def _tie_panel():
    """A 32 x 8 float32 panel whose columns tie on |value| at every pivot
    search (``tests/kernels/test_lu_panel.py``'s construction)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    P = np.zeros((32, 8), dtype=np.float32)
    for j in range(8):
        P[:, j] = rng.integers(1, 4, size=32).astype(np.float32)
        P[j::5, j] = 3.0
        P[:, j] *= np.sign(rng.normal(size=32)) + 0.5
    return torch.from_numpy(P).cuda()


def phase_lu_panel() -> list:
    """``lu_panel`` against its plain version; returns the per-shape rows.
    Pivots must be identical on the tie panel and the small shapes; at the
    two large shapes a near-tie among thousands of rows may resolve
    differently under other rounding, so the count of differing pivots is
    printed, not gated."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, lu_panel_reference
    rows = []
    for M, nbw, dt, inner, large in (
            (32768, 2048, torch.float32, 64, True),
            (2048, 2048, torch.float32, 64, True),
            (4096, 512, torch.float32, 64, False),
            (1024, 128, torch.float64, 64, False),
            (32, 8, torch.float32, 4, False)):
        name = str(dt).replace("torch.", "")
        if M == 32:
            P = _tie_panel()
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(M + nbw)
            P = torch.randn(M, nbw, generator=gen, device="cuda", dtype=dt)
        packed, perm = lu_panel(P, nbw, inner=inner)
        torch.cuda.synchronize()
        ref, rperm = lu_panel_reference(P, nbw, inner)

        def rebuilt(F, p):
            """The input the factor stands for: (L U) with row i put back
            at row p[i]."""
            L = torch.tril(F, -1) + torch.eye(M, nbw, dtype=dt, device="cuda")
            out = torch.empty_like(P)
            out[p] = L @ torch.triu(F[:nbw])
            return out

        Pk, Pp = rebuilt(packed, perm), rebuilt(ref, rperm)
        norm_p = torch.linalg.norm(P)
        rk = float(torch.linalg.norm(P - Pk) / norm_p)
        rp = float(torch.linalg.norm(P - Pp) / norm_p)
        # kernel against plain version, on what both factors rebuild
        abs_err = float((Pk - Pp).abs().max())
        del Pk, Pp
        pivots_differ = int((perm != rperm).sum())
        lmax = float(torch.tril(packed, -1).abs().max())
        tol = LU_RES_TOL[name] * max(1.0, M / 256)
        if not (rk <= tol and rp <= tol and lmax <= 1.0
                and (large or pivots_differ == 0)):
            raise AssertionError(
                f"lu_panel {M}x{nbw} {name}: kernel residual {rk:.3e}, plain "
                f"{rp:.3e}, tolerance {tol:.1e}, max |L| {lmax}, "
                f"{pivots_differ} pivots differ")
        reps = 1 if M * nbw >= 2 ** 24 else 5
        kernel_ms = _time_ms(lambda: lu_panel(P, nbw, inner=inner), 3 * reps)
        plain_ms = _time_ms(lambda: lu_panel_reference(P, nbw, inner), reps)
        library_ms = _time_ms(lambda: torch.linalg.lu_factor(P), 3 * reps)
        itemsize = P.element_size()
        flop_ms = (M * nbw ** 2 - nbw ** 3 / 3) / PEAK_FLOPS[name] * 1e3
        byte_ms = 2 * M * nbw * itemsize / PEAK_BYTES * 1e3
        row = {"M": M, "nbw": nbw, "dtype": name, "inner": inner,
               "kernel_residual": rk, "plain_residual": rp,
               "residual_tolerance": tol, "max_abs_L": lmax,
               "pivots_differ": pivots_differ, "max_abs_err": abs_err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
        print("phase 2 lu_panel " + json.dumps(row), flush=True)
        if M == 32768:
            print("phase 2 lu_panel breakdown " + json.dumps(
                _device_breakdown(lambda: lu_panel(P, nbw, inner=inner))),
                flush=True)
        rows.append(row)
        del P, packed, ref
    return rows


def phase_main_path(et, card: str) -> dict:
    """hpd_solve at full width on the 1x1 grid; returns its numbers."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv
    N, nb, nrhs = 32768, 2048, 8
    grid = et.Grid()
    # warm-up at a small size (library handles, the kernel's first launch)
    Aw, _ = _spd(4096, torch.float32, seed=1)
    et.hpd_solve(et.from_global(Aw, et.MC, et.MR, grid),
                 et.from_global(torch.ones(4096, nrhs, device="cuda"),
                                et.MC, et.MR, grid), nb=nb)
    del Aw
    Ag, gen = _spd(N, torch.float32, seed=0)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    A = et.from_global(Ag, et.MC, et.MR, grid)
    B = et.from_global(Bg, et.MC, et.MR, grid)
    del Ag
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = 0
    t0 = time.perf_counter()
    X = et.hpd_solve(A, B, nb=nb)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = potrf_inv.launches
    if launches != N // nb or lu_panel.launches != 0:
        raise AssertionError(f"potrf_inv launched {launches} times on the "
                             f"main path, expected {N // nb}; lu_panel "
                             f"{lu_panel.launches}, expected 0")
    t0 = time.perf_counter()
    F = et.cholesky(A, nb=nb)
    torch.cuda.synchronize()
    t_chol = time.perf_counter() - t0
    print("phase 3 hpd_solve breakdown " + json.dumps(
        _device_breakdown(lambda: et.hpd_solve(A, B, nb=nb))), flush=True)
    a, l, x = A.local, F.local, X.local
    v = torch.randn(N, 1, generator=gen, device="cuda")
    norm_a = torch.linalg.norm(a)
    factor_res = float(torch.linalg.norm(a @ v - l @ (l.T @ v))
                       / (norm_a * torch.linalg.norm(v)))
    solve_res = float(torch.linalg.norm(a @ x - B.local)
                      / (norm_a * torch.linalg.norm(x)))
    if not (factor_res < 1e-3 and solve_res < 1e-4
            and bool(torch.isfinite(x).all()) and tuple(x.shape) == (N, nrhs)):
        raise AssertionError(f"main path: factor residual {factor_res:.3e} "
                             f"(< 1e-3), solve residual {solve_res:.3e} (< 1e-4)")
    out = {"N": N, "nb": nb, "nrhs": nrhs, "dtype": "float32",
           "hpd_solve_s": t_solve, "cholesky_s": t_chol,
           "cholesky_tflops": N ** 3 / 3 / t_chol / 1e12,
           "hpd_solve_tflops": N ** 3 / 3 / t_solve / 1e12,
           "potrf_inv_launches": launches, "factor_residual": factor_res,
           "solve_residual": solve_res, "card": card}
    print("phase 3 main path " + json.dumps(out), flush=True)
    return out


def phase_lu_main_path(et, card: str) -> dict:
    """lu_solve at full width on the 1x1 grid; returns its numbers."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv
    N, nb, nrhs = 32768, 2048, 8
    grid = et.Grid()
    gen = torch.Generator(device="cuda")
    # warm-up at a small size (library handles, the kernel's first launch)
    gen.manual_seed(1)
    Aw = torch.randn(4096, 4096, generator=gen, device="cuda")
    et.lu_solve(et.from_global(Aw, et.MC, et.MR, grid),
                et.from_global(torch.ones(4096, nrhs, device="cuda"),
                               et.MC, et.MR, grid), nb=nb)
    torch.linalg.lu_factor(Aw)
    del Aw
    gen.manual_seed(0)
    Ag = torch.randn(N, N, generator=gen, device="cuda")
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    A = et.from_global(Ag, et.MC, et.MR, grid)
    B = et.from_global(Bg, et.MC, et.MR, grid)
    del Ag
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = 0
    t0 = time.perf_counter()
    X = et.lu_solve(A, B, nb=nb)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = lu_panel.launches
    if launches != N // nb or potrf_inv.launches != 0:
        raise AssertionError(f"lu_panel launched {launches} times on the "
                             f"main path, expected {N // nb}; potrf_inv "
                             f"{potrf_inv.launches}, expected 0")
    t0 = time.perf_counter()
    LU, perm = et.lu(A, nb=nb)
    torch.cuda.synchronize()
    t_lu = time.perf_counter() - t0
    a, lu_, x, b = A.local, LU.local, X.local, B.local
    # bench.py's factor gate: ||A[perm] v - L (U v)|| / (||A||_F ||v||)
    v = torch.randn(N, 1, generator=gen, device="cuda")
    uv = torch.triu(lu_) @ v
    luv = torch.tril(lu_, -1) @ uv + uv
    factor_res = float(torch.linalg.norm(a[perm] @ v - luv)
                       / (torch.linalg.norm(a) * torch.linalg.norm(v)))
    del uv, luv, LU, lu_
    # HPL's scaled residual, one per right-hand side
    eps = torch.finfo(torch.float32).eps
    norm_a = float(a.abs().sum(dim=1).max())
    r = (a @ x - b).abs().amax(dim=0)
    hpl = (r / (eps * (norm_a * x.abs().amax(dim=0) + b.abs().amax(dim=0))
                * N)).tolist()
    finite = bool(torch.isfinite(x).all())
    if not (factor_res < 1e-3 and max(hpl) < 16 and finite
            and tuple(x.shape) == (N, nrhs)):
        raise AssertionError(f"LU main path: factor residual "
                             f"{factor_res:.3e} (< 1e-3), HPL scaled "
                             f"residuals {hpl} (< 16), finite {finite}")
    lu_factor_ms = _time_ms(lambda: torch.linalg.lu_factor(a), 1)
    print("phase 3b lu_solve breakdown " + json.dumps(
        _device_breakdown(lambda: et.lu_solve(A, B, nb=nb))), flush=True)
    out = {"N": N, "nb": nb, "nrhs": nrhs, "dtype": "float32",
           "lu_solve_s": t_solve, "lu_s": t_lu,
           "lu_tflops": 2 * N ** 3 / 3 / t_lu / 1e12,
           "lu_factor_ms": lu_factor_ms, "lu_panel_launches": launches,
           "factor_residual": factor_res, "hpl_scaled_residuals": hpl,
           "card": card}
    print("phase 3b LU main path " + json.dumps(out), flush=True)
    return out


def phase_distributed(et) -> None:
    """hpd_solve on a virtual 2x2 grid on the card, against torch.linalg.solve."""
    import torch
    from elemental_tpu_torch.kernels import potrf_inv
    N, nb, nrhs = 1024, 128, 4
    grid = et.Grid(2, 2)
    Ag, gen = _spd(N, torch.float64, seed=2)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda", dtype=torch.float64)
    ref = torch.linalg.solve(Ag, Bg)
    for crossover in (None, 0):
        A = et.from_global(Ag, et.MC, et.MR, grid)
        B = et.from_global(Bg, et.MC, et.MR, grid)
        potrf_inv.launches = 0
        F = et.cholesky(A, nb=nb, crossover=crossover)
        X = et.cholesky_solve_after(F, B, nb=nb)
        torch.cuda.synchronize()
        launches = potrf_inv.launches
        x = et.to_global(X)
        err = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        res = float(torch.linalg.norm(Ag @ x - Bg) / torch.linalg.norm(Bg))
        if launches < 1 or not (err < 1e-10 and res < 1e-12):
            raise AssertionError(f"2x2 grid crossover={crossover}: launches "
                                 f"{launches}, error {err:.3e}, residual {res:.3e}")
        print("phase 4 distributed " + json.dumps(
            {"grid": "2x2", "N": N, "nb": nb, "dtype": "float64",
             "crossover": crossover, "potrf_inv_launches": launches,
             "rel_error_vs_torch_solve": err, "residual": res}), flush=True)


def phase_lu_distributed(et) -> None:
    """lu + lu_solve_after on a virtual 2x2 grid on the card, against
    torch.linalg.solve."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel
    N, nb, nrhs = 1024, 128, 4
    grid = et.Grid(2, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    Ag = torch.randn(N, N, generator=gen, device="cuda", dtype=torch.float64)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda", dtype=torch.float64)
    ref = torch.linalg.solve(Ag, Bg)
    for crossover in (None, 0):
        A = et.from_global(Ag, et.MC, et.MR, grid)
        B = et.from_global(Bg, et.MC, et.MR, grid)
        lu_panel.launches = 0
        LU, perm = et.lu(A, nb=nb, crossover=crossover)
        X = et.lu_solve_after(LU, perm, B, nb=nb)
        torch.cuda.synchronize()
        launches = lu_panel.launches
        x = et.to_global(X)
        err = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        if launches < 1 or not err < 1e-10:
            raise AssertionError(f"LU 2x2 grid crossover={crossover}: "
                                 f"launches {launches}, error {err:.3e}")
        print("phase 4 LU distributed " + json.dumps(
            {"grid": "2x2", "N": N, "nb": nb, "dtype": "float64",
             "crossover": crossover, "lu_panel_launches": launches,
             "rel_error_vs_torch_solve": err}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import elemental_tpu_torch as et
    from elemental_tpu_torch.kernels import common

    card = _card_line()
    print(f"phase 1 card: {card}", flush=True)
    print(f"phase 1 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    common.build(["potrf_inv", "lu_panel"])
    print(f"phase 1 build_s {time.perf_counter() - t0:.3f}", flush=True)

    rows = phase_kernels(et)
    lu_rows = phase_lu_panel()
    main_path = phase_main_path(et, card)
    lu_path = phase_lu_main_path(et, card)
    phase_distributed(et)
    phase_lu_distributed(et)

    at_path = next(r for r in rows if r["w"] == 2048 and r["dtype"] == "float32")
    kernels = [{
        "name": "potrf_inv", "route": "cuda",
        "source": "elemental_tpu_torch/kernels/csrc/potrf_inv.cu",
        "replaces": "elemental_tpu/kernels/chol_panel.py:122",
        "launches": main_path["potrf_inv_launches"],
        "max_abs_err": at_path["max_abs_err"], "ms": at_path["kernel_ms"],
        "plain_ms": at_path["plain_ms"], "bound_ms": at_path["bound_ms"],
        "bound_by": at_path["bound_by"], "library_ms": at_path["library_ms"],
    }]
    lu_at = next(r for r in lu_rows if r["M"] == 32768)
    kernels.append({
        "name": "lu_panel", "route": "cuda",
        "source": "elemental_tpu_torch/kernels/csrc/lu_panel.cu",
        "replaces": "elemental_tpu/kernels/lu_panel.py:119",
        "launches": lu_path["lu_panel_launches"],
        "max_abs_err": lu_at["max_abs_err"],
        "ms": lu_at["kernel_ms"], "plain_ms": lu_at["plain_ms"],
        "bound_ms": lu_at["bound_ms"], "bound_by": lu_at["bound_by"],
        "library_ms": lu_at["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
