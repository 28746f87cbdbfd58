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
   could take (``bound_ms``): ``potrf_inv`` (w = 1 ... 2048),
   ``lu_panel`` (32768 x 2048, phase 3h's 8192 x 512 ... a panel of
   constructed ties, the edges of its 128-column outer block) and
   ``qr_panel`` (65536 x 2048, the SVD path's 16384 x 512, phase 3h's
   40960 x 512, 32768 x 512 ... 33 x 7, a zero column, graded columns, a
   strided view);
3. the Cholesky main path at full width: ``hpd_solve(A, B, nb=2048)`` on
   the 1x1 grid, N = 32768 float32, nrhs = 8, A = G G^T / N + N I from a
   seeded generator; the factor gate of ``bench.py``, a solve residual,
   and ``potrf_inv``'s launch count on that run;
3b. the LU main path at full width: ``lu_solve(A, B, nb=2048)`` on the
   1x1 grid, N = 32768 float32, nrhs = 8, A and B normal from a seeded
   generator; ``bench.py``'s LU factor gate, HPL's scaled residual and
   ``lu_panel``'s launch count on that run;
3c. the QR least-squares main path at full width: ``least_squares(A, B,
   nb=2048)`` on the 1x1 grid, m = 65536, n = 32768 float32, nrhs = 8,
   A and B normal from a seeded generator; the factor residual through
   ``apply_q``, Q's orthogonality, the normal-equations optimality, and
   ``qr_panel``'s launch count on that run;
3d. the generalized eigensolver at full size: ``herm_gen_def_eig(A, B,
   nb=512)`` on the 1x1 grid, N = 16384 float32, A = (G + G^T) / 2 and
   B = G' G'^T / N + N I from seeded generators; the wall time whole and
   per step of the call (Cholesky, ``two_sided_trsm``,
   ``hermitian_tridiag`` against its bytes floor, ``tridiag_eig``,
   ``apply_q_herm_tridiag`` and its T rebuilds, the final
   ``trsm``), a device profile with the idle share, three gates over
   N eps (residual, B-orthogonality, eigenvalues against the float64
   ``eigvalsh`` of the reduced matrix), ``torch.linalg.eigh`` of that
   matrix timed beside it, and ``potrf_inv``'s launch count on that run;
3e. the SVD main path: ``svd(A, nb=512)`` on the 1x1 grid (the Chan
   route: ``qr``, the QDWH ``polar`` of R, ``herm_eig`` of H, a ``gemm``
   and ``apply_q``), m = 16384, n = 8192 float32 (a depth cut from
   32768 x 16384, where ``torch.linalg.svd(A)`` alone took ~55 s), A = U0
   diag(s0) V0^T with seeded orthonormal U0, V0 and s0 geometric from 1
   to 1e-3; the wall time whole and per step, a device profile of
   ``polar`` with the idle share, four gates over n eps (reconstruction,
   U and V orthogonality, singular values against s0),
   ``torch.linalg.svd(A)`` timed beside it, and the launch counts the
   QDWH schedule predicts (``qr_panel`` and ``potrf_inv``; no
   ``lu_panel``);
3f. the rest of the slice at n = 4096 float32, each timed with its
   launches: ``herm_eig(approach='qdwh')`` (the gates of 3d against the
   float64 ``eigvalsh``), ``svd(approach='golub')`` at 8192 x 4096 (the
   gates of 3e), ``polar`` of a square matrix and ``sign`` of a
   symmetric indefinite one (through ``lu_panel``);
3g. the symmetric-indefinite main path at full width: ``symmetric_solve(K,
   B, nb=512)`` on the 1x1 grid, N = 32768 float32, nrhs = 8, K the KKT
   matrix [[H, J^T], [J, 0]] of an equality-constrained quadratic program
   (n = 24576, p = 8192, H = G G^T / n + I, J standard normal, seeded);
   the call timed whole, then ``ldl`` and ``ldl_solve_after``, the count
   of 2x2 pivots and max|L|, three gates reduced in float64 (factor
   residual, solve residual, the exact inertia (n, p, 0)),
   ``torch.linalg.ldl_factor`` + ``ldl_solve`` timed beside it, a device
   profile of the call at N = 8192 with its idle share, and 0 launches of
   each kernel (``ldl`` has none);
3h. the rest of the slice on the 1x1 grid float32, each step timed with
   its launches against the count the drivers' blocking predicts and
   gated by the JAX test's own check over n eps: ``lse``, ``glm``,
   ``ridge``, ``tikhonov``, the determinants, ``condition``, ``two_norm``,
   ``nuclear_norm``, ``two_norm_estimate``, ``qr_col_piv``,
   ``lu_full_pivot``, ``schur`` / ``triang_eig`` / ``eig`` (complex64),
   ``pseudospectra``, ``sylvester``, ``lyapunov``, ``riccati``, ``hemm``
   and ``her2k`` (each beside ``torch.matmul``), ``quasi_trsm`` and
   ``multishift_trsm``;
3i. CALU and TSQR on virtual grids at full width, float32: ``lu_solve(A,
   B, nb=2048, panel='calu')`` and ``lu`` on a 4x1 grid at N = 32768
   (phase 3b's matrix) with HPL's scaled residual, the factor residual,
   the growth and the ratio to phase 3b's classic residual; the same
   ``lu`` over the int8 wire (equal collective rounds, >= 1.9x fewer wire
   bytes in ``redist_trace``); ``qr(A, nb=2048, panel='tsqr')`` and the
   least-squares solve at 65536 x 32768 on 4x1 (phase 3c's gates); the
   standalone ``tsqr`` of a 4194304 x 256 [VC,STAR] matrix on 2x2 beside
   ``torch.linalg.qr``; the ``redist_trace`` label counts of the CALU
   ``lu`` and the TSQR ``qr`` against the pins of the CPU tests; and
   ``path='direct'`` against the chain (bit-equal, timed) for every
   legal pair of a 4096 x 4096 matrix on 2x4;
3j. the resilience layer at full width on the 1x1 grid, float32: the
   checksum-guarded ``lu`` (N = 32768, phase 3b's matrix), ``cholesky``
   (phase 3's) and ``qr`` (65536 x 32768, phase 3c's), each clean (16
   launches of its kernel, the ``abft_report/v1`` gates, the factor gates
   of 3 / 3b / 3c; ``lu`` beside ``lookahead=False``) and recovered from
   a one-shot fault at panel step 1 (17 launches, the factor bit-equal to
   the clean one; ``lu`` under a scaled panel and a NaN on the
   ``redistribute`` target; and a one-element bit flip that the guard's
   threshold misses at nb = 2048, pinned as a miss: a clean report, 16
   launches, a factor unlike the clean one); ``certified_solve`` of
   both ops at N = 32768, nrhs = 8, with the factorization, the solves
   and the host residual timed apart, and through the compute-target
   escalation (NaNs in the first diagonal block of the first two
   factorizations: 'quant', 'fast', 'refine', certified at 'abft'), each
   certificate's backward error under phase 3's solve limit 1e-4;
   ``hpd_solve`` / ``lu_solve`` with ``health=True, info=True`` beside
   phases 3 and 3b;
3k. the tuner on the card, against an empty cache in a temporary
   directory: cold resolutions of every knob ``'auto'`` for ``cholesky``,
   ``lu``, ``qr``, ``trsm``, ``herk`` and ``gemm`` on the 1x1 grid at the
   flagship sizes, each equal to the config the CPU computes for a 'gpu'
   context (:data:`TUNER_PINS`), timed cold and on a memo hit;
   ``hpd_solve`` / ``lu_solve`` / ``least_squares`` with ``nb='auto'`` on
   phase 3 / 3b / 3c's inputs (16 launches of their kernel, bit-equal to
   ``nb=2048``, the gates of 3 / 3b / 3c) and ``cholesky`` with four
   ``'auto'`` knobs (bit-equal to 3's factor); ``gemm(A, B)`` with its
   defaults at 65536 x 512 x 512 (bit-equal to ``alg='dot'``, timed
   beside ``torch.matmul``); the card's full-f32 matmul rate and memory
   beside the tuner's 'gpu' row; and ``measure.search`` of ``cholesky``
   and ``lu`` (top 4, 2 reps) whose winner the next resolution reads
   back from the cache and ``hpd_solve(nb='auto')`` then runs under;
3l. the drivers traced on the card, and the rest of the dense surface:
   phases 3 / 3b / 3c's flagships (same sizes and inputs) each untraced
   and under ``with Tracer():`` (bit-equal, 16 launches, ``op_calls``
   equal to the tracer's driver entries), and each factor untraced and
   with an explicit ``PhaseTimer`` beside the tracer (bit-equal, 16 steps
   with the JAX package's phase names, the phase seconds within 2% of
   the call's synchronized wall time; traced against untraced wall time
   printed; the Perfetto trace written to a temporary directory and its
   events counted); the guarded ``lu`` (phase 3j's matrix) under the
   tracer with ``health=True`` through a one-shot fault at step 1 (one
   ``abft:recover`` span, 17 launches, bit-equal to the clean guarded
   factor) and an unrecovered one (the ``health:*`` instants on the
   ``events`` track); a ``cholesky`` at N = 8192 on a virtual 2x2 grid
   whose traced collective labels equal ``redist_counts()``;
   ``cholesky_pivoted`` of a rank-4096 PSD G G^T at N = 8192 (the rank
   and ||P A P^T - L L^T|| / ||A||), ``cholesky_mod`` with k = 8 up and
   down (each against the Cholesky factor of the modified matrix), the
   BlockMatrix round trip at 32768^2 on a virtual 2x2 grid and a
   BlockMatrix ``gemm`` (bit-equal to the cyclic ones), ``remote_updates``
   of 2^24 updates with duplicates (against a float64 scatter-add,
   entrywise), the ``DistMultiVec`` ``mv_axpy`` / ``mv_dot`` /
   ``mv_nrm2`` at m = 2^27, and every deterministic gallery generator at
   n = 4096 against the same call on the CPU, the device-random ones
   seeded;
3m. serving on the 1x1 grid, f32: (a) ``SolverService`` over 48
   requests in the mix lu : hpd : lstsq = 2 : 2 : 1, n uniform in
   700 ... 4096 (lstsq m = 2n), nrhs = 8, ``max_batch`` 8, warmed over
   every (bucket, slots) geometry, then measured (every request ``ok``
   within its host residual's tol, no graph capture in the measured
   pass; p50 / p99, solves/s, batches, which ops are captured graphs;
   ``batch_peak_bytes`` beside the allocator's peak for the 4096
   buckets); (b) the same requests through ``AsyncSolverService(donate=
   True)`` (solutions bit-equal to (a)'s, ``serve_result/v1`` equal on
   the semantic keys, no capture in the measured window, no worker left
   after ``shutdown``; the pipeline occupancy); (c) ``fastpath=False``
   with ``escalate_nb=2048``: 2 hpd and 2 lu at N = 16384 and one
   lstsq at 16384 x 8192 (each certified, ``potrf_inv`` / ``lu_panel``
   launching N / nb per refactorization, ``qr_panel`` 4 or 5; the share
   of ``certify.py``'s float64 host copies); (d) a measured ``cholesky``
   winner for the n = 4096 bucket in a temporary tuning cache, then 8 hpd
   requests on (a)'s warm service (each routed as ``route_for`` says; 2
   ``potrf_inv`` launches a request on the 'grid' route); (e)
   ``SolverFleet(grids=2, depth=3)`` over the virtual grid's 8 ranks,
   two tenants under quotas, 32 requests of (a)'s mix at n <= 2048,
   traced (every request ``ok`` or a structured quota reject, clean
   timelines, both members used; the SLO p99 and the Chrome event count);
   (f) ``chaos_matrix`` at n = 16 on a virtual 2x2 grid and both replays
   (no silent garbage, replays identical);
3n. the solvers of the long tail on the 1x1 grid, float64 unless said:
   (a) ``lp`` at m = 8192, n = 16384 (Ruiz on, tol :data:`LP_TOL`) of a
   planted complementary pair, so the optimum is known: converged, the
   gap and both feasibilities under the tol, the objective within 1e-6,
   ``potrf_inv`` launched ceil(m / 2048) times a factorization of the
   normal matrix, a second call bit-equal, one normal-matrix ``gemm``
   and one ``cholesky`` timed apart; (b) ``nnls`` at 32768 x 4096 (the
   QP's Cholesky path, 2 launches a factorization) held to the KKT
   conditions on the host; (c) ``rpca`` at 2048 x 1024, rank 10, 5%
   outliers, tol 1e-7 (through ``svd``: ``qr_panel`` and ``potrf_inv``),
   ||L - L0|| / ||L0|| < 1e-5; (d) ``socp_affine`` and ``qp_affine`` at a
   KKT order of ~2048 (``ldl``, no kernel) with the JAX tests' checks;
   (e) ``cg`` on the 2-D Laplacian at 1024^2 unknowns (5.2M nonzeros,
   tol 1e-8, the true residual recomputed on the host), ``spmv`` /
   ``spmv_adjoint`` bit-equal run to run and timed beside their bytes
   floor, ``gmres`` on a convection-diffusion step at 256^2,
   ``sparse_direct_solve`` on the Laplacian at 512^2; (f)
   ``lav_sparse`` at 10000 x 5000 with ``kkt='cg'`` (one captured CG
   graph; two runs bit-equal; replays and host reads a solve) and
   ``kkt='direct'``, ``bp_sparse`` at 5000 x 10000; (g) ``lll`` of a
   knapsack lattice at n = 24 equal to the CPU's, a ``checkpoint`` /
   ``restore`` of an 8192^2 float32 matrix on a virtual 2x2 grid
   (bit-equal), a Matrix Market round trip of (e)'s 512^2 Laplacian;
3o. the static analysis on the card (``elemental_tpu_torch.analysis``):
   (a) every ``cholesky_*``, ``lu_*`` and ``qr*`` registry driver at its
   registry geometry (n = 64, nb = 16, f32) on a CUDA 2x2 virtual grid
   with ``panel_impl='kernel'``: its ``comm_plan/v1`` document byte-equal
   to the CPU's with ``panel_impl='torch'``, and ``potrf_inv``,
   ``lu_panel`` and ``qr_panel`` each launched in the phase; (b) the
   live-bytes meter of ``memory_plan/v1`` (the profiler's allocator
   events) against ``torch.cuda.max_memory_allocated()`` above a warm
   baseline, for ``cholesky_lookahead``, ``lu_crossover`` and ``qr`` on
   2x2 at :data:`METER_GEOMETRY`, within :data:`METER_TOL`; (c) lint
   EL007's 'gpu' row (SMs, opt-in shared memory per block, the static
   shared memory of ``lu_panel``'s column kernel) equal to the kernel's
   own ``lu_panel_smem`` and ``torch.cuda.get_device_properties``;
4. the distributed branches: ``hpd_solve`` and ``lu`` + ``lu_solve_after``
   on a virtual 2x2 grid on the card, N = 1024 float64, nb = 128, with
   and without the crossover, against ``torch.linalg.solve``;
   ``least_squares`` (m = 1536, n = 1024 float64, nb = 128) against
   ``torch.linalg.lstsq``, with ``lq`` and ``rq`` residuals;
   ``herm_eig``, ``skew_herm_eig`` and ``herm_gen_def_eig`` (n = 1024
   float64, nb = 128: the D&C and its distributed merges); every
   ``svd`` route, ``polar`` (tall and wide), ``herm_eig(approach='qdwh')``
   and ``herk`` / ``syrk`` / ``trrk`` in float64 with the JAX tests'
   bounds; every public function of the LDL slice in float64 with the
   JAX tests' inputs and bounds; and ``entry.dryrun_multichip(8)`` on a
   virtual 2x4 grid.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and the one before that the JSON
object of per-kernel numbers.  With no card, or without the package
beside this file, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
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
#: qr_panel's residual ||F - Q R|| / ||F|| and orthogonality ||Q^T Q - I||
#: / sqrt(M) of the CPU tests, scaled with M / 256, and never above
#: QR_RES_CAP; and the relative distance of T from larft(V, tau) of the
#: kernel's own output (atol 1e-5 / 1e-12 at the tests' k <= 64), scaled
#: with k / 64
QR_RES_TOL = {"float32": 3e-6, "float64": 1e-12}
QR_RES_CAP = {"float32": 1e-4, "float64": 1e-10}
QR_T_TOL = {"float32": 1e-5, "float64": 1e-12}

#: phase 3i's redistribution label counts of ``lu(A, nb=2048,
#: panel='calu')`` at N = 32768 and of ``qr(A, nb=2048, panel='tsqr')`` at
#: 65536 x 32768 on the 4x1 grid: 16 panels each, the CALU crossover tail
#: at N / 8.  tests/test_torch_calu.py pins them to the JAX package's
#: trace of the same drivers at the same panel count and crossover ratio.
CALU_LU_COUNTS = {"[MC,MR]->[STAR,STAR]": 15, "[STAR,MR]->[MC,MR]": 14,
                  "[STAR,STAR]->[MC,MR]": 15, "[STAR,STAR]->[MC,STAR]": 14}
TSQR_QR_COUNTS = {"[MC,MR]->[STAR,STAR]": 16, "[STAR,STAR]->[MC,MR]": 16,
                  "[STAR,STAR]->[MC,STAR]": 15}


def wire_totals(log) -> tuple:
    """(collective rounds, wire bytes) a real grid would spend on the
    redistributions of a ``redist_trace`` log (entries whose cost is not
    computed count zero)."""
    return (sum(max(r.rounds, 0) for r in log),
            sum(max(r.wire_bytes, 0) for r in log))


def _labels(log) -> dict:
    out: dict = {}
    for r in log:
        out[r.label] = out.get(r.label, 0) + 1
    return dict(sorted(out.items()))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up
    call unless ``warm`` is False, with CUDA events."""
    import torch
    if warm:
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


def _device_breakdown(fn, top: int = 8, cpu: bool = True) -> dict:
    """One profiled call of ``fn``: its wall time, the device time summed
    per kernel name (the ``top`` largest), and the device's idle share of
    the wall time.  ``cpu=False`` records the device activity only (fewer
    events for a call of ~10^5 launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict = {}
    # the raw device events: building the profiler's per-event Python
    # objects (``prof.events()``) costs ~0.1 ms an event, minutes for the
    # ~10^6 graph nodes of a long call
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name().replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0][:60]
        n, ms = per_kernel.get(name, (0, 0.0))
        per_kernel[name] = (n + 1, ms + ev.duration_ns() / 1e6)
    busy_ms = sum(ms for _, ms in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "top_kernels": [[k, n, ms] for k, (n, ms) in ranked]}


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
    # the main path's block (w = 2048 float32), and the edges of the
    # kernel's blocking: one column, below / at / past one 32-column
    # diagonal block and one 64-row tile, blocks that do not divide w
    for w, dt in ((1, torch.float32), (31, torch.float32),
                  (33, torch.float32), (64, torch.float32),
                  (100, torch.float32), (129, torch.float32),
                  (300, torch.float32), (512, torch.float32),
                  (1000, torch.float32), (2048, torch.float32),
                  (512, torch.float64), (2048, torch.float64)):
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
            # the first panel of phase 3h's determinants
            (8192, 512, torch.float32, 64, True),
            (4096, 512, torch.float32, 64, False),
            (1024, 128, torch.float64, 64, False),
            (32, 8, torch.float32, 4, False),
            # the edges of the 128-column outer block, ragged 48-column
            # chunks, M just below and above the slab grain of 132 x 64
            (1000, 127, torch.float32, 64, False),
            (1000, 128, torch.float32, 48, False),
            (1000, 129, torch.float32, 64, False),
            (2000, 257, torch.float32, 48, False),
            (8447, 300, torch.float32, 64, False),
            (8449, 300, torch.float32, 48, False)):
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


def qr_residuals(F, packed, tau, T):
    """``(||F - Q [R; 0]|| / ||F||, ||Q^T Q - I|| / sqrt(M), Q [R; 0])``
    with Q = I - V T V^T, in float64; ``tests/test_torch_gpu.py`` uses it
    too.  The orthogonality is exact through the k x k Gram G = V^T V:
    Q^T Q - I = V X V^T with X = T^T G T - T - T^T, so its squared norm
    is trace(G X G X^T)."""
    import torch
    from elemental_tpu_torch.kernels.qr_panel import _panel_v
    M, k = F.shape
    P, T = packed.double(), T.double()
    V = _panel_v(P)
    QR = V @ (T @ (V[:k].T @ torch.triu(P[:k])))
    QR.neg_()
    QR[:k] += torch.triu(P[:k])
    F64 = F.double()
    res = float(torch.linalg.norm(F64 - QR) / torch.linalg.norm(F64))
    del F64
    G = V.T @ V
    del V
    X = T.T @ G @ T - T - T.T
    orth = float(torch.trace(G @ X @ G @ X.T).clamp(min=0).sqrt()) / M ** 0.5
    return res, orth, QR


def _qr_panels():
    """(label, panel, path) for phase 2: the least-squares path's first
    panel (path "3c"), the SVD path's panel (path "3e"), the ladder, a
    zero column, graded columns (float64) and a strided view."""
    import torch

    def normal(M, k, dt, seed):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        return torch.randn(M, k, generator=gen, device="cuda", dtype=dt)

    yield "65536x2048", normal(65536, 2048, torch.float32, 1), "3c"
    yield "16384x512", normal(16384, 512, torch.float32, 5), "3e"
    yield "32768x512", normal(32768, 512, torch.float32, 5), None
    yield "40960x512", normal(40960, 512, torch.float32, 6), "3h"
    for dt in (torch.float32, torch.float64):
        for M, k in ((2048, 2048), (4096, 512), (1000, 100), (33, 7)):
            yield f"{M}x{k}", normal(M, k, dt, M + k), None
    # the edges of the blocking: k not a multiple of the 32-column inner
    # chunk or the 128-column outer block, M = k, and M just below and
    # above the slab grain (132 CTAs x 64 rows)
    for M, k in ((1000, 130), (4097, 257), (2048, 300), (300, 300),
                 (8447, 300), (8449, 300)):
        yield f"{M}x{k}", normal(M, k, torch.float32, M + k), None
    Z = normal(4096, 512, torch.float32, 2)
    Z[:, 300] = 0.0
    yield "zero-column", Z, None
    Gd = normal(4096, 512, torch.float64, 3)
    Gd *= torch.logspace(0, -10, 512, device="cuda", dtype=torch.float64)
    yield "graded", Gd, None
    big = normal(5000, 700, torch.float32, 4)
    yield "strided-view", big[7:, 50:562], None


def phase_qr_panel() -> list:
    """``qr_panel`` against its plain version; returns the per-shape rows.
    At the large shapes the packed factors diverge from the plain
    version's in rounding, so the gates are on residuals: the kernel's
    within 4x the plain version's (plus the small-shape tolerance), both
    within the CPU tests' bound scaled with M / 256 and capped at
    QR_RES_CAP, and T within QR_T_TOL * k / 64 of larft(V, tau) of the
    kernel's own output."""
    import torch
    from elemental_tpu_torch.kernels import qr_panel, qr_panel_reference
    from elemental_tpu_torch.kernels.qr_panel import _larft, _panel_v
    rows = []
    for label, P, path in _qr_panels():
        name = str(P.dtype).replace("torch.", "")
        M, k = P.shape
        packed, tau, T = qr_panel(P)
        torch.cuda.synchronize()
        ref, rtau, rT = qr_panel_reference(P)
        rk, ok, QRk = qr_residuals(P, packed, tau, T)
        rp, op, QRp = qr_residuals(P, ref, rtau, rT)
        abs_err = float((QRk - QRp).abs().max())
        del QRk, QRp
        Tl = _larft(_panel_v(packed), tau)
        t_err = float(torch.linalg.norm(T - Tl) / torch.linalg.norm(Tl))
        tau_diff = float((tau - rtau).abs().max())
        tol = min(QR_RES_TOL[name] * max(1.0, M / 256), QR_RES_CAP[name])
        t_tol = QR_T_TOL[name] * max(1.0, k / 64)
        zero_ok = label != "zero-column" or float(tau[300]) == 0.0
        small = QR_RES_TOL[name]
        if not (rk <= tol and ok <= tol and rp <= tol and op <= tol
                and rk <= 4 * rp + small and ok <= 4 * op + small
                and t_err <= t_tol and zero_ok
                and bool(torch.isfinite(packed).all())):
            raise AssertionError(
                f"qr_panel {label} {name}: kernel residual {rk:.3e} / "
                f"orthogonality {ok:.3e}, plain {rp:.3e} / {op:.3e}, "
                f"tolerance {tol:.1e}; T error {t_err:.3e} (tolerance "
                f"{t_tol:.1e}); zero column tau = 0: {zero_ok}")
        reps = 1 if M * k >= 2 ** 24 else 5
        kernel_ms = _time_ms(lambda: qr_panel(P), 3 * reps)
        plain_ms = _time_ms(lambda: qr_panel_reference(P), reps)
        library_ms = _time_ms(lambda: torch.geqrf(P), 3 * reps)
        itemsize = P.element_size()
        # reflectors 2Mk^2 - 2k^3/3; V^T V's upper half over V's unit lower
        # trapezoid Mk^2 - 2k^3/3; T's triangular products k^3/3
        flops = 3 * M * k * k - k ** 3
        flop_ms = flops / PEAK_FLOPS[name] * 1e3
        byte_ms = (2 * M * k + k * k + k) * itemsize / PEAK_BYTES * 1e3
        row = {"panel": label, "M": M, "k": k, "dtype": name,
               "kernel_residual": rk, "kernel_orthogonality": ok,
               "plain_residual": rp, "plain_orthogonality": op,
               "residual_tolerance": tol, "T_rel_err_vs_larft": t_err,
               "T_tolerance": t_tol, "max_tau_diff": tau_diff,
               "max_abs_err": abs_err, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(flop_ms, byte_ms),
               "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
        print("phase 2 qr_panel " + json.dumps(row), flush=True)
        if path == "3c":
            print("phase 2 qr_panel breakdown " + json.dumps(
                _device_breakdown(lambda: qr_panel(P))), flush=True)
        row["path"] = path
        rows.append(row)
        del P, packed, ref, T, rT, Tl
    return rows


def phase_main_path(et, card: str) -> dict:
    """hpd_solve at full width on the 1x1 grid; returns its numbers."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
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
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    X = et.hpd_solve(A, B, nb=nb)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = potrf_inv.launches
    if launches != N // nb or lu_panel.launches or qr_panel.launches:
        raise AssertionError(f"potrf_inv launched {launches} times on the "
                             f"main path, expected {N // nb}; lu_panel "
                             f"{lu_panel.launches}, qr_panel "
                             f"{qr_panel.launches}, expected 0")
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
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
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
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    X = et.lu_solve(A, B, nb=nb)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = lu_panel.launches
    if launches != N // nb or potrf_inv.launches or qr_panel.launches:
        raise AssertionError(f"lu_panel launched {launches} times on the "
                             f"main path, expected {N // nb}; potrf_inv "
                             f"{potrf_inv.launches}, qr_panel "
                             f"{qr_panel.launches}, expected 0")
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


def _ls_gates(et, grid, a, ap, Ap, tau, x, b, gen, blk: int = 8192):
    """The least-squares gates of phases 3c and 3i, reduced in float64
    streaming the global A (``a``) in row blocks: the factor residual
    ||A v - Q (R v)|| / (||A||_F ||v||) with ``ap`` the global packed
    factor, Q's orthogonality ||Q^T (Q z) - z|| / ||z||, and the
    normal-equations optimality ||A^T (B - A X)||_F / (||A|| (||A|| ||X||
    + ||B||)) of the global solution ``x`` and right-hand sides ``b``."""
    import torch
    m, n = a.shape
    x, b = x.double(), b.double()

    def q_times(y, orient):
        Y = et.from_global(y.float(), et.MC, et.MR, grid)
        return et.to_global(et.apply_q(Ap, tau, Y, orient=orient)).double()

    v = torch.randn(n, 1, generator=gen, device="cuda", dtype=torch.float64)
    rv = torch.zeros(m, 1, device="cuda", dtype=torch.float64)
    av = torch.empty(m, 1, device="cuda", dtype=torch.float64)
    norm_a2 = 0.0
    for i0 in range(0, m, blk):
        ab = a[i0:i0 + blk].double()
        av[i0:i0 + blk] = ab @ v
        norm_a2 += float((ab * ab).sum())
        if i0 < n:
            rv[i0:i0 + blk] = torch.triu(ap[i0:i0 + blk].double(),
                                         diagonal=i0) @ v
    norm_a = norm_a2 ** 0.5
    factor_res = float(torch.linalg.norm(av - q_times(rv, "N"))
                       / (norm_a * torch.linalg.norm(v)))
    z = torch.randn(m, 1, generator=gen, device="cuda", dtype=torch.float64)
    qz = q_times(q_times(z.float(), "N"), "C")
    orth = float(torch.linalg.norm(qz - z.float().double())
                 / torch.linalg.norm(z.float().double()))
    atr = torch.zeros(n, x.shape[1], device="cuda", dtype=torch.float64)
    for i0 in range(0, m, blk):
        ab = a[i0:i0 + blk].double()
        atr += ab.T @ (b[i0:i0 + blk] - ab @ x)
    optimality = float(torch.linalg.norm(atr) / (
        norm_a * (norm_a * torch.linalg.norm(x) + torch.linalg.norm(b))))
    return factor_res, orth, optimality


def phase_qr_main_path(et, card: str) -> dict:
    """least_squares at full width on the 1x1 grid; returns its numbers.
    The gates' reductions run in float64, streaming A in row blocks."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    m, n, nb, nrhs = 65536, 32768, 2048, 8
    grid = et.Grid()
    gen = torch.Generator(device="cuda")
    # warm-up at a small size (library handles, the kernel's first launch)
    gen.manual_seed(1)
    Aw = torch.randn(4096, 2048, generator=gen, device="cuda")
    et.least_squares(et.from_global(Aw, et.MC, et.MR, grid),
                     et.from_global(torch.ones(4096, nrhs, device="cuda"),
                                    et.MC, et.MR, grid), nb=nb)
    torch.geqrf(Aw)
    del Aw
    gen.manual_seed(0)
    A = et.from_global(torch.randn(m, n, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    B = et.from_global(torch.randn(m, nrhs, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    X = et.least_squares(A, B, nb=nb)
    torch.cuda.synchronize()
    t_ls = time.perf_counter() - t0
    launches = qr_panel.launches
    if launches != n // nb or potrf_inv.launches or lu_panel.launches:
        raise AssertionError(f"qr_panel launched {launches} times on the "
                             f"main path, expected {n // nb}; potrf_inv "
                             f"{potrf_inv.launches}, lu_panel "
                             f"{lu_panel.launches}, expected 0")
    t0 = time.perf_counter()
    Ap, tau = et.qr(A, nb=nb)
    torch.cuda.synchronize()
    t_qr = time.perf_counter() - t0
    t0 = time.perf_counter()
    et.apply_q(Ap, tau, B, orient="C")
    torch.cuda.synchronize()
    t_apply = time.perf_counter() - t0
    a = A.local
    factor_res, orth, optimality = _ls_gates(et, grid, a, Ap.local, Ap, tau,
                                             X.local, B.local, gen)
    finite = bool(torch.isfinite(X.local).all())
    if not (factor_res < 1e-3 and orth < 1e-4 and optimality < 1e-4
            and finite and tuple(X.local.shape) == (n, nrhs)):
        raise AssertionError(
            f"QR main path: factor residual {factor_res:.3e} (< 1e-3), "
            f"orthogonality {orth:.3e} (< 1e-4), normal-equations "
            f"optimality {optimality:.3e} (< 1e-4), finite {finite}")
    del Ap, tau
    geqrf_ms = _time_ms(lambda: torch.geqrf(a), 1)
    print("phase 3c least_squares breakdown " + json.dumps(
        _device_breakdown(lambda: et.least_squares(A, B, nb=nb), top=14)),
        flush=True)
    out = {"m": m, "n": n, "nb": nb, "nrhs": nrhs, "dtype": "float32",
           "least_squares_s": t_ls, "qr_s": t_qr, "apply_q_s": t_apply,
           "qr_tflops": (2 * m * n ** 2 - 2 * n ** 3 / 3) / t_qr / 1e12,
           "geqrf_ms": geqrf_ms, "qr_panel_launches": launches,
           "factor_residual": factor_res, "orthogonality": orth,
           "normal_equations_optimality": optimality, "card": card}
    print("phase 3c QR main path " + json.dumps(out), flush=True)
    return out


def eig_gates(A, B, X, w, w_ref):
    """Phase 3d's three ratios, each over N eps (float32 eps), computed in
    float64: ``(residual, orthogonality, eigenvalue error)`` with
    residual ||A X - B X diag(w)||_F / ((||A||_F + max|w| ||B||_F) ||X||_F),
    orthogonality ||X^T B X - I||_max and eigenvalue error max|w - w_ref| /
    ||C||_2 (``w_ref`` the float64 eigenvalues of C, so ||C||_2 is their
    largest magnitude).  ``tests/test_torch_gpu.py`` uses it too."""
    import torch
    n = A.shape[0]
    neps = n * torch.finfo(torch.float32).eps
    a, b, x = A.double(), B.double(), X.double()
    wd = w.double()
    bx = b @ x
    r = a @ x
    r -= bx * wd[None, :]
    res = float(torch.linalg.norm(r) / (
        (torch.linalg.norm(a) + wd.abs().max() * torch.linalg.norm(b))
        * torch.linalg.norm(x)))
    del r, a
    g = x.T @ bx
    g.diagonal().sub_(1.0)
    orth = float(g.abs().max())
    del g, bx, b, x
    wr = w_ref.double()
    lam = float((wd - wr).abs().max() / wr.abs().max())
    return res / neps, orth / neps, lam / neps


def _herm_pencil(n: int, seed: int):
    """(A, B): A = (G + G^T) / 2 of a seeded standard normal G, B = bench.py's
    SPD matrix G' G'^T / n + n I from its own seed; float32, on the card."""
    import torch
    B, _ = _spd(n, torch.float32, seed=seed + 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    G = torch.randn(n, n, generator=gen, device="cuda")
    A = G + G.T
    del G
    A.mul_(0.5)
    return A, B


def phase_eig_main_path(et, card: str) -> dict:
    """herm_gen_def_eig at full size on the 1x1 grid: the call timed whole,
    then its steps timed one by one, a profile, the three gates
    and torch.linalg.eigh of the reduced matrix beside it."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    from elemental_tpu_torch.kernels.qr_panel import _larft
    cond = sys.modules["elemental_tpu_torch.lapack.condense"]
    N, nb = 16384, 512
    grid = et.Grid()

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    # warm-up at a small size (library handles, the kernel's first launch,
    # the batched leaf eigh, the library eigensolvers)
    Aw, Bw = _herm_pencil(2048, seed=20)
    et.herm_gen_def_eig(dm(Aw), dm(Bw), nb=nb)
    torch.linalg.eigh(Aw)
    torch.linalg.eigvalsh(Aw.double())
    del Aw, Bw
    Ag, Bg = _herm_pencil(N, seed=10)
    A, B = dm(Ag), dm(Bg)
    del Ag, Bg
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    w, X = et.herm_gen_def_eig(A, B, nb=nb)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = potrf_inv.launches
    if launches != N // nb or lu_panel.launches or qr_panel.launches:
        raise AssertionError(f"potrf_inv launched {launches} times on the "
                             f"eigensolver path, expected {N // nb}; lu_panel "
                             f"{lu_panel.launches}, qr_panel "
                             f"{qr_panel.launches}, expected 0")
    if not (bool(torch.isfinite(X.local).all()) and X.gshape == (N, N)
            and tuple(w.shape) == (N,) and bool((w[1:] >= w[:-1]).all())):
        raise AssertionError("herm_gen_def_eig: X not finite, a shape is "
                             "wrong or w is not ascending")
    del X

    # herm_gen_def_eig's steps, one by one (the calls herm_gen_def_eig and
    # herm_eig make at this size: n > dc_min, so the D&C)
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        return out

    L = step("cholesky_s", lambda: et.cholesky(B, "L", nb=nb))
    C = step("two_sided_trsm_s", lambda: et.two_sided_trsm("L", A, L, nb=nb))
    Ap, d, e, tau = step("hermitian_tridiag_s",
                         lambda: et.hermitian_tridiag(C, nb=nb))
    w2, ZT = step("tridiag_eig_s", lambda: et.tridiag_eig(d, e, grid=grid))
    Z = step("apply_q_herm_tridiag_s",
             lambda: et.apply_q_herm_tridiag(Ap, tau, ZT, nb=nb))
    del ZT
    X = step("trsm_s", lambda: et.trsm("L", "L", "C", L, Z, nb=nb))
    del Z

    # apply_q_herm_tridiag's share spent rebuilding T with _larft
    def larfts():
        for s in range(0, N - 1, nb):
            e_col = min(s + nb, N - 1)
            V = cond._tridiag_v_panel(Ap.local[s:, s:], e_col - s)
            _larft(V, tau[s:e_col])
    step("larft_in_apply_q_s", larfts)
    # bytes the tridiagonal reduction's column loop must read: the
    # whole trailing block of its panel, once a column
    tri_bytes = sum(nb * (N - s) ** 2 * 4 for s in range(0, N - 1, nb))
    tri_floor_s = tri_bytes / PEAK_BYTES
    del Ap, d, e, tau, L

    # gates: the float64 eigenvalues of the port's C, run once, untimed
    t0 = time.perf_counter()
    w_ref = torch.linalg.eigvalsh(C.local.double())
    t_ref = time.perf_counter() - t0
    res, orth, lam = eig_gates(A.local, B.local, X.local, w, w_ref)
    del X, w_ref
    if not (res < 16 and orth < 16 and lam < 16):
        raise AssertionError(f"eigensolver gates: residual {res:.3f}, "
                             f"orthogonality {orth:.3f}, eigenvalues "
                             f"{lam:.3f} (each / (N eps), each < 16)")
    # the library's eigensolver on the reduced matrix, timed beside the path
    eigh_ms = _time_ms(lambda: torch.linalg.eigh(C.local), 1, warm=False)
    del C
    t0 = time.perf_counter()
    prof = _device_breakdown(lambda: et.herm_gen_def_eig(A, B, nb=nb),
                             top=14, cpu=False)
    prof["profile_call_s"] = time.perf_counter() - t0
    prof["idle_share_vs_unprofiled_wall"] = max(
        0.0, 1 - prof["device_busy_ms"] / (t_total * 1e3))
    print("phase 3d herm_gen_def_eig breakdown " + json.dumps(prof),
          flush=True)
    out = {"N": N, "nb": nb, "dtype": "float32",
           "herm_gen_def_eig_s": t_total, **steps,
           "hermitian_tridiag_floor_s": tri_floor_s,
           "hermitian_tridiag_GBps": tri_bytes / steps["hermitian_tridiag_s"] / 1e9,
           "eigh_C_ms": eigh_ms, "eigvalsh_C_float64_s": t_ref,
           "potrf_inv_launches": launches,
           "gate_residual_over_Neps": res, "gate_orthogonality_over_Neps": orth,
           "gate_eigenvalues_over_Neps": lam, "card": card}
    print("phase 3d eigensolver main path " + json.dumps(out), flush=True)
    return out


def svd_gates(A, U, s, V, s_ref):
    """Phase 3e's four ratios, each over n eps (float32 eps), reduced in
    float64: ``(reconstruction, U orthogonality, V orthogonality, singular
    values)`` = ||A - U diag(s) V^T||_F / ||A||_F, ||U^T U - I||_max,
    ||V^T V - I||_max and max|s - s_ref| / max(s_ref).
    ``tests/test_torch_gpu.py`` uses it too."""
    import torch
    n = V.shape[0]
    neps = n * torch.finfo(torch.float32).eps
    u = U.double()
    rec = (u * s.double()[None, :]) @ V.double().T
    rec -= A.double()
    rec_r = float(torch.linalg.norm(rec) / torch.linalg.norm(A.double()))
    del rec
    g = u.T @ u
    del u
    g.diagonal().sub_(1.0)
    orth_u = float(g.abs().max())
    v = V.double()
    g = v.T @ v
    g.diagonal().sub_(1.0)
    orth_v = float(g.abs().max())
    del g, v
    sr = s_ref.double()
    sv = float((s.double() - sr).abs().max() / sr.abs().max())
    return rec_r / neps, orth_u / neps, orth_v / neps, sv / neps


def _svd_matrix(m: int, n: int, seed: int):
    """(A, s0): A = U0 diag(s0) V0^T in float32 on the card, U0 and V0 the
    Q factors (``torch.linalg.qr``: test data, not the port) of seeded
    standard normals, s0 geometric from 1 down to 1e-3 (float64), so the
    reference singular values are known without an SVD."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    U0 = torch.linalg.qr(torch.randn(m, n, generator=gen, device="cuda")).Q
    V0 = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda")).Q
    s0 = torch.logspace(0, -3, n, device="cuda", dtype=torch.float64)
    U0 *= s0.float()[None, :]
    A = U0 @ V0.T
    del U0, V0
    return A, s0


def _qdwh_counts(et, n: int, nb: int, dtype) -> tuple:
    """(qr_panel, potrf_inv) launches that ``svd(A, nb)`` of a tall float32
    (m, n) matrix must make on the 1x1 grid, from the QDWH schedule:
    Chan's ``qr`` and each QR step's ``qr`` of the (2n, n) stack take
    n / nb panels each, each Cholesky step's ``cholesky`` n / nb blocks."""
    funcs = sys.modules["elemental_tpu_torch.lapack.funcs"]
    eps = funcs._eps_of(dtype)
    sched = funcs._qdwh_schedule(eps, 10 * eps)
    n_qr = sum(1 for (_, _, c) in sched if c > 100.0)
    panels = -(-n // nb)
    return panels * (1 + n_qr), panels * (len(sched) - n_qr), n_qr, \
        len(sched) - n_qr


def phase_svd_main_path(et, card: str) -> dict:
    """svd at 16384 x 8192 on the 1x1 grid (the Chan route: qr, the QDWH
    polar of R, herm_eig of H, a gemm and apply_q): the call timed whole,
    then its steps one by one, a device profile of polar, the four gates
    and torch.linalg.svd timed beside it."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    funcs = sys.modules["elemental_tpu_torch.lapack.funcs"]
    m, n, nb = 16384, 8192, 512
    grid = et.Grid()

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    # warm-up at a small size (library handles, the kernels' first
    # launches, the eigensolver's batched leaves)
    Aw, _ = _svd_matrix(4096, 2048, seed=31)
    et.svd(dm(Aw), nb=nb)
    del Aw
    Ag, s0 = _svd_matrix(m, n, seed=30)
    A = dm(Ag)
    want_qr, want_potrf, n_qr, n_chol = _qdwh_counts(et, n, nb,
                                                      torch.float32)
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    U, s, V = et.svd(A, nb=nb)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = {"qr_panel": qr_panel.launches,
                "potrf_inv": potrf_inv.launches, "lu_panel": lu_panel.launches}
    if launches != {"qr_panel": want_qr, "potrf_inv": want_potrf,
                    "lu_panel": 0}:
        raise AssertionError(f"svd launches {launches}, expected qr_panel "
                             f"{want_qr}, potrf_inv {want_potrf}, lu_panel 0")
    if not (bool(torch.isfinite(U.local).all())
            and bool(torch.isfinite(V.local).all())
            and U.gshape == (m, n) and V.gshape == (n, n)
            and tuple(s.shape) == (n,) and bool((s[1:] <= s[:-1]).all())):
        raise AssertionError("svd: U or V not finite, a shape is wrong or s "
                             "is not descending")
    rec, orth_u, orth_v, sv = svd_gates(Ag, U.local, s, V.local, s0)
    del U, V, s
    if not (rec < 16 and orth_u < 16 and orth_v < 16 and sv < 16):
        raise AssertionError(f"svd gates: reconstruction {rec:.3f}, U "
                             f"orthogonality {orth_u:.3f}, V orthogonality "
                             f"{orth_v:.3f}, singular values {sv:.3f} "
                             "(each / (n eps), each < 16)")

    # the call's steps, one by one (what svd -> _svd_polar -> polar run)
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = steps.get(name, 0.0) + time.perf_counter() - t
        return out

    Ap, tau = step("qr_s", lambda: et.qr(A, nb=nb))
    R = et.make_trapezoidal(et.interior_view(Ap, (0, n), (0, n)), "U")

    def polar_steps():
        eps = funcs._eps_of(torch.float32)
        alpha = float(torch.sqrt(et.one_norm(R) * et.infinity_norm(R)))
        X = R.with_local(R.local / alpha)
        for i, (a, b, c) in enumerate(funcs._qdwh_schedule(eps, 10 * eps)):
            if c > 100.0:
                X = step("polar_qr_steps_s", lambda: funcs._qdwh_step_qr(
                    X, a, b, c, nb, None))
            elif "polar_chol_steps_s" in steps:
                X = step("polar_chol_steps_s", lambda: funcs._qdwh_step_chol(
                    X, a, b, c, nb, None))
            else:
                X = step("polar_chol_steps_s", lambda: chol_parts(X, a, b, c))
        H = step("polar_H_s", lambda: funcs._hermitianize(et.gemm(
            X, R, orient_a="C", alg="dot", nb=nb)))
        return X, H

    def chol_parts(X, a, b, c):
        # the first Cholesky step split at its calls; a right-side trsm
        # transposes its operand twice through redistribute
        Z = step("chol_step_herk_s", lambda: et.herk(
            "L", X, alpha=c, orient="C", nb=nb))
        W = step("chol_step_cholesky_s", lambda: et.cholesky(
            et.shift_diagonal(Z, 1), "L", nb=nb))
        del Z
        B = step("chol_step_trsm_R_s", lambda: et.trsm(
            "R", "L", "C", W, X, nb=nb))
        B = step("chol_step_trsm_R_s", lambda: et.trsm(
            "R", "L", "N", W, B, nb=nb))
        return X.with_local(B.local.mul_(a - b / c).add_(X.local,
                                                        alpha=b / c))

    Up, H = polar_steps()
    # one of the four transposes of an operand that the first Cholesky
    # step's two right-side trsm make
    step("chol_step_one_transpose_s", lambda: et.redistribute(
        et.transpose_dist(Up), et.MC, et.MR))
    steps["polar_s"] = (steps["polar_qr_steps_s"]
                        + steps["polar_chol_steps_s"] + steps["polar_H_s"])
    w, Vh = step("herm_eig_s", lambda: et.herm_eig(H, "L", True, nb=nb))
    del H
    order = torch.argsort(-w, stable=True)
    Vd = step("permute_cols_s", lambda: et.permute_cols(Vh, order))
    del Vh
    UR = step("gemm_s", lambda: et.gemm(Up, Vd, alg="dot"))
    del Up, Vd
    step("apply_q_s", lambda: et.apply_q(Ap, tau, et.pad_matrix(UR, m, n),
                                         nb=nb))
    del UR, Ap, tau

    # torch.linalg.svd of A, timed beside the path (the port never calls
    # it)
    lib_ms = _time_ms(lambda: torch.linalg.svd(Ag, full_matrices=False), 1,
                      warm=False)
    # a device profile of polar alone, and its idle share
    t0 = time.perf_counter()
    et.polar(R, nb=nb)
    torch.cuda.synchronize()
    t_polar = time.perf_counter() - t0
    prof = _device_breakdown(lambda: et.polar(R, nb=nb), top=14, cpu=False)
    prof["unprofiled_polar_s"] = t_polar
    prof["idle_share_vs_unprofiled_wall"] = max(
        0.0, 1 - prof["device_busy_ms"] / (t_polar * 1e3))
    print("phase 3e polar breakdown " + json.dumps(prof), flush=True)
    del R, A, Ag
    out = {"m": m, "n": n, "nb": nb, "dtype": "float32", "route": "chan",
           "qdwh_qr_steps": n_qr, "qdwh_chol_steps": n_chol,
           "svd_s": t_total, **steps, "torch_linalg_svd_ms": lib_ms,
           "qr_panel_launches": launches["qr_panel"],
           "potrf_inv_launches": launches["potrf_inv"],
           "lu_panel_launches": launches["lu_panel"],
           "gate_reconstruction_over_neps": rec,
           "gate_U_orthogonality_over_neps": orth_u,
           "gate_V_orthogonality_over_neps": orth_v,
           "gate_singular_values_over_neps": sv, "card": card}
    print("phase 3e svd main path " + json.dumps(out), flush=True)
    return out


def phase_svd_rest(et, card: str) -> dict:
    """The rest of the slice on the card at n = 4096 float32, each timed:
    herm_eig(approach='qdwh'), svd(approach='golub') at 8192 x 4096,
    polar of a square matrix and sign of a symmetric indefinite one."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    n, nb = 4096, 512
    grid = et.Grid()
    neps = n * torch.finfo(torch.float32).eps

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    def timed(fn):
        potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, {
            "qr_panel": qr_panel.launches, "potrf_inv": potrf_inv.launches,
            "lu_panel": lu_panel.launches}

    out = {"n": n, "nb": nb, "dtype": "float32"}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(40)
    G = torch.randn(n, n, generator=gen, device="cuda")
    F = (G + G.T) / 2
    (w, Z), t, cnt = timed(lambda: et.herm_eig(dm(F), nb=nb,
                                               approach="qdwh"))
    eye = torch.eye(n, device="cuda")
    res, orth, lam = eig_gates(F, eye, Z.local, w,
                               torch.linalg.eigvalsh(F.double()))
    del Z
    out["herm_eig_qdwh"] = {"s": t, "launches": cnt,
                            "gate_residual_over_neps": res,
                            "gate_orthogonality_over_neps": orth,
                            "gate_eigenvalues_over_neps": lam}
    if not (res < 16 and orth < 16 and lam < 16 and cnt["potrf_inv"] > 0
            and cnt["qr_panel"] > 0):
        raise AssertionError(f"herm_eig qdwh: {out['herm_eig_qdwh']}")

    Ag, s0 = _svd_matrix(2 * n, n, seed=41)
    (U, s, V), t, cnt = timed(lambda: et.svd(dm(Ag), nb=nb,
                                             approach="golub"))
    gates = svd_gates(Ag, U.local, s, V.local, s0)
    del U, V, Ag
    out["svd_golub"] = {"m": 2 * n, "s": t, "launches": cnt,
                        "gates_over_neps": gates}
    if not max(gates) < 16:
        raise AssertionError(f"svd golub: {out['svd_golub']}")

    Gs = torch.randn(n, n, generator=gen, device="cuda")
    (Up, H), t, cnt = timed(lambda: et.polar(dm(Gs), nb=nb))
    u = Up.local.double()
    g = u.T @ u
    g.diagonal().sub_(1.0)
    orth = float(g.abs().max()) / neps
    res = float(torch.linalg.norm(Gs.double() - u @ H.local.double())
                / torch.linalg.norm(Gs.double())) / neps
    del u, g, Up, H
    out["polar_square"] = {"s": t, "launches": cnt,
                           "gate_orthogonality_over_neps": orth,
                           "gate_residual_over_neps": res}
    if not (orth < 16 and res < 16):
        raise AssertionError(f"polar: {out['polar_square']}")

    Q = torch.linalg.qr(torch.randn(n, n, generator=gen, device="cuda")).Q
    d = torch.rand(n, generator=gen, device="cuda") * 1.5 + 0.5
    d[n // 2:] *= -1
    Sa = (Q * d[None, :]) @ Q.T
    Sa = (Sa + Sa.T) / 2
    Sg, t, cnt = timed(lambda: et.sign(dm(Sa), nb=nb))
    sd = Sg.local.double()
    res = float((sd @ sd - torch.eye(n, device="cuda",
                                      dtype=torch.float64)).abs().max()) / neps
    out["sign"] = {"s": t, "launches": cnt, "gate_S2_minus_I_over_neps": res}
    if not (res < 16 and cnt["lu_panel"] > 0):
        raise AssertionError(f"sign: {out['sign']}")
    out["card"] = card
    print("phase 3f svd slice " + json.dumps(out), flush=True)
    return out


def _kkt(n: int, p: int, seed: int):
    """K = [[H, J^T], [J, 0]] in float32 on the card: H = G G^T / n + I with
    G n x n and J p x n standard normal from a seeded generator, the
    saddle-point matrix of an equality-constrained quadratic program (an
    interior-point or SQP step).  Its inertia is (n, p, 0) by Sylvester's
    law.  The lower triangle is mirrored so that K is exactly symmetric."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    N = n + p
    K = torch.zeros(N, N, device="cuda")
    G = torch.randn(n, n, generator=gen, device="cuda")
    H = G @ G.T
    del G
    H.div_(n)
    H.diagonal().add_(1.0)
    K[:n, :n] = H
    del H
    J = torch.randn(p, n, generator=gen, device="cuda")
    K[n:, :n] = J
    del J
    K.tril_()
    K += torch.tril(K, -1).T
    return K, gen


def _ldl_gates(K, Lp, d, e, perm, X, B, gen):
    """Phase 3g's two residuals, reduced in float64: the factor residual
    ||P K P^T v - L (D (L^T v))|| / (||K||_F ||v||) and the solve residual
    ||K X - B||_F / (||K||_F ||X||_F).  ``tests/test_torch_gpu.py`` uses
    it too."""
    import torch
    N = K.shape[0]
    f64 = torch.float64
    k = K.double()
    norm_k = torch.linalg.norm(k)
    v = torch.randn(N, 1, generator=gen, device="cuda", dtype=f64)
    u = torch.zeros_like(v)
    u[perm] = v
    pkp_v = (k @ u)[perm]
    solve_res = float(torch.linalg.norm(k @ X.double() - B.double())
                      / (norm_k * torch.linalg.norm(X.double())))
    del k, u
    low = torch.tril(Lp.double(), -1)
    t = low.T @ v + v
    ed = e.double()
    z = d.double()[:, None] * t
    z[:-1] += ed[:, None] * t[1:]
    z[1:] += ed[:, None] * t[:-1]
    ldl_v = low @ z + z
    factor_res = float(torch.linalg.norm(pkp_v - ldl_v)
                       / (norm_k * torch.linalg.norm(v)))
    return factor_res, solve_res


def phase_ldl_main_path(et, card: str) -> dict:
    """symmetric_solve of a KKT saddle-point system at full width on the 1x1
    grid: the call timed whole, then ldl and ldl_solve_after, the three
    gates, torch.linalg.ldl_factor + ldl_solve beside it, and a device
    profile of the same call at N = 8192."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    n, p, nb, nrhs = 24576, 8192, 512, 8
    N = n + p
    grid = et.Grid()

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    def library(K, B):
        LD, piv = torch.linalg.ldl_factor(K)
        return torch.linalg.ldl_solve(LD, piv, B)

    # warm-up at N = 2048 (library handles, the CUDA graph of the column)
    Kw, gen = _kkt(1536, 512, seed=71)
    Bw = torch.randn(2048, nrhs, generator=gen, device="cuda")
    et.symmetric_solve(dm(Kw), dm(Bw), nb=nb)
    library(Kw, Bw)
    del Kw, Bw
    Kg, gen = _kkt(n, p, seed=70)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    K, B = dm(Kg), dm(Bg)
    torch.cuda.synchronize()
    potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
    t0 = time.perf_counter()
    X = et.symmetric_solve(K, B, nb=nb)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = {"potrf_inv": potrf_inv.launches, "lu_panel": lu_panel.launches,
                "qr_panel": qr_panel.launches}
    if any(launches.values()):
        raise AssertionError(f"symmetric_solve launched {launches}; ldl has "
                             "no panel kernel, expected 0 each")
    del X
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Lp, d, e, perm = et.ldl(K, conjugate=False, nb=nb)
    torch.cuda.synchronize()
    t_ldl = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = et.ldl_solve_after(Lp, d, e, perm, B, conjugate=False, nb=nb)
    torch.cuda.synchronize()
    t_after = time.perf_counter() - t0
    x = X.local
    if not (bool(torch.isfinite(x).all()) and tuple(x.shape) == (N, nrhs)
            and bool(torch.isfinite(Lp.local).all())):
        raise AssertionError("ldl: X or L not finite, or a shape is wrong")
    n22 = int((e != 0).sum())
    max_l = float(torch.tril(Lp.local, -1).abs().max())
    counts = et.inertia(d, e)
    factor_res, solve_res = _ldl_gates(Kg, Lp.local, d, e, perm, x, Bg, gen)
    del Lp, X, x
    if not (factor_res < 1e-3 and solve_res < 1e-4 and counts == (n, p, 0)):
        raise AssertionError(f"ldl gates: factor residual {factor_res:.3e} "
                             f"(< 1e-3), solve residual {solve_res:.3e} "
                             f"(< 1e-4), inertia {counts} (== {(n, p, 0)})")
    # the library's Bunch-Kaufman (cuSOLVER sytrf) beside the path
    t0 = time.perf_counter()
    LD, piv = torch.linalg.ldl_factor(Kg)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.linalg.ldl_solve(LD, piv, Bg)
    torch.cuda.synchronize()
    lib_solve_s = time.perf_counter() - t0
    del LD, piv, K, B, Kg, Bg
    # a device profile of the same call at N = 8192 (at 32768 the profile's
    # post-processing of ~10^6 graph-node events would take minutes)
    K8, gen8 = _kkt(6144, 2048, seed=72)
    B8 = torch.randn(8192, nrhs, generator=gen8, device="cuda")
    K8d, B8d = dm(K8), dm(B8)
    et.symmetric_solve(K8d, B8d, nb=nb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    et.symmetric_solve(K8d, B8d, nb=nb)
    torch.cuda.synchronize()
    t8 = time.perf_counter() - t0
    prof = _device_breakdown(lambda: et.symmetric_solve(K8d, B8d, nb=nb),
                             top=14, cpu=False)
    prof["N"] = 8192
    prof["unprofiled_symmetric_solve_s"] = t8
    prof["idle_share_vs_unprofiled_wall"] = max(
        0.0, 1 - prof["device_busy_ms"] / (t8 * 1e3))
    print("phase 3g symmetric_solve breakdown " + json.dumps(prof),
          flush=True)
    out = {"N": N, "n": n, "p": p, "nb": nb, "nrhs": nrhs, "dtype": "float32",
           "symmetric_solve_s": t_total, "ldl_s": t_ldl,
           "ldl_solve_after_s": t_after,
           "torch_ldl_factor_s": lib_factor_s,
           "torch_ldl_solve_s": lib_solve_s, "pivots_2x2": n22,
           "max_abs_L": max_l, "inertia": list(counts),
           "factor_residual": factor_res, "solve_residual": solve_res,
           "idle_share_N8192": prof["idle_share_vs_unprofiled_wall"],
           **{f"{k}_launches": v for k, v in launches.items()}, "card": card}
    print("phase 3g ldl main path " + json.dumps(out), flush=True)
    return out


def _polar_counts(n: int, nb: int, dtype) -> tuple:
    """(qr_panel, potrf_inv) launches of ``svd`` of a square float32 n x n
    matrix on the 1x1 grid (the polar route, no Chan QR): the QDWH
    schedule's QR steps take n / nb panels each, its Cholesky steps n / nb
    blocks each."""
    _, _, n_qr, n_chol = _qdwh_counts(None, n, nb, dtype)
    panels = -(-n // nb)
    return panels * n_qr, panels * n_chol


def _householder(m: int, gen):
    """A unit vector from a seeded generator: H = I - 2 u u^T."""
    import torch
    u = torch.randn(m, 1, generator=gen, device="cuda")
    return u / torch.linalg.norm(u)


def _known_sv_matrix(m: int, n: int, s0, gen):
    """A = H1 [diag(s0); 0] H2 (float32) with H1, H2 Householder
    reflectors: singular values exactly s0, formed in O(m n)."""
    import torch
    u, v = _householder(m, gen), _householder(n, gen)
    A = torch.zeros(m, n, device="cuda")
    A[:n].diagonal().copy_(s0.float())
    A -= 2 * u @ (u[:n].T * s0.float()[None, :])
    A -= 2 * (A @ v) @ v.T
    return A


def _quasi_upper(n: int, gen):
    """A synthetic upper quasi-triangular T (float32): triu(G) / sqrt(n) + 4 I
    with an isolated 2x2 bump [a b; -b a] at every 37th row."""
    import torch
    T = torch.triu(torch.randn(n, n, generator=gen, device="cuda")) / n ** 0.5
    T.diagonal().add_(4.0)
    for q in range(0, n - 1, 37):
        T[q + 1, q + 1] = T[q, q]
        T[q, q + 1] = 1.5
        T[q + 1, q] = -1.5
    return T


def phase_ldl_rest(et, card: str) -> dict:
    """The rest of the slice on the 1x1 grid, each step timed with its
    kernel launches against the count the driver's blocking predicts, and
    gated by the JAX test's own check of the function over n eps
    (float32; pseudospectra against the JAX test's own 1e-3)."""
    import torch
    funcs = sys.modules["elemental_tpu_torch.lapack.funcs"]
    nb = 512
    eps = torch.finfo(torch.float32).eps
    gen = torch.Generator(device="cuda")
    gen.manual_seed(80)
    lu_calls = [0]
    real_lu_solve = funcs.lu_solve

    def counted_lu_solve(*a, **k):
        lu_calls[0] += 1
        return real_lu_solve(*a, **k)

    out = {"nb": nb, "dtype": "float32"}
    funcs.lu_solve = counted_lu_solve
    try:
        _ldl_rest_steps(et, out, nb, eps, gen, lu_calls)
    finally:
        funcs.lu_solve = real_lu_solve
    out["card"] = card
    print("phase 3h ldl slice " + json.dumps(
        {k: v for k, v in out.items() if not isinstance(v, dict)}),
        flush=True)
    return out


def _ldl_rest_steps(et, out: dict, nb: int, eps: float, gen,
                    lu_calls: list) -> None:
    """Phase 3h's steps, each recorded in ``out``; ``lu_calls[0]`` counts
    the calls of ``lu_solve`` (the sign iteration's), zeroed per step."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    grid = et.Grid()
    f64 = torch.float64
    nrm = torch.linalg.norm

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def panels(n):
        return -(-n // nb)

    def over(v, n):
        """A gate: the JAX test's own quantity over n eps, limit 16."""
        return (float(v) / (n * eps), 16.0)

    def run(name, fn, expect, gates_of):
        """Time ``fn`` with every count at 0; check its launches against
        ``expect`` (a dict, or a callable for counts that follow a
        data-dependent iteration) and its gates, (value, bound) pairs: a
        float holds if below its bound, anything else if equal to it."""
        potrf_inv.launches = lu_panel.launches = qr_panel.launches = 0
        lu_calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {"potrf_inv": potrf_inv.launches, "lu_panel": lu_panel.launches,
               "qr_panel": qr_panel.launches}
        want = {"potrf_inv": 0, "lu_panel": 0, "qr_panel": 0}
        want.update(expect() if callable(expect) else expect)
        gates = gates_of(res)
        row = {"s": dt, "launches": got, "lu_solve_calls": lu_calls[0],
               "value_bound": gates}
        out[name] = row
        print(f"phase 3h {name} " + json.dumps(row), flush=True)
        bad = [k for k, (v, bound) in gates.items()
               if not (v < bound if isinstance(v, float) else v == bound)]
        if got != want or bad:
            raise AssertionError(f"{name}: launches {got} (expected {want}), "
                                 f"failed gates {bad}: {row}")
        return res

    # lse: a KKT system solved with ldl (gemm + ldl, no panel kernel)
    m, n, p = 16384, 6144, 2048
    A, b, C, d = rnd(m, n), rnd(m, 1), rnd(p, n), rnd(p, 1)

    def lse_gates(x):
        x, a, c, bb, dd = (v.double() for v in (x.local, A, C, b, d))
        g = a.T @ (bb - a @ x)
        lam = torch.linalg.lstsq(c.T, g).solution
        return {"constraint": over(nrm(c @ x - dd)
                                   / (nrm(c) * nrm(x) + nrm(dd)), n),
                "optimality": over(nrm(g - c.T @ lam) / (
                    nrm(a) * (nrm(a) * nrm(x) + nrm(bb))), n)}
    run("lse", lambda: et.lse(dm(A), dm(b), dm(C), dm(d), nb=nb), {},
        lse_gates)
    del A, b, C, d

    # glm: two Cholesky factorizations (W = B B^T: m / nb blocks; M: n / nb)
    m, n, k = 8192, 2048, 12288
    A, Bm, d = rnd(m, n), rnd(m, k), rnd(m, 1)

    def glm_gates(xy):
        x, y = (v.local.double() for v in xy)
        a, bm, dd = A.double(), Bm.double(), d.double()
        z = torch.linalg.solve(bm @ bm.T, dd - a @ x)
        return {"consistency": over(nrm(a @ x + bm @ y - dd) / (
                    nrm(a) * nrm(x) + nrm(bm) * nrm(y) + nrm(dd)), m),
                "gls_optimality": over(nrm(a.T @ z) / (nrm(a) * nrm(z)), m)}
    run("glm", lambda: et.glm(dm(A), dm(Bm), dm(d), nb=nb),
        {"potrf_inv": panels(m) + panels(n)}, glm_gates)
    del A, Bm, d

    # ridge and tikhonov: the stacked least-squares problem through qr
    m, n = 32768, 8192
    A, b = rnd(m, n), rnd(m, 8)
    Gt = rnd(n, n) * 0.1

    def stacked_gates(x, gram):
        x, a, bb = x.local.double(), A.double(), b.double()
        g = a.T @ (bb - a @ x) - gram(x)
        return {"normal_equations": over(nrm(g) / (
            nrm(a) * (nrm(a) * nrm(x) + nrm(bb))), n)}
    run("ridge", lambda: et.ridge(dm(A), dm(b), 1.5, nb=nb),
        {"qr_panel": panels(n)},
        lambda x: stacked_gates(x, lambda v: 1.5 ** 2 * v))
    run("tikhonov", lambda: et.tikhonov(dm(A), dm(b), dm(Gt), nb=nb),
        {"qr_panel": panels(n)},
        lambda x: stacked_gates(x, lambda v: Gt.double().T
                                @ (Gt.double() @ v)))
    del A, b, Gt

    # the determinants at N = 8192, scaled so that |det| ~ 1 fits float32
    n = 8192
    Ad = rnd(n, n) / n ** 0.5
    Ad.diagonal().add_(2.0)
    Ad /= float(torch.exp(torch.linalg.slogdet(Ad.double())[1] / n))
    sgn, logabs = (float(v) for v in torch.linalg.slogdet(Ad.double()))
    ref = sgn * math.exp(logabs)
    run("determinant", lambda: et.determinant(dm(Ad), nb=nb),
        {"lu_panel": panels(n)},
        lambda det: {"relative_error": over(abs(float(det) - ref)
                                            / abs(ref), n)})
    run("safe_determinant", lambda: et.safe_determinant(dm(Ad), nb=nb),
        {"lu_panel": panels(n)},
        lambda r: {"rho": over(abs(float(r[0]) - sgn), n),
                   "n_kappa_vs_slogdet": over(abs(float(r[1]) * r[2]
                                                  - logabs), n)})
    del Ad
    G = rnd(n, n)
    Ah = G @ G.T
    del G
    Ah.div_(n)
    Ah.diagonal().add_(1.0)
    Ah /= float(torch.exp(torch.linalg.slogdet(Ah.double())[1] / n))
    ref = math.exp(float(torch.linalg.slogdet(Ah.double())[1]))
    run("hpd_determinant", lambda: et.hpd_determinant(dm(Ah), nb=nb),
        {"potrf_inv": panels(n)},
        lambda det: {"relative_error": over(abs(float(det) - ref) / ref, n)})
    del Ah

    # condition, two_norm, nuclear_norm through svd (the polar route):
    # A = U0 diag(s0) V0^T, s0 geometric from 1 to 1e-3
    n = 4096
    Asv, s0 = _svd_matrix(n, n, seed=81)
    want_qr, want_potrf = _polar_counts(n, nb, torch.float32)
    svd_counts = {"qr_panel": want_qr, "potrf_inv": want_potrf}
    cond0, nuc0 = float(s0[0] / s0[-1]), float(s0.sum())
    run("condition", lambda: et.condition(dm(Asv), nb=nb), svd_counts,
        lambda c: {"relative_error": over(abs(float(c) - cond0) / cond0, n)})
    run("two_norm", lambda: et.two_norm(dm(Asv), nb=nb), svd_counts,
        lambda s: {"relative_error": over(abs(float(s) - 1.0), n)})
    run("nuclear_norm", lambda: et.nuclear_norm(dm(Asv), nb=nb), svd_counts,
        lambda s: {"relative_error": over(abs(float(s) - nuc0) / nuc0, n)})
    del Asv

    # two_norm_estimate: singular values known, s0[0] = 1 set apart from
    # the rest (<= 0.5) so that its 20 power steps converge
    m, n = 32768, 16384
    s0 = torch.cat([torch.ones(1, device="cuda", dtype=f64),
                    0.5 * torch.logspace(0, -3, n - 1, device="cuda",
                                         dtype=f64)])
    Aest = _known_sv_matrix(m, n, s0, gen)
    run("two_norm_estimate", lambda: et.two_norm_estimate(dm(Aest)), {},
        lambda est: {"relative_error": over(abs(float(est) - 1.0), n)})
    del Aest

    # qr_col_piv: residual through apply_q and the greedy order of R
    m, n = 8192, 4096
    Aq = rnd(m, n)

    def cpqr_gates(res):
        Ap, tau, jpvt = res
        R = torch.zeros(m, n, device="cuda")
        R[:n] = torch.triu(Ap.local[:n])
        QR = et.apply_q(Ap, tau, dm(R), orient="N").local.double()
        rd = Ap.local.diagonal().abs().double()
        return {"residual": over(nrm(QR - Aq[:, jpvt].double())
                                 / nrm(Aq.double()), n),
                "greedy_order": over((rd[1:] - rd[:-1]).clamp_min(0).max()
                                     / rd[0], n)}
    run("qr_col_piv", lambda: et.qr_col_piv(dm(Aq), nb=nb), {}, cpqr_gates)
    del Aq

    # lu_full_pivot
    n = 2048
    Al = rnd(n, n)

    def lufp_gates(res):
        LU, rp, cp = res
        lu_ = LU.local.double()
        L = torch.tril(lu_, -1) + torch.eye(n, device="cuda", dtype=f64)
        return {"residual": over(nrm(L @ torch.triu(lu_)
                                     - Al.double()[rp][:, cp])
                                 / nrm(Al.double()), n),
                "L_bounded_by_1": (bool(L.abs().max() <= 1.0), True)}
    run("lu_full_pivot", lambda: et.lu_full_pivot(dm(Al)), {}, lufp_gates)
    del Al

    # schur, triang_eig and eig of a complex64 matrix (the plain paths);
    # the reference eigenvalues from the host's LAPACK in complex128.  At
    # n = 512 schur and eig took ~22 s and ~19 s (74 complex LU solves
    # each), so n = 256 keeps 3g and 3h near 100 s
    n = 256
    c128 = torch.complex128
    Ac = torch.complex(rnd(n, n), rnd(n, n)) / 2 ** 0.5
    ev_ref = torch.linalg.eigvals(Ac.cpu().to(c128)).cuda()

    def schur_gates(res):
        T, Q = res
        t, q, a = (x.to(c128) for x in (T.local, Q.local, Ac))
        eye = torch.eye(n, device="cuda", dtype=c128)
        dist = (ev_ref[:, None] - torch.diagonal(t)[None, :]).abs()
        return {"strictly_lower_zero": (bool((torch.tril(t, -1) == 0).all()),
                                        True),
                "reconstruction": over(nrm(a - q @ t @ q.mH) / nrm(a), n),
                "orthogonality": over((q.mH @ q - eye).abs().max(), n),
                "eigenvalues": over(dist.min(dim=1).values.max()
                                    / ev_ref.abs().max(), n)}
    T, Q = run("schur", lambda: et.schur(dm(Ac), nb=nb), {}, schur_gates)
    del Q
    Tt = T.local.to(c128)

    def triang_gates(res):
        w, V = res
        v = V.local.to(c128)
        r = Tt @ v - v * w.to(c128)[None, :]
        return {"residual": over(nrm(r, dim=0).max() / nrm(Tt), n)}
    run("triang_eig", lambda: et.triang_eig(T, nb=nb), {}, triang_gates)
    del T, Tt

    def eig_gates_(res):
        w, V = res
        v, a = V.local.to(c128), Ac.to(c128)
        return {"residual": over(nrm(a @ v - v * w.to(c128)[None, :])
                                 / nrm(a), n)}
    run("eig", lambda: et.eig(dm(Ac), nb=nb), {}, eig_gates_)
    del Ac

    # pseudospectra on a 20 x 20 window inside the spectrum's disk (radius
    # ~sqrt(n)): sigma_min(A - z I) against the float64 singular values at
    # every tenth shift (the JAX test's 1e-3)
    n = 256
    Aps = rnd(n, n)
    r = 0.69 * n ** 0.5

    def pspec_gates(res):
        Z, sm = res
        z = torch.as_tensor(Z.reshape(-1)[::10], device="cuda")
        shifted = Aps.to(c128)[None] - z[:, None, None] * torch.eye(
            n, device="cuda", dtype=c128)
        direct = torch.linalg.svdvals(shifted)[:, -1].cpu().numpy()
        rel = abs(sm.reshape(-1)[::10] - direct) / direct.clip(min=1e-12)
        return {"max_relative_error": (float(rel.max()), 1e-3)}
    run("pseudospectra", lambda: et.pseudospectra(
        dm(Aps), (-r, r), (-r, r), nx=20, ny=20, nb=nb), {}, pspec_gates)
    del Aps

    # the control solvers, on the sign function (lu_panel through
    # lu_solve: the count follows the Newton iteration, so lu_solve's calls
    # are counted and each factors the 2n x 2n block matrix in 2n / nb
    # panels)
    n = 2048
    As = rnd(n, n) / n ** 0.5
    As.diagonal().sub_(2.0)
    Bs = rnd(n, n) / n ** 0.5
    Bs.diagonal().sub_(2.0)
    Cs = rnd(n, n)
    Cl = Cs + Cs.T
    Ar = rnd(n, n) / n ** 0.5
    Bk = rnd(n, n // 4) / (n // 4) ** 0.5
    Gr = Bk @ Bk.T
    Qr = rnd(n, n)
    Qr = Qr @ Qr.T / n
    Qr.diagonal().add_(1.0)
    del Bk

    def sign_lus():
        return {"lu_panel": lu_calls[0] * panels(2 * n)}

    def residual(X, lhs, rhs):
        x = X.local.double()
        return {"residual": over(nrm(lhs(x) - rhs.double())
                                 / nrm(rhs.double()), n)}
    a, bs, ar, g = As.double(), Bs.double(), Ar.double(), Gr.double()
    run("sylvester", lambda: et.sylvester(dm(As), dm(Bs), dm(Cs), nb=nb),
        sign_lus, lambda X: residual(X, lambda x: a @ x + x @ bs, Cs))
    run("lyapunov", lambda: et.lyapunov(dm(As), dm(Cl), nb=nb),
        sign_lus, lambda X: residual(X, lambda x: a @ x + x @ a.T, Cl))

    # the Riccati residual over the size of its terms (the JAX test's
    # residual over ||Q|| alone grows with ||X||^2 ||G|| in float32)
    def ric_gates(X):
        x, q = X.local.double(), Qr.double()
        r = ar.T @ x + x @ ar + q - x @ g @ x
        return {"residual": over(nrm(r) / (
            nrm(q) + 2 * nrm(ar) * nrm(x) + nrm(g) * nrm(x) ** 2), n)}
    run("riccati", lambda: et.riccati(dm(Ar), dm(Gr), dm(Qr), nb=nb),
        lambda: {"lu_panel": lu_calls[0] * panels(2 * n),
                 "qr_panel": panels(n)}, ric_gates)
    del As, Bs, Cs, Cl, Ar, Gr, Qr, a, bs, ar, g

    # hemm and her2k at 16384, each beside torch.matmul of the same product
    n = 16384
    Ah, Bh = rnd(n, n), rnd(n, n)
    S = torch.tril(Ah) + torch.tril(Ah, -1).T
    ref = S @ Bh
    out["hemm_torch_matmul_ms"] = _time_ms(lambda: S @ Bh, 1)
    del S
    run("hemm", lambda: et.hemm("L", "L", dm(Ah), dm(Bh)), {},
        lambda Cm: {"vs_matmul": over(nrm(Cm.local - ref) / nrm(ref), n)})
    del ref
    Ak, Bk = Ah[:, : n // 4].contiguous(), Bh[:, : n // 4].contiguous()
    del Ah, Bh
    out["her2k_torch_matmul_ms"] = _time_ms(lambda: Ak @ Bk.T + Bk @ Ak.T, 1)
    ref = torch.tril(Ak @ Bk.T + Bk @ Ak.T)
    run("her2k", lambda: et.her2k("L", dm(Ak), dm(Bk), nb=nb), {},
        lambda Cm: {"vs_matmul": over(nrm(torch.tril(Cm.local) - ref)
                                      / nrm(ref), n)})
    del Ak, Bk, ref

    # quasi_trsm and multishift_trsm (1024 real shifts in [-1, 1])
    n = 8192
    Tq = _quasi_upper(n, gen)
    Bq = rnd(n, 512)

    def quasi_gates(X):
        x, t = X.local.double(), Tq.double()
        return {"residual": over(nrm(t @ x - Bq.double())
                                 / (nrm(t) * nrm(x)), n)}
    run("quasi_trsm", lambda: et.quasi_trsm("L", "N", dm(Tq), dm(Bq), nb=nb),
        {}, quasi_gates)
    del Tq, Bq
    n, k = 4096, 1024
    Tm = torch.triu(rnd(n, n)) / n ** 0.5
    Tm.diagonal().add_(4.0)
    Bm = rnd(n, k)
    sh = torch.rand(k, generator=gen, device="cuda") * 2 - 1

    def ms_gates(X):
        x, t, bb = X.local.double(), Tm.double(), Bm.double()
        r = t @ x - x * sh.double()[None, :] - bb
        return {"residual": over((nrm(r, dim=0) / (
            nrm(t) * nrm(x, dim=0) + nrm(bb, dim=0))).max(), n)}
    run("multishift_trsm", lambda: et.multishift_trsm(
        "U", "N", dm(Tm), sh, dm(Bm)), {}, ms_gates)

def phase_eig_distributed(et) -> None:
    """herm_eig (its D&C branch and the distributed merges: n > dc_min =
    repl_max = 512), skew_herm_eig and herm_gen_def_eig on a virtual 2x2
    grid on the card, float64.  The bounds are those of the JAX package's
    tests of its D&C (tests/lapack/test_tridiag_eig.py:93-110: eigenvalues
    1e-9, residual 1e-10, orthogonality 1e-10 n), which the JAX package
    itself meets at this size with ~3.3e-11 (test_spectral.py's 1e-12 is
    set at n = 24, where herm_eig takes the dense eigh)."""
    import torch
    n, nb = 1024, 128
    grid = et.Grid(2, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    G = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    F = (G + G.T) / 2
    S = G - G.T
    Gb = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    Bm = Gb @ Gb.T / n + 2 * torch.eye(n, device="cuda", dtype=torch.float64)
    eye = torch.eye(n, device="cuda", dtype=torch.float64)

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    w, Z = et.herm_eig(dm(F), nb=nb)
    z = et.to_global(Z)
    wn = torch.linalg.eigvalsh(F)
    eig_err = float((w - wn).abs().max())
    eig_res = float(torch.linalg.norm(F @ z - z * w[None, :]) / torch.linalg.norm(F))
    eig_orth = float(torch.linalg.norm(z.T @ z - eye))
    ws, Zs = et.skew_herm_eig(dm(S), nb=nb)
    zs = et.to_global(Zs)
    # the general eigensolver's reference runs on the host (no MAGMA needed)
    imag_ref = torch.sort(torch.linalg.eigvals(S.cpu()).imag).values.cuda()
    skew_err = float((ws - imag_ref).abs().max())
    skew_res = float(torch.linalg.norm(S.to(zs.dtype) @ zs - zs * (1j * ws)[None, :])
                     / torch.linalg.norm(S))
    wg, Xg = et.herm_gen_def_eig(dm(F), dm(Bm), nb=nb)
    x = et.to_global(Xg)
    gen_res = float(torch.linalg.norm(F @ x - Bm @ x * wg[None, :])
                    / torch.linalg.norm(F))
    gen_orth = float(torch.linalg.norm(x.T @ Bm @ x - eye))
    torch.cuda.synchronize()
    row = {"grid": "2x2", "n": n, "nb": nb, "dtype": "float64",
           "herm_eig_eigenvalue_error": eig_err, "herm_eig_residual": eig_res,
           "herm_eig_orthogonality": eig_orth,
           "skew_herm_eig_error": skew_err, "skew_herm_eig_residual": skew_res,
           "herm_gen_def_eig_residual": gen_res,
           "herm_gen_def_eig_orthogonality": gen_orth}
    if not (eig_err < 1e-9 and eig_res < 1e-10 and eig_orth < 1e-10 * n
            and skew_err < 1e-9 and skew_res < 1e-10
            and gen_res < 1e-10 and gen_orth < 1e-10):
        raise AssertionError(f"eigensolvers on the 2x2 grid: {row}")
    print("phase 4 eigensolvers distributed " + json.dumps(row), flush=True)


def phase_svd_distributed(et) -> None:
    """svd (every route), polar (tall and wide), herm_eig(approach='qdwh')
    and herk / syrk / trrk on a virtual 2x2 grid on the card, float64,
    with the bounds of the JAX package's tests (tests/lapack/
    test_spectral.py::_check_svd / _check_eig, tests/lapack/
    test_funcs.py, tests/blas/test_level3.py)."""
    import torch
    grid = et.Grid(2, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    f64 = torch.float64

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=f64)

    def check_svd(F, U, s, V, sv):
        """tests/lapack/test_spectral.py::_check_svd and
        ::test_svd_values_only as (value, bound) pairs."""
        sn = torch.linalg.svdvals(F)
        k = s.shape[0]
        smax = max(float(sn[0]), 1.0)
        Ug, Vg = et.to_global(U), et.to_global(V)
        eye = torch.eye(k, device="cuda", dtype=f64)
        return {"s": (float((s - sn[:k]).abs().max()) / smax, 1e-12),
                "rec": (float(torch.linalg.norm((Ug * s[None, :]) @ Vg.T - F)
                              / torch.linalg.norm(F)), 1e-12),
                "orth_u": (float(torch.linalg.norm(Ug.T @ Ug - eye)) / k,
                           1e-12),
                "orth_v": (float(torch.linalg.norm(Vg.T @ Vg - eye)) / k,
                           1e-12),
                "values_only": (float((sv - sn).abs().max()) / smax, 1e-12)}

    rows = {}
    for name, shape, kw in (("chan", (480, 192), {"approach": "chan"}),
                            ("auto_tall", (480, 192), {}),
                            ("polar", (256, 256), {"approach": "polar"}),
                            ("golub", (300, 200), {"approach": "golub"}),
                            ("local", (200, 120), {"approach": "local"}),
                            ("wide", (192, 320), {}),
                            ("eig_qdwh", (256, 256),
                             {"approach": "polar", "eig_approach": "qdwh"})):
        F = rnd(*shape)
        U, s, V = et.svd(dm(F), nb=64, **kw)
        sv = et.svd(dm(F), vectors=False, nb=64, **kw)
        rows[name] = check_svd(F, U, s, V, sv)
    # tests/lapack/test_funcs.py::test_polar_tall_wide_complex
    for shape, rec_bound in (((384, 256), 1e-14), ((256, 384), 1e-13)):
        F = rnd(*shape)
        U, H = et.polar(dm(F), nb=64)
        Ug, Hg = et.to_global(U), et.to_global(H)
        k = min(shape)
        eye = torch.eye(k, device="cuda", dtype=f64)
        gram = Ug.T @ Ug if shape[0] >= shape[1] else Ug @ Ug.T
        rows[f"polar_{shape[0]}x{shape[1]}"] = {
            "orth": (float(torch.linalg.norm(gram - eye)), 1e-13),
            "rec": (float(torch.linalg.norm(Ug @ Hg - F)
                          / torch.linalg.norm(F)), rec_bound)}
    # tests/lapack/test_spectral.py::_check_eig
    n = 256
    G = rnd(n, n)
    F = (G + G.T) / 2
    w, Z = et.herm_eig(dm(F), nb=64, approach="qdwh")
    Zg = et.to_global(Z)
    wn = torch.linalg.eigvalsh(F)
    rows["herm_eig_qdwh"] = {
        "w": (float(torch.linalg.norm(w - wn) / torch.linalg.norm(wn)), 1e-12),
        "res": (float(torch.linalg.norm(F @ Zg - Zg * w[None, :])
                      / torch.linalg.norm(F)), 1e-12),
        "orth": (float(torch.linalg.norm(Zg.T @ Zg - torch.eye(
            n, device="cuda", dtype=f64))) / n, 1e-12)}
    # tests/blas/test_level3.py::test_herk / test_syrk / test_trrk: the
    # triangle to rtol 1e-12, the other strict triangle C's exactly
    m, k = 180, 100
    X, C0 = rnd(m, k), rnd(m, m)
    tri_err, other = 0.0, 0.0
    for uplo in ("L", "U"):
        tri = torch.tril if uplo == "L" else torch.triu
        anti = (lambda x: torch.triu(x, 1)) if uplo == "L" \
            else (lambda x: torch.tril(x, -1))
        for orient, Xo in (("N", X), ("C", X.T.contiguous())):
            got = et.to_global(et.herk(uplo, dm(Xo), alpha=2.0, beta=0.5,
                                       C=dm(C0), orient=orient, nb=32))
            want = 2.0 * X @ X.T + 0.5 * C0
            tri_err = max(tri_err, float((tri(got) - tri(want)).abs().max()
                                         / want.abs().max()))
            other = max(other, float((anti(got) - anti(C0)).abs().max()))
    got = et.to_global(et.syrk("L", dm(X), nb=32))
    tri_err = max(tri_err, float((torch.tril(got) - torch.tril(X @ X.T))
                                 .abs().max() / (X @ X.T).abs().max()))
    Amc = et.redistribute(dm(X), et.MC, et.STAR)
    Bmr = et.redistribute(dm(X.T.contiguous()), et.STAR, et.MR)
    got = et.to_global(et.trrk("U", 1.5, Amc, Bmr, 2.0, dm(C0)))
    want = 1.5 * X @ X.T + 2.0 * C0
    tri_err = max(tri_err, float((torch.triu(got) - torch.triu(want))
                                 .abs().max() / want.abs().max()))
    other = max(other, float((torch.tril(got, -1) - torch.tril(C0, -1))
                             .abs().max()))
    rows["herk_syrk_trrk"] = {"triangle": (tri_err, 1e-12),
                              "other_triangle": (other, 0.0)}
    torch.cuda.synchronize()
    print("phase 4 svd distributed " + json.dumps(
        {"grid": "2x2", "dtype": "float64",
         "value_bound": rows}), flush=True)
    bad = {name: {k: vb for k, vb in row.items() if not vb[0] <= vb[1]}
           for name, row in rows.items()}
    bad = {name: row for name, row in bad.items() if row}
    if bad:
        raise AssertionError(f"svd slice on the 2x2 grid: {bad}")
def phase_ldl_distributed(et) -> None:
    """Every public function of the LDL slice on a virtual 2x2 grid on the
    card, float64, with the bounds of the JAX package's tests (tests/
    lapack/test_ldl.py, test_euclidean_min.py, test_props.py,
    test_schur.py, test_qr.py, test_variants.py, tests/control/
    test_control.py, tests/blas/test_level3_ext.py) as (value, bound)
    pairs; a float holds if below its bound, anything else if equal."""
    import numpy as np
    import scipy.linalg
    import torch
    grid = et.Grid(2, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    f64, c128 = torch.float64, torch.complex128
    nrm = torch.linalg.norm

    def dm(x):
        return et.from_global(x, et.MC, et.MR, grid)

    def g(A):
        return et.to_global(A)

    def rnd(*shape, dtype=f64):
        if dtype.is_complex:
            return torch.complex(rnd(*shape), rnd(*shape))
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def sym(n, dtype=f64):
        G = rnd(n, n, dtype=dtype)
        return (G + G.mH) / 2

    def eye(n, dtype=f64):
        return torch.eye(n, device="cuda", dtype=dtype)

    def from_np(x):
        return torch.as_tensor(x, device="cuda")

    def np_sym(n, seed, cplx=False):
        """tests/lapack/test_ldl.py::_sym, the JAX tests' own inputs."""
        rng = np.random.default_rng(seed)
        if cplx:
            G = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
            return from_np((G + G.conj().T) / 2)
        G = rng.normal(size=(n, n))
        return from_np((G + G.T) / 2)

    rows = {}
    # ldl: reconstruction, solves, inertia (test_ldl.py's inputs and bounds)
    stress = np_sym(24, 4)
    stress.diagonal().fill_(1e-12)                # pervasive 2x2 pivots
    rec = {}
    for name, M, conj, bound in (("symmetric", np_sym(24, 0), False, 1e-13),
                                 ("pivot_stress", stress, False, 1e-12),
                                 ("hermitian", np_sym(16, 2, True), True,
                                  1e-13)):
        Lp, d, e, perm = et.ldl(dm(M), conjugate=conj, nb=8)
        L = torch.tril(g(Lp), -1) + eye(M.shape[0], M.dtype)
        D = torch.diag(d.to(M.dtype))
        D += torch.diag(e.to(M.dtype), -1)
        D += torch.diag(e.to(M.dtype).conj() if conj else e.to(M.dtype), 1)
        R = L @ D @ (L.mH if conj else L.mT)
        rec[name] = (float(nrm(R - M[perm][:, perm]) / nrm(M)), bound)
    rows["ldl"] = rec
    rng = np.random.default_rng(5)
    F, B = np_sym(24, 5), from_np(rng.normal(size=(24, 3)))
    X = g(et.symmetric_solve(dm(F), dm(B), nb=8))
    rng = np.random.default_rng(6)
    Fh = np_sym(16, 6, True)
    Bc = from_np(rng.normal(size=(16, 3)) + 1j * rng.normal(size=(16, 3)))
    Xh = g(et.hermitian_solve(dm(Fh), dm(Bc), nb=8))
    F7 = np_sym(24, 7)
    _, d, e, _ = et.ldl(dm(F7), conjugate=False, nb=8)
    w = torch.linalg.eigvalsh(F7)
    rows["solves"] = {
        "symmetric_solve": (float(nrm(F @ X - B) / nrm(B)), 1e-12),
        "hermitian_solve": (float(nrm(Fh @ Xh - Bc) / nrm(Bc)), 1e-12),
        "inertia": (list(et.inertia(d, e)),
                    [int((w > 0).sum()), int((w < 0).sum()), 0])}
    # euclidean_min (test_euclidean_min.py)
    A, b, C, dd = rnd(80, 32), rnd(80, 2), rnd(12, 32), rnd(12, 2)
    Gt = rnd(20, 32)
    x = g(et.ridge(dm(A), dm(b), 1.5, nb=16))
    ridge_ref = torch.linalg.solve(A.T @ A + 2.25 * eye(32), A.T @ b)
    xt = g(et.tikhonov(dm(A), dm(b), dm(Gt), nb=16))
    tik_ref = torch.linalg.solve(A.T @ A + Gt.T @ Gt, A.T @ b)
    xl = g(et.lse(dm(A), dm(b), dm(C), dm(dd), nb=16))
    K = torch.zeros(44, 44, device="cuda", dtype=f64)
    K[:32, :32], K[:32, 32:], K[32:, :32] = A.T @ A, C.T, C
    lse_ref = torch.linalg.solve(K, torch.cat([A.T @ b, dd]))[:32]
    Ag, Bg, dg = rnd(48, 16), rnd(48, 48), rnd(48, 1)
    xg, yg = (g(v) for v in et.glm(dm(Ag), dm(Bg), dm(dg), nb=16))
    Wi = torch.linalg.inv(Bg @ Bg.T)
    glm_ref = torch.linalg.solve(Ag.T @ Wi @ Ag, Ag.T @ Wi @ dg)
    rows["euclidean_min"] = {
        "ridge": (float(nrm(x - ridge_ref)), 1e-12),
        "tikhonov": (float(nrm(xt - tik_ref)), 1e-12),
        "lse": (float(nrm(xl - lse_ref)), 1e-11),
        "lse_constraint": (float(nrm(C @ xl - dd)), 1e-12),
        "glm_consistency": (float(nrm(Ag @ xg + Bg @ yg - dg)), 1e-12),
        "glm": (float(nrm(xg - glm_ref)), 1e-10)}
    # props (test_props.py)
    Fd = rnd(48, 48)
    sgn, logabs = torch.linalg.slogdet(Fd)
    det_ref = float(sgn * torch.exp(logabs))
    rho, kappa, nn = et.safe_determinant(dm(Fd * 1e3), nb=16)
    sgn3, logabs3 = torch.linalg.slogdet(Fd * 1e3)
    Gh = rnd(48, 48)
    Hp = Gh @ Gh.T / 48 + 2 * eye(48)
    Fe = from_np(np.random.default_rng(4).normal(size=(16, 10)))
    sv = torch.linalg.svdvals(Fe)
    Fc = rnd(40, 40)
    Fsym = sym(56)
    wsym = torch.linalg.eigvalsh(Fsym)
    rows["props"] = {
        "determinant": (abs(float(et.determinant(dm(Fd), nb=16)) - det_ref)
                        / abs(det_ref), 1e-12),
        "safe_determinant_rho": (abs(float(rho) - float(sgn3)), 1e-10),
        "safe_determinant_kappa": (abs(float(kappa) * nn - float(logabs3)),
                                   1e-8),
        "hpd_determinant": (abs(float(et.hpd_determinant(dm(Hp), nb=16))
                                - float(torch.linalg.det(Hp)))
                            / float(torch.linalg.det(Hp)), 1e-12),
        "two_norm_estimate": (abs(float(et.two_norm_estimate(
            dm(Fe), iters=40)) - float(sv[0])) / float(sv[0]), 1e-6),
        "condition_two": (abs(float(et.condition(dm(Fc), "two", nb=16))
                              - float(torch.linalg.cond(Fc)))
                          / float(torch.linalg.cond(Fc)), 1e-10),
        "condition_one": (abs(float(et.condition(dm(Fc), "one", nb=16))
                              - float(torch.linalg.cond(Fc, 1)))
                          / float(torch.linalg.cond(Fc, 1)), 1e-10),
        "nuclear_norm": (abs(float(et.nuclear_norm(dm(Fe), nb=16))
                             - float(sv.sum())), 1e-10),
        "two_norm": (abs(float(et.two_norm(dm(Fe), nb=16)) - float(sv[0])),
                     1e-11),
        "schatten_norm": (abs(float(et.schatten_norm(dm(Fe), 3.0, nb=16))
                              - float((sv ** 3).sum() ** (1 / 3))), 1e-10),
        "matrix_inertia": (list(et.lapack.matrix_inertia(dm(Fsym), nb=16)),
                           [int((wsym > 0).sum()), int((wsym < 0).sum()),
                            0])}
    # qr_col_piv and lu_full_pivot (test_qr.py, test_variants.py)
    Fq = rnd(64, 48)
    Ap, tau, jpvt = et.qr_col_piv(dm(Fq), nb=16)
    R = torch.zeros(64, 48, device="cuda", dtype=f64)
    R[:48] = torch.triu(g(Ap)[:48])
    QR = g(et.apply_q(Ap, tau, dm(R), orient="N"))
    rd = torch.diagonal(g(Ap)).abs()
    Fl = rnd(57, 57)
    LU, rp, cp = et.lu_full_pivot(dm(Fl))
    lug = g(LU)
    L = torch.tril(lug, -1) + eye(57)
    rows["pivoting"] = {
        "qr_col_piv": (float(nrm(QR - Fq[:, jpvt]) / nrm(Fq)), 1e-13),
        "qr_col_piv_greedy": (float((rd[1:] - rd[:-1]).max()), 1e-10),
        "lu_full_pivot": (float((L @ torch.triu(lug) - Fl[rp][:, cp])
                                .abs().max()), 1e-9),
        "lu_full_pivot_L_bound": (float(L.abs().max()), 1 + 1e-12)}
    # schur, triang_eig, eig, pseudospectra (test_schur.py)
    Fs_ = rnd(64, 64)
    T, Q = et.schur(dm(Fs_), base=16, nb=16)
    Tg, Qg = g(T), g(Q)
    evs = torch.linalg.eigvals(Fs_.cpu()).cuda()
    dist = (evs[:, None] - torch.diagonal(Tg)[None, :]).abs()
    w, V = et.triang_eig(T, nb=16)
    Vg = g(V)
    r_te = nrm(Tg @ Vg - Vg * w[None, :], dim=0).max() / nrm(Tg)
    we, Ve = et.eig(dm(Fs_), base=16, nb=16)
    Veg = g(Ve)
    Fp = rnd(32, 32)
    Z, sm = et.pseudospectra(dm(Fp), (-3, 3), (-3, 3), nx=4, ny=4, iters=14,
                             base=64)
    zz = torch.as_tensor(Z.reshape(-1), device="cuda")
    direct = torch.linalg.svdvals(Fp.to(c128)[None] - zz[:, None, None]
                                  * eye(32, c128))[:, -1].cpu().numpy()
    rows["schur"] = {
        "strictly_lower_zero": (bool((torch.tril(Tg, -1) == 0).all()),
                                True),
        "orthogonality": (float(nrm(Qg.mH @ Qg - eye(64, c128))), 1e-12 * 64),
        "reconstruction": (float(nrm(Fs_ - Qg @ Tg @ Qg.mH) / nrm(Fs_)),
                           1e-12),
        "eigenvalues": (float(dist.min(dim=1).values.max()
                              / max(float(evs.abs().max()), 1.0)), 1e-10),
        "triang_eig": (float(r_te), 1e-12),
        "eig": (float(nrm(Fs_.to(c128) @ Veg - Veg * we[None, :])
                      / nrm(Fs_)), 1e-11),
        "pseudospectra": (float(np.max(np.abs(sm.reshape(-1) - direct)
                                       / np.maximum(direct, 1e-12))), 1e-3)}
    # sylvester, lyapunov, riccati (test_control.py's inputs, bounds and
    # scipy's solutions)
    def stable(rng, n):
        M = rng.normal(size=(n, n))
        return M - (np.abs(np.linalg.eigvals(M).real).max() + 1) * np.eye(n)
    rng = np.random.default_rng(0)
    As_, Bs_ = stable(rng, 12), stable(rng, 8)
    Cs_ = rng.normal(size=(12, 8))
    Xs_ref = from_np(scipy.linalg.solve_sylvester(As_, Bs_, Cs_))
    As_, Bs_, Cs_ = from_np(As_), from_np(Bs_), from_np(Cs_)
    Xs = g(et.sylvester(dm(As_), dm(Bs_), dm(Cs_)))
    rng = np.random.default_rng(1)
    Al_ = from_np(stable(rng, 12))
    Cl = from_np(rng.normal(size=(12, 12)))
    Cl = Cl + Cl.T
    Xl = g(et.lyapunov(dm(Al_), dm(Cl)))
    rng = np.random.default_rng(2)
    Ar, Bk = rng.normal(size=(8, 8)), rng.normal(size=(8, 3))
    Qr = rng.normal(size=(8, 8))
    Qr = Qr @ Qr.T / 8 + np.eye(8)
    Xr_ref = from_np(scipy.linalg.solve_continuous_are(Ar, Bk, Qr, np.eye(3)))
    Ar, Bk, Qr = from_np(Ar), from_np(Bk), from_np(Qr)
    Xr = g(et.riccati(dm(Ar), dm(Bk @ Bk.T), dm(Qr)))
    rows["control"] = {
        "sylvester": (float(nrm(As_ @ Xs + Xs @ Bs_ - Cs_) / nrm(Cs_)),
                      1e-12),
        "sylvester_vs_scipy": (float(nrm(Xs - Xs_ref) / nrm(Xs_ref)), 1e-12),
        "lyapunov": (float(nrm(Al_ @ Xl + Xl @ Al_.T - Cl) / nrm(Cl)),
                     1e-12),
        "riccati": (float(nrm(Ar.T @ Xr + Xr @ Ar + Qr - Xr @ Bk @ Bk.T @ Xr)
                          / nrm(Qr)), 1e-10),
        "riccati_vs_scipy": (float(nrm(Xr - Xr_ref) / nrm(Xr_ref)), 1e-10)}
    # the rest of the level-3 BLAS (test_level3_ext.py, test_variants.py)
    Ah_, Bh_, C0 = rnd(40, 24, dtype=c128), rnd(40, 24, dtype=c128), \
        rnd(40, 40, dtype=c128)
    a = 0.7 - 0.2j
    got = g(et.her2k("L", dm(Ah_), dm(Bh_), alpha=a, beta=0.5, C=dm(C0),
                     nb=8))
    want = a * Ah_ @ Bh_.mH + np.conj(a) * Bh_ @ Ah_.mH + 0.5 * C0
    Hm = rnd(40, 40, dtype=c128)
    Hm = Hm + Hm.mH
    Bm_ = rnd(40, 16, dtype=c128)
    got_hemm = g(et.hemm("L", "L", dm(torch.tril(Hm)), dm(Bm_), alpha=1.25))
    Sm = rnd(40, 40, dtype=c128)
    Sm = Sm + Sm.T
    got_symm = g(et.symm("L", "U", dm(torch.triu(Sm)), dm(Bm_)))
    Ta, Tb, Tc, Td = rnd(40, 16), rnd(16, 40), rnd(40, 16), rnd(16, 40)
    E0 = rnd(40, 40)
    got_trr2k = g(et.trr2k("L", 2.0, et.redistribute(dm(Ta), et.MC, et.STAR),
                           et.redistribute(dm(Tb), et.STAR, et.MR), -1.0,
                           et.redistribute(dm(Tc), et.MC, et.STAR),
                           et.redistribute(dm(Td), et.STAR, et.MR), 0.5,
                           dm(E0)))
    want_trr2k = 2.0 * Ta @ Tb - Tc @ Td + 0.5 * E0
    Tq = torch.triu(rnd(74, 74)) + 3 * eye(74)
    for q in range(0, 72, 9):
        Tq[q + 1, q + 1], Tq[q, q + 1], Tq[q + 1, q] = Tq[q, q], 1.5, -1.5
    Bq = rnd(74, 5)
    Xq = g(et.quasi_trsm("L", "N", dm(Tq), dm(Bq), nb=8))
    Tms = torch.triu(rnd(48, 48, dtype=c128)) + 4 * eye(48, c128)
    Bms = rnd(48, 14, dtype=c128)
    shifts = rnd(14, dtype=c128) * 0.5
    Xms = g(et.multishift_trsm("U", "C", dm(Tms), shifts, dm(Bms), nb=8))
    ms_res = max(float(nrm((Tms.mH - shifts[j] * eye(48, c128)) @ Xms[:, j]
                           - Bms[:, j])) for j in range(14))
    rows["level3"] = {
        "her2k": (float(nrm(torch.tril(got) - torch.tril(want))
                        / nrm(torch.tril(want))), 1e-11),
        "her2k_other_triangle": (bool((torch.triu(got, 1)
                                       == torch.triu(C0, 1)).all()), True),
        "hemm": (float(nrm(got_hemm - 1.25 * Hm @ Bm_) / nrm(Hm @ Bm_)),
                 1e-11),
        "symm": (float(nrm(got_symm - Sm @ Bm_) / nrm(Sm @ Bm_)), 1e-11),
        "trr2k": (float(nrm(torch.tril(got_trr2k) - torch.tril(want_trr2k))
                        / nrm(torch.tril(want_trr2k))), 1e-12),
        "quasi_trsm": (float((Xq - torch.linalg.solve(Tq, Bq)).abs().max()),
                       1e-9),
        "multishift_trsm": (ms_res, 1e-10)}
    torch.cuda.synchronize()
    print("phase 4 ldl slice distributed " + json.dumps(
        {"grid": "2x2", "dtype": "float64", "value_bound": rows}),
        flush=True)
    bad = {name: {k: vb for k, vb in row.items()
                  if not (vb[0] < vb[1] if isinstance(vb[0], float)
                          else vb[0] == vb[1])}
           for name, row in rows.items()}
    bad = {name: row for name, row in bad.items() if row}
    if bad:
        raise AssertionError(f"LDL slice on the 2x2 grid: {bad}")


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


def phase_qr_distributed(et) -> None:
    """least_squares, lq and rq on a virtual 2x2 grid on the card, float64,
    against torch.linalg.lstsq and their own reconstructions."""
    import torch
    from elemental_tpu_torch.kernels import qr_panel
    m, n, nb, nrhs = 1536, 1024, 128, 4
    grid = et.Grid(2, 2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    Ag = torch.randn(m, n, generator=gen, device="cuda", dtype=torch.float64)
    Bg = torch.randn(m, nrhs, generator=gen, device="cuda",
                     dtype=torch.float64)
    ref = torch.linalg.lstsq(Ag, Bg).solution
    qr_panel.launches = 0
    X = et.least_squares(et.from_global(Ag, et.MC, et.MR, grid),
                         et.from_global(Bg, et.MC, et.MR, grid), nb=nb)
    x = et.to_global(X)
    torch.cuda.synchronize()
    launches = qr_panel.launches
    err = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
    # lq and rq of the wide transpose
    W = et.from_global(Ag.T.contiguous(), et.MC, et.MR, grid)
    packed, tau = et.lq(W, nb=nb)
    L = et.to_global(et.explicit_l(packed))
    Q = et.to_global(et.apply_q_lq(packed, tau, et.identity(
        m, grid=grid, dtype=torch.float64)))
    norm_w = torch.linalg.norm(Ag)
    lq_res = float(torch.linalg.norm(Ag.T - L @ Q[:n]) / norm_w)
    R, Qr = et.rq(W, nb=nb)
    rq_res = float(torch.linalg.norm(Ag.T - et.to_global(R)
                                     @ et.to_global(Qr)) / norm_w)
    torch.cuda.synchronize()
    if launches != n // nb or not (err < 1e-10 and lq_res < 1e-12
                                   and rq_res < 1e-12):
        raise AssertionError(f"QR 2x2 grid: launches {launches}, error "
                             f"{err:.3e}, lq residual {lq_res:.3e}, rq "
                             f"residual {rq_res:.3e}")
    print("phase 4 QR distributed " + json.dumps(
        {"grid": "2x2", "m": m, "n": n, "nb": nb, "dtype": "float64",
         "qr_panel_launches": launches, "rel_error_vs_torch_lstsq": err,
         "lq_residual": lq_res, "rq_residual": rq_res}), flush=True)


def _counts_now(lu_panel, potrf_inv, qr_panel) -> dict:
    return {"lu_panel": lu_panel.launches, "potrf_inv": potrf_inv.launches,
            "qr_panel": qr_panel.launches}


def _lu_gates(et, Ag, LU, perm, X, Bg, gen):
    """Phase 3b's gates on global tensors: bench.py's factor residual
    ||A[perm] v - L (U v)|| / (||A||_F ||v||), HPL's scaled residual per
    right-hand side, and the growth max|U| / max|A|."""
    import torch
    N = Ag.shape[0]
    lu_ = et.to_global(LU)
    v = torch.randn(N, 1, generator=gen, device="cuda")
    uv = torch.triu(lu_) @ v
    luv = torch.tril(lu_, -1) @ uv + uv
    factor_res = float(torch.linalg.norm(Ag[perm] @ v - luv)
                       / (torch.linalg.norm(Ag) * torch.linalg.norm(v)))
    growth = float(torch.triu(lu_).abs().max() / Ag.abs().max())
    del lu_, uv, luv
    out = {"factor_residual": factor_res, "growth": growth}
    if X is not None:
        x = et.to_global(X)
        eps = torch.finfo(torch.float32).eps
        norm_a = float(Ag.abs().sum(dim=1).max())
        r = (Ag @ x - Bg).abs().amax(dim=0)
        out["hpl_scaled_residuals"] = (r / (
            eps * (norm_a * x.abs().amax(dim=0) + Bg.abs().amax(dim=0))
            * N)).tolist()
        out["finite"] = bool(torch.isfinite(x).all())
    return out


def phase_calu_tsqr(et, card: str, lu_path: dict, qr_path: dict) -> dict:
    """CALU and TSQR at full width on virtual grids on the card, f32:
    ``lu_solve(panel='calu')`` at N = 32768 on 4x1 (phase 3b's matrix),
    the same ``lu`` over the int8 wire, ``qr(panel='tsqr')`` + the
    least-squares solve at 65536 x 32768 on 4x1 (phase 3c's matrix), the
    standalone ``tsqr`` of a 4194304 x 256 [VC,STAR] matrix on 2x2, and
    ``path='direct'`` against the chain for every legal pair on 2x4."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    from elemental_tpu_torch.redist import engine
    kern = (lu_panel, potrf_inv, qr_panel)

    def zero():
        lu_panel.launches = potrf_inv.launches = qr_panel.launches = 0

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    res: dict = {}
    N, nb, nrhs = 32768, 2048, 8
    xover = 4096
    tail = N - next(e for e in range(nb, N, nb) if N - e <= xover)
    want_lu = {"lu_panel": -(-tail // nb), "potrf_inv": 0, "qr_panel": 0}
    g41 = et.Grid(4, 1)
    gen = torch.Generator(device="cuda")
    # warm-up at a small size: the tournament's column loop, the tail;
    # its sweep graphs belong to the call, so none stays resident after
    gen.manual_seed(1)
    Aw = torch.randn(4096, 4096, generator=gen, device="cuda")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    et.lu_solve(et.from_global(Aw, et.MC, et.MR, g41),
                et.from_global(torch.ones(4096, nrhs, device="cuda"),
                               et.MC, et.MR, g41), nb=nb, panel="calu")
    torch.cuda.synchronize()
    res["calu_resident_bytes_after_call"] = \
        torch.cuda.memory_allocated() - mem0
    if res["calu_resident_bytes_after_call"] > 8 << 20:
        raise AssertionError(f"phase 3i CALU: lu_solve left "
                             f"{res['calu_resident_bytes_after_call']} "
                             f"bytes allocated on the card")
    del Aw
    # step 1: CALU lu_solve and lu
    gen.manual_seed(0)
    Ag = torch.randn(N, N, generator=gen, device="cuda")
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    A = et.from_global(Ag, et.MC, et.MR, g41)
    B = et.from_global(Bg, et.MC, et.MR, g41)
    zero()
    X, t_solve = sync_time(lambda: et.lu_solve(A, B, nb=nb, panel="calu"))
    res["calu_lu_solve"] = {"launches": _counts_now(*kern), "s": t_solve}
    zero()
    with engine.redist_trace() as log:
        (LU, perm), t_lu = sync_time(lambda: et.lu(A, nb=nb, panel="calu"))
    res["calu_lu"] = {"launches": _counts_now(*kern), "s": t_lu,
                      "redist_counts": _labels(log)}
    full_rounds, full_bytes = wire_totals(log)
    del log
    gates = _lu_gates(et, Ag, LU, perm, X, Bg, gen)
    del LU, perm, X
    ratio = gates["factor_residual"] / lu_path["factor_residual"]
    res["calu_lu"].update(gates, classic_factor_residual=lu_path[
        "factor_residual"], residual_ratio_to_classic=ratio,
        classic_1x1_lu_s=lu_path["lu_s"],
        classic_1x1_lu_solve_s=lu_path["lu_solve_s"],
        wire_rounds=full_rounds, wire_bytes=full_bytes)
    if not (gates["factor_residual"] < 1e-3
            and max(gates["hpl_scaled_residuals"]) < 16 and gates["finite"]
            and ratio < 64 and res["calu_lu"]["redist_counts"]
            == CALU_LU_COUNTS
            and res["calu_lu"]["launches"] == want_lu
            and res["calu_lu_solve"]["launches"] == want_lu):
        raise AssertionError(f"phase 3i CALU: {json.dumps(res)}; want "
                             f"counts {CALU_LU_COUNTS}, launches {want_lu}")
    # step 4: the same lu over the int8 wire
    zero()
    with engine.redist_trace() as log8:
        (LU8, perm8), t_lu8 = sync_time(
            lambda: et.lu(A, nb=nb, panel="calu", comm_precision="int8"))
    q_rounds, q_bytes = wire_totals(log8)
    res["calu_lu_int8"] = {"launches": _counts_now(*kern), "s": t_lu8,
                           "wire_rounds": q_rounds, "wire_bytes": q_bytes,
                           "wire_bytes_ratio": full_bytes / max(q_bytes, 1),
                           "redist_counts": _labels(log8)}
    del log8
    g8 = _lu_gates(et, Ag, LU8, perm8, None, None, gen)
    del LU8, perm8
    res["calu_lu_int8"].update(g8)
    if not (math.isfinite(g8["factor_residual"])
            and g8["factor_residual"] < 5e-2 and q_rounds == full_rounds
            and full_bytes >= 1.9 * q_bytes
            and res["calu_lu_int8"]["launches"] == want_lu):
        raise AssertionError(f"phase 3i CALU int8: "
                             f"{json.dumps(res['calu_lu_int8'])}")
    del A, B, Ag, Bg
    torch.cuda.empty_cache()
    print("phase 3i CALU " + json.dumps(
        {k: res[k] for k in ("calu_lu_solve", "calu_lu", "calu_lu_int8",
                             "calu_resident_bytes_after_call")}
        | {"N": N, "nb": nb, "nrhs": nrhs, "grid": "4x1", "dtype": "float32",
           "card": card}), flush=True)
    # step 2: TSQR qr + least squares at 65536 x 32768 on 4x1
    m, n = 65536, 32768
    gen.manual_seed(1)
    Aw = torch.randn(4096, 2048, generator=gen, device="cuda")
    et.qr(et.from_global(Aw, et.MC, et.MR, g41), nb=nb, panel="tsqr")
    del Aw
    # the virtual grid's functional updates hold a few copies of the
    # 8.6 GB matrix: the global A is made again for the gates
    torch.cuda.empty_cache()
    gen.manual_seed(0)
    A = et.from_global(torch.randn(m, n, generator=gen, device="cuda"),
                       et.MC, et.MR, g41)
    Bg = torch.randn(m, nrhs, generator=gen, device="cuda")
    B = et.from_global(Bg, et.MC, et.MR, g41)
    zero()
    with engine.redist_trace() as logq:
        (Ap, tau), t_qr = sync_time(lambda: et.qr(A, nb=nb, panel="tsqr"))
    counts_q = _labels(logq)
    del logq

    def solve():
        Y = et.apply_q(Ap, tau, B, orient="C")
        R = et.make_trapezoidal(et.interior_view(Ap, (0, n), (0, n)), "U")
        return et.trsm("L", "U", "N", R, et.interior_view(Y, (0, n),
                                                          (0, nrhs)), nb=nb)
    X, t_ls = sync_time(solve)
    launches_q = _counts_now(*kern)
    del A
    torch.cuda.empty_cache()
    gen.manual_seed(0)
    Ag = torch.randn(m, n, generator=gen, device="cuda")
    ap = et.to_global(Ap)
    xg = et.to_global(X)
    f_res, orth, opt = _ls_gates(et, g41, Ag, ap, Ap, tau, xg, Bg, gen)
    del ap
    finite = bool(torch.isfinite(xg).all())
    res["tsqr_least_squares"] = {
        "launches": launches_q, "qr_s": t_qr, "solve_s": t_ls,
        "least_squares_s": t_qr + t_ls, "redist_counts": counts_q,
        "factor_residual": f_res, "orthogonality": orth,
        "normal_equations_optimality": opt,
        "classic_1x1_qr_s": qr_path["qr_s"],
        "classic_1x1_least_squares_s": qr_path["least_squares_s"]}
    if not (f_res < 1e-3 and orth < 1e-4 and opt < 1e-4 and finite
            and tuple(xg.shape) == (n, nrhs) and counts_q == TSQR_QR_COUNTS
            and launches_q == {"lu_panel": 0, "potrf_inv": 0,
                               "qr_panel": 0}):
        raise AssertionError(f"phase 3i TSQR: "
                             f"{json.dumps(res['tsqr_least_squares'])}; "
                             f"want counts {TSQR_QR_COUNTS}")
    del B, Ag, Bg, Ap, tau, X, xg
    torch.cuda.empty_cache()
    print("phase 3i TSQR " + json.dumps(
        res["tsqr_least_squares"] | {"m": m, "n": n, "nb": nb,
                                     "grid": "4x1", "card": card}),
        flush=True)
    # step 3: standalone tsqr of a tall-skinny [VC,STAR] matrix on 2x2
    m3, k3 = 4194304, 256
    g22 = et.Grid(2, 2)
    gen.manual_seed(5)
    et.tsqr(et.from_global(torch.randn(8192, k3, device="cuda"), et.VC,
                           et.STAR, g22))
    Ag = torch.randn(m3, k3, generator=gen, device="cuda")
    A = et.from_global(Ag, et.VC, et.STAR, g22)
    zero()
    (Q, R), t_ts = sync_time(lambda: et.tsqr(A))
    launches_t = _counts_now(*kern)
    del A
    Qg, Rg = et.to_global(Q), et.to_global(R).double()
    del Q
    err2 = nrm2 = 0.0
    qtq = torch.zeros(k3, k3, device="cuda", dtype=torch.float64)
    for i0 in range(0, m3, 524288):
        qb = Qg[i0:i0 + 524288].double()
        ab = Ag[i0:i0 + 524288].double()
        err2 += float(((ab - qb @ Rg) ** 2).sum())
        nrm2 += float((ab * ab).sum())
        qtq += qb.T @ qb
    del qb, ab, Qg
    rec = (err2 / nrm2) ** 0.5
    orth_t = float((qtq - torch.eye(k3, device="cuda",
                                    dtype=torch.float64)).abs().max())
    torch_qr_ms = _time_ms(lambda: torch.linalg.qr(Ag), 1)
    res["tsqr_standalone"] = {"launches": launches_t, "s": t_ts,
                              "reconstruction": rec, "orthogonality": orth_t,
                              "torch_linalg_qr_ms": torch_qr_ms}
    if not (rec < 1e-4 and orth_t < 1e-4 and launches_t == {
            "lu_panel": 0, "potrf_inv": 0, "qr_panel": 0}):
        raise AssertionError(f"phase 3i tsqr: "
                             f"{json.dumps(res['tsqr_standalone'])}")
    del Ag
    print("phase 3i tsqr standalone " + json.dumps(
        res["tsqr_standalone"] | {"m": m3, "k": k3, "grid": "2x2",
                                  "card": card}), flush=True)
    # step 5: path='direct' against the chain, every legal pair on 2x4
    g24 = et.Grid(2, 4)
    gen.manual_seed(6)
    F = torch.randn(4096, 4096, generator=gen, device="cuda")
    times = {}
    zero()
    for src in et.LEGAL_PAIRS:
        S = et.from_global(F, *src, g24)
        for dst in et.LEGAL_PAIRS:
            Bc = et.redistribute(S, *dst, path="chain")
            Bd = et.redistribute(S, *dst, path="direct")
            if not torch.equal(Bc.local, Bd.local):
                raise AssertionError(f"phase 3i direct != chain for "
                                     f"{src} -> {dst}")
            del Bc, Bd
            key = f"[{src[0].value},{src[1].value}]->" \
                  f"[{dst[0].value},{dst[1].value}]"
            times[key] = [
                _time_ms(lambda: et.redistribute(S, *dst, path=p), 1,
                         warm=False) for p in ("chain", "direct")]
    res["direct_vs_chain"] = {
        "launches": _counts_now(*kern), "pairs": len(times),
        "chain_ms_total": sum(t[0] for t in times.values()),
        "direct_ms_total": sum(t[1] for t in times.values())}
    if res["direct_vs_chain"]["launches"] != {"lu_panel": 0, "potrf_inv": 0,
                                              "qr_panel": 0}:
        raise AssertionError(f"phase 3i direct vs chain: "
                             f"{json.dumps(res['direct_vs_chain'])}")
    print("phase 3i direct vs chain (4096 x 4096 f32, 2x4, bit-equal) "
          + json.dumps(res["direct_vs_chain"] | {"ms": times,
                                                  "card": card}), flush=True)
    return res


def _guarded_gates(rep: dict, launches: int, want: int,
                   recovered: bool) -> bool:
    """Phase 3j's report gates: ``ok``, 16 panels, no unrecovered panel,
    ``want`` launches; a clean run has no violation and recomputes
    nothing, a faulted one violates at step 1 only and recomputes it."""
    ok = (rep["ok"] and rep["panels"] == 16 and launches == want
          and rep["unrecovered_panels"] == [])
    if recovered:
        return ok and sorted({v["step"] for v in rep["violations"]}) == [1] \
            and rep["recompute_count"] == 1 and rep["recovered_panels"] == [1]
    return ok and rep["violations"] == [] and rep["recompute_count"] == 0


def _report_brief(rep: dict) -> dict:
    return {"ok": rep["ok"], "panels": rep["panels"],
            "checks": rep["checks"],
            "violation_steps": sorted({v["step"] for v in rep["violations"]}),
            "violation_phases": sorted({v["phase"]
                                        for v in rep["violations"]}),
            "recompute_count": rep["recompute_count"],
            "recovered_panels": rep["recovered_panels"]}


def phase_resilience(et, card: str, main_path: dict, lu_path: dict,
                     qr_path: dict) -> dict:
    """The resilience layer at full width on the 1x1 grid, f32: the
    checksum-guarded ``lu`` / ``cholesky`` (N = 32768) and ``qr`` (65536 x
    32768), each clean and recovered from a one-shot fault at panel step
    1 (one more launch of its kernel, the factor bit-equal to the clean
    one); ``certified_solve`` of both ops, clean and through the
    compute-target escalation; ``hpd_solve`` / ``lu_solve`` with
    ``health=True, info=True``."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    from elemental_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                certified_solve,
                                                fault_injection,
                                                last_abft_report,
                                                last_health_report)
    from elemental_tpu_torch.resilience import certify
    kern = (lu_panel, potrf_inv, qr_panel)

    def zero():
        lu_panel.launches = potrf_inv.launches = qr_panel.launches = 0

    sync_time = _sync_time

    def one_shot(target, kind, nelem=2):
        return FaultPlan(seed=7, faults=[FaultSpec(target, kind, nelem=nelem,
                                                   window=(1, 2))])

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30

    def fresh_peak():
        """Starts a new peak reading; returns the GiB resident now (the
        guarded call's own room is the peak less this)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2 ** 30

    res: dict = {}
    N, nb, nrhs = 32768, 2048, 8
    grid = et.Grid()
    gen = torch.Generator(device="cuda")
    # warm-up at a small size: every guarded driver and a certified solve
    gen.manual_seed(1)
    Aw = torch.randn(4096, 4096, generator=gen, device="cuda")
    Sw, _ = _spd(4096, torch.float32, seed=1)
    Bw = et.from_global(torch.ones(4096, nrhs, device="cuda"), et.MC, et.MR,
                        grid)
    et.lu(et.from_global(Aw, et.MC, et.MR, grid), nb=nb, abft=True)
    et.cholesky(et.from_global(Sw, et.MC, et.MR, grid), nb=nb, abft=True)
    et.qr(et.from_global(Aw, et.MC, et.MR, grid), nb=nb, abft=True)
    certified_solve("hpd", et.from_global(Sw, et.MC, et.MR, grid), Bw,
                    nb=nb)
    del Aw, Sw, Bw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # step 1: guarded LU on phase 3b's matrix
    gen.manual_seed(0)
    Ag = torch.randn(N, N, generator=gen, device="cuda")
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    A = et.from_global(Ag, et.MC, et.MR, grid)
    B = et.from_global(Bg, et.MC, et.MR, grid)
    _, t_plain = sync_time(lambda: et.lu(A, nb=nb))
    (LU0, p0), t_classic = sync_time(lambda: et.lu(A, nb=nb,
                                                    lookahead=False))
    zero()
    resident = fresh_peak()
    (LU, perm), t_abft = sync_time(lambda: et.lu(A, nb=nb, abft=True))
    clean = {"launches": _counts_now(*kern), "s": t_abft,
             "report": _report_brief(last_abft_report("lu")),
             "peak_gib": peak_gib(), "resident_gib": resident}
    ok = _guarded_gates(last_abft_report("lu"), lu_panel.launches, 16,
                        False)
    gates = _lu_gates(et, Ag, LU, perm, None, Bg, gen)
    # where the guarded schedule's extra time goes (its whole-matrix
    # copies for rollback, the checksum reductions)
    clean["breakdown"] = _device_breakdown(
        lambda: et.lu(A, nb=nb, abft=True), top=10)
    clean.update(gates, lu_s=t_plain, lu_3b_s=lu_path["lu_s"],
                 lu_classic_s=t_classic,
                 max_diff_vs_classic=float(
                     (LU.local - LU0.local).abs().max()
                     / LU0.local.abs().max()),
                 perm_equal_to_classic=bool(torch.equal(perm, p0)))
    del LU0, p0
    ok = ok and gates["factor_residual"] < 1e-3
    res["lu_abft"] = clean
    for label, (target, kind) in (("lu_abft_compute_scale",
                                   ("compute", "scale")),
                                  ("lu_abft_redistribute_nan",
                                   ("redistribute", "nan"))):
        zero()
        with fault_injection(one_shot(target, kind)) as plan:
            (LUf, pf), t = sync_time(lambda: et.lu(A, nb=nb, abft=True))
        rep = last_abft_report("lu")
        same = bool(torch.equal(LUf.local, LU.local)
                    and torch.equal(pf, perm))
        res[label] = {"launches": _counts_now(*kern), "s": t,
                      "fired": plan.fired(), "report": _report_brief(rep),
                      "bit_equal_to_clean": same}
        ok = ok and same and plan.fired() >= 1 and _guarded_gates(
            rep, lu_panel.launches, 17, True)
        del LUf, pf
    # a one-element bit flip in a computed panel: the guard flags it
    # only where its column-sum change exceeds the compute threshold,
    # 64 eps (nb + sqrt(rows)) of the column's mass (the JAX package's).
    # At nb = 2048 this flip stays under it; the miss is pinned, so that a
    # change of the threshold shows either way: the flip fires once, the
    # guard reports a clean run (16 launches, nothing recomputed) and the
    # factor differs from the clean one
    zero()
    with fault_injection(one_shot("compute", "bitflip")) as plan:
        (LUf, pf), t = sync_time(lambda: et.lu(A, nb=nb, abft=True))
    rep = last_abft_report("lu")
    res["lu_abft_compute_bitflip"] = {
        "launches": _counts_now(*kern), "s": t, "fired": plan.fired(),
        "report": _report_brief(rep), "flipped": [
            [float(b), float(a)] for ev in plan.log
            for b, a in zip(ev.before, ev.after)],
        "panel_threshold": 64 * float(torch.finfo(torch.float32).eps)
        * (nb + (N - nb) ** 0.5),
        "bit_equal_to_clean": bool(torch.equal(LUf.local, LU.local)),
        "max_diff_vs_clean": float((LUf.local - LU.local).abs().max()
                                   / LU.local.abs().max())}
    miss = res["lu_abft_compute_bitflip"]
    ok = ok and plan.fired() == 1 and rep["ok"] and rep["violations"] == [] \
        and rep["recompute_count"] == 0 and lu_panel.launches == 16 \
        and not miss["bit_equal_to_clean"]
    del LUf, pf
    print("phase 3j guarded lu " + json.dumps(
        {k: res[k] for k in res if k.startswith("lu_")}), flush=True)
    if not ok:
        raise AssertionError(f"phase 3j guarded LU: {json.dumps(res)}")
    del LU, perm

    # step 4 (on the same matrix): the certified LU solve, clean
    zero()
    (X, info), t_cert = sync_time(lambda: certified_solve("lu", A, B,
                                                          nb=nb))
    cert_lu = {"s": t_cert, "launches": _counts_now(*kern),
               "certified": info["certified"],
               "rung": info["rung"], "residual": info["residual"],
               "refine_iters": info["refine_iters"], "tol": info["tol"]}
    (LUc, pc), cert_lu["factor_s"] = sync_time(lambda: et.lu(
        A, nb=nb, panel="calu", comm_precision="int8"))
    _, cert_lu["solve_s"] = sync_time(lambda: et.lu_solve_after(
        LUc, pc, B, nb=nb))
    del LUc, pc
    t0 = time.perf_counter()
    An, Bn, Xn = certify._host(A), certify._host(B), certify._host(X)
    cert_lu["host_copy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    certify._residual(An, Bn, Xn, np.linalg.norm(An), np.linalg.norm(Bn))
    cert_lu["host_residual_s"] = time.perf_counter() - t0
    del An, Bn, Xn, X
    res["certified_lu"] = cert_lu
    # step 5: the monitors on lu_solve
    (X, info), t = sync_time(lambda: et.lu_solve(A, B, nb=nb, health=True,
                                                 info=True))
    hrep = last_health_report("lu")
    res["lu_solve_health"] = {"s": t, "lu_solve_s": lu_path["lu_solve_s"],
                              "ok": hrep["ok"], "checks": hrep["checks"],
                              "growth_estimate": hrep["growth_estimate"],
                              "info": info}
    # the certificate's own tolerance (64 n eps = 0.25 here) would pass a
    # wrong solve: its backward error is held to phase 3's solve limit
    ok = (cert_lu["certified"] and cert_lu["rung"] == "quant"
          and cert_lu["residual"] < 1e-4 and hrep["ok"]
          and info == {"singular": False, "diag_index": None,
                       "finite": True})
    del A, B, Ag, Bg, X
    if not ok:
        raise AssertionError(f"phase 3j certified / monitored LU: "
                             f"{json.dumps(res)}")

    # step 2: guarded Cholesky on phase 3's matrix
    torch.cuda.empty_cache()
    Sg, gen = _spd(N, torch.float32, seed=0)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    S = et.from_global(Sg, et.MC, et.MR, grid)
    B = et.from_global(Bg, et.MC, et.MR, grid)
    del Sg
    _, t_plain = sync_time(lambda: et.cholesky(S, nb=nb))
    zero()
    resident = fresh_peak()
    L, t_abft = sync_time(lambda: et.cholesky(S, nb=nb, abft=True))
    rep = last_abft_report("cholesky")
    s, l = S.local, L.local
    v = torch.randn(N, 1, generator=gen, device="cuda")
    factor_res = float(torch.linalg.norm(s @ v - l @ (l.T @ v))
                       / (torch.linalg.norm(s) * torch.linalg.norm(v)))
    res["cholesky_abft"] = {"launches": _counts_now(*kern), "s": t_abft,
                            "cholesky_s": t_plain,
                            "peak_gib": peak_gib(),
                            "resident_gib": resident,
                            "report": _report_brief(rep),
                            "factor_residual": factor_res}
    ok = _guarded_gates(rep, potrf_inv.launches, 16, False) \
        and factor_res < 1e-3
    zero()
    with fault_injection(one_shot("compute", "scale", nelem=1)) as plan:
        Lf, t = sync_time(lambda: et.cholesky(S, nb=nb, abft=True))
    rep = last_abft_report("cholesky")
    same = bool(torch.equal(Lf.local, L.local))
    res["cholesky_abft_compute_scale"] = {
        "launches": _counts_now(*kern), "s": t, "fired": plan.fired(),
        "report": _report_brief(rep), "bit_equal_to_clean": same}
    ok = ok and same and plan.fired() >= 1 and _guarded_gates(
        rep, potrf_inv.launches, 17, True)
    del Lf, L, l
    print("phase 3j guarded cholesky " + json.dumps(
        {k: res[k] for k in res if k.startswith("cholesky_")}), flush=True)
    if not ok:
        raise AssertionError(f"phase 3j guarded Cholesky: {json.dumps(res)}")

    # step 4: the certified HPD solve, clean and through the escalation
    zero()
    (X, info), t_cert = sync_time(lambda: certified_solve("hpd", S, B,
                                                          nb=nb))
    cert_hpd = {"s": t_cert, "launches": _counts_now(*kern),
                "certified": info["certified"],
                "rung": info["rung"], "residual": info["residual"],
                "refine_iters": info["refine_iters"], "tol": info["tol"]}
    F, cert_hpd["factor_s"] = sync_time(lambda: et.cholesky(S, nb=nb))
    _, cert_hpd["solve_s"] = sync_time(lambda: et.cholesky_solve_after(
        F, B, nb=nb))
    del F, X
    calls = FaultPlan(seed=0, faults=[])
    with fault_injection(calls):
        et.cholesky(S, nb=nb)
    per_factor = calls.calls["compute"]
    plan = FaultPlan(seed=5, faults=[FaultSpec("compute", "nan", call=0),
                                     FaultSpec("compute", "nan",
                                               call=per_factor)])
    zero()
    with fault_injection(plan):
        (X, info), t_esc = sync_time(lambda: certified_solve("hpd", S, B,
                                                             nb=nb))
    res["certified_hpd_escalation"] = {"launches": _counts_now(*kern)}
    cert_hpd["escalation"] = {
        "s": t_esc, "potrf_calls_per_factorization": per_factor,
        "fault_calls": sorted({e.call for e in plan.log}),
        "certified": info["certified"], "rung": info["rung"],
        "residual": info["residual"],
        "attempts": [a["rung"] for a in info["attempts"]],
        "health_ok": [None if a["health"] is None else a["health"]["ok"]
                      for a in info["attempts"]]}
    res["certified_hpd"] = cert_hpd
    esc = cert_hpd["escalation"]
    ok = (cert_hpd["certified"] and cert_hpd["rung"] == "quant"
          and cert_hpd["residual"] < 1e-4 and esc["residual"] < 1e-4
          and esc["certified"] and esc["rung"] == "abft"
          and esc["attempts"] == ["quant", "fast", "refine", "abft"]
          and esc["health_ok"][:2] == [False, False]
          and per_factor == N // nb
          and potrf_inv.launches == 3 * per_factor)
    del X
    # step 5: the monitors on hpd_solve
    (X, info), t = sync_time(lambda: et.hpd_solve(S, B, nb=nb, health=True,
                                                  info=True))
    hrep = last_health_report("cholesky")
    res["hpd_solve_health"] = {"s": t,
                               "hpd_solve_s": main_path["hpd_solve_s"],
                               "ok": hrep["ok"], "checks": hrep["checks"],
                               "min_diag": hrep["min_diag"], "info": info}
    ok = ok and hrep["ok"] and info == {"singular": False,
                                        "diag_index": None, "finite": True}
    del S, B, Bg, X
    print("phase 3j certified and monitored solves " + json.dumps(
        {k: res[k] for k in ("certified_lu", "certified_hpd",
                             "lu_solve_health", "hpd_solve_health")}),
        flush=True)
    if not ok:
        raise AssertionError(f"phase 3j certified / monitored HPD: "
                             f"{json.dumps(res)}")

    # step 3: guarded QR on phase 3c's matrix
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m, n = 65536, 32768
    gen.manual_seed(0)
    A = et.from_global(torch.randn(m, n, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    B = et.from_global(torch.randn(m, nrhs, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    zero()
    resident = fresh_peak()
    (Ap, tau), t_abft = sync_time(lambda: et.qr(A, nb=nb, abft=True))
    rep = last_abft_report("qr")
    clean = {"launches": _counts_now(*kern), "s": t_abft,
             "qr_s": qr_path["qr_s"], "report": _report_brief(rep),
             "peak_gib": peak_gib(), "resident_gib": resident}
    ok = _guarded_gates(rep, qr_panel.launches, 16, False)
    Y = et.apply_q(Ap, tau, B, orient="C")
    R = et.make_trapezoidal(et.interior_view(Ap, (0, n), (0, n)), "U")
    X = et.trsm("L", "U", "N", R, et.interior_view(Y, (0, n), (0, nrhs)),
                nb=nb)
    del Y, R
    factor_res, orth, optimality = _ls_gates(et, grid, A.local, Ap.local,
                                             Ap, tau, X.local, B.local, gen)
    clean.update(factor_residual=factor_res, orthogonality=orth,
                 normal_equations_optimality=optimality)
    ok = ok and factor_res < 1e-3 and orth < 1e-4 and optimality < 1e-4
    res["qr_abft"] = clean
    # the clean factor waits on the host: the faulted run's rollback
    # state needs the room on the card (its peak read 68.8 GiB beside it)
    ap_host, tau_host = Ap.local.cpu(), tau.cpu()
    del X, Ap, tau
    torch.cuda.empty_cache()
    zero()
    resident = fresh_peak()
    with fault_injection(one_shot("compute", "scale")) as plan:
        (Apf, tauf), t = sync_time(lambda: et.qr(A, nb=nb, abft=True))
    rep = last_abft_report("qr")
    same = bool(torch.equal(Apf.local.cpu(), ap_host)
                and torch.equal(tauf.cpu(), tau_host))
    res["qr_abft_compute_scale"] = {
        "launches": _counts_now(*kern), "s": t, "fired": plan.fired(),
        "report": _report_brief(rep), "bit_equal_to_clean": same,
        "peak_gib": peak_gib(), "resident_gib": resident}
    ok = ok and same and plan.fired() >= 1 and _guarded_gates(
        rep, qr_panel.launches, 17, True)
    del Apf, tauf, ap_host, tau_host, A, B
    print("phase 3j guarded qr " + json.dumps(
        {k: res[k] for k in res if k.startswith("qr_")}), flush=True)
    if not ok:
        raise AssertionError(f"phase 3j guarded QR: {json.dumps(res)}")
    res["card"] = card
    print("phase 3j resilience " + json.dumps(res), flush=True)
    return res


#: phase 3k's cold resolutions on the 1x1 CUDA grid, every knob of the op
#: 'auto' (bench.py's requested dicts): the op, its dims and the config
#: the tuner must pick.  tests/test_torch_tune_cost_model.py computes the
#: same resolutions on the CPU (a 'gpu' context) and pins them here.
TUNER_PINS = {
    "cholesky": ((32768, 32768),
                 {"nb": 2048, "lookahead": True, "crossover": 4096,
                  "comm_precision": None, "redist_path": None,
                  "panel_impl": "kernel"}),
    "lu": ((32768, 32768),
           {"nb": 2048, "lookahead": True, "crossover": 4096,
            "panel": "classic", "comm_precision": None, "redist_path": None,
            "panel_impl": "kernel"}),
    "qr": ((65536, 32768),
           {"nb": 2048, "panel": "classic", "comm_precision": None,
            "redist_path": None, "panel_impl": "kernel"}),
    "trsm": ((32768, 8), {"nb": 2048, "comm_precision": None,
                          "redist_path": None}),
    "herk": ((32768, 2048), {"nb": 512, "comm_precision": None,
                             "redist_path": None}),
    "gemm": ((65536, 512, 512), {"alg": "dot", "nb": 64,
                                 "comm_precision": None,
                                 "redist_path": None}),
}


def _resolve_timed(et, op, dims, grid, requested) -> tuple:
    """(resolution, cold seconds, memo-hit seconds) of one resolve."""
    import torch
    t0 = time.perf_counter()
    res = et.tune.resolve(op, gshape=dims, dtype=torch.float32, grid=grid,
                          requested=requested)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = et.tune.resolve(op, gshape=dims, dtype=torch.float32, grid=grid,
                            requested=requested)
    hit = time.perf_counter() - t0
    if again is not res:
        raise AssertionError(f"3k: the second resolve of {op} missed the "
                             "memo")
    return res, cold, hit


def _same(x, y) -> bool:
    """Bit equality of two results that are tensors or DistMatrix es."""
    import torch
    x, y = getattr(x, "local", x), getattr(y, "local", y)
    return torch.equal(x, y)


def _solve_pair(fn_auto, fn_explicit, kern, want: dict, label: str) -> tuple:
    """Run the 'auto' call with every launch counter at 0, gate its
    launches, then the explicit call; returns (auto result, explicit
    result, auto seconds, launches)."""
    import torch
    for k in kern:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn_auto()
    torch.cuda.synchronize()
    t_auto = time.perf_counter() - t0
    launches = _counts_now(*kern)
    if launches != want:
        raise AssertionError(f"3k {label}: launches {launches}, expected "
                             f"{want}")
    ref = fn_explicit()
    torch.cuda.synchronize()
    return out, ref, t_auto, launches


def phase_tuner(et, card: str, main_path: dict, lu_path: dict,
                qr_path: dict) -> dict:
    """The tuner on the card: cold resolutions pinned to the CPU's, the
    three flagships and gemm with 'auto' knobs (launch counts, bit-equal
    to the explicit calls, the gates of 3 / 3b / 3c), and a measured
    search whose winner the next resolution reads back from the cache."""
    import os
    import shutil
    import tempfile
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    from elemental_tpu_torch.tune import cache as tcache
    from elemental_tpu_torch.tune import measure
    from elemental_tpu_torch.tune.cost_model import machine_for
    kern = (lu_panel, potrf_inv, qr_panel)
    grid = et.Grid()
    res: dict = {}
    tmp = tempfile.mkdtemp(prefix="tune_cache_")
    old = os.environ.get(tcache.ENV_DIR)
    os.environ[tcache.ENV_DIR] = tmp
    et.tune.clear_memo()
    try:
        # 1. cold resolutions, every knob 'auto', then a memo hit
        for op, (dims, pin) in TUNER_PINS.items():
            requested = {k: "auto" for k in et.tune.OPS[op].knobs}
            r, cold, hit = _resolve_timed(et, op, dims, grid, requested)
            row = {"dims": list(dims), "config": r.config,
                   "source": r.source, "cold_s": cold, "memo_hit_s": hit}
            print(f"phase 3k resolve {op} " + json.dumps(row), flush=True)
            if r.source != "cost_model" or r.config != pin:
                raise AssertionError(f"3k: {op} resolved {r.config} "
                                     f"({r.source}), the CPU pins {pin}")
            res[f"resolve_{op}"] = row

        # 2. the flagships through 'auto' (phase 3 / 3b / 3c's inputs)
        (N, _), chol = TUNER_PINS["cholesky"]
        nrhs, nb = 8, chol["nb"]
        Ag, gen = _spd(N, torch.float32, seed=0)
        Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
        A = et.from_global(Ag, et.MC, et.MR, grid)
        B = et.from_global(Bg, et.MC, et.MR, grid)
        del Ag
        X, Xe, t, n = _solve_pair(
            lambda: et.hpd_solve(A, B, nb="auto"),
            lambda: et.hpd_solve(A, B, nb=nb), kern,
            {"lu_panel": 0, "potrf_inv": N // nb, "qr_panel": 0},
            "hpd_solve")
        if not torch.equal(X.local, Xe.local):
            raise AssertionError(f"3k: hpd_solve(nb='auto') differs from "
                                 f"nb={nb}")
        del Xe
        for k in kern:
            k.launches = 0
        F = et.cholesky(A, nb="auto", lookahead="auto", crossover="auto",
                        panel_impl="auto")
        torch.cuda.synchronize()
        chol_launches = _counts_now(*kern)
        if not torch.equal(F.local, et.cholesky(A, nb=nb).local):
            raise AssertionError(f"3k: cholesky('auto' x4) differs from "
                                 f"nb={nb}")
        a, l, x = A.local, F.local, X.local
        v = torch.randn(N, 1, generator=gen, device="cuda")
        norm_a = torch.linalg.norm(a)
        factor_res = float(torch.linalg.norm(a @ v - l @ (l.T @ v))
                           / (norm_a * torch.linalg.norm(v)))
        solve_res = float(torch.linalg.norm(a @ x - B.local)
                          / (norm_a * torch.linalg.norm(x)))
        if not (factor_res < 1e-3 and solve_res < 1e-4
                and bool(torch.isfinite(x).all())):
            raise AssertionError(f"3k hpd_solve: factor residual "
                                 f"{factor_res:.3e}, solve residual "
                                 f"{solve_res:.3e}")
        res["hpd_solve"] = {"launches": n, "s": t,
                            "phase3_s": main_path.get("hpd_solve_s"),
                            "factor_residual": factor_res,
                            "solve_residual": solve_res, "bit_equal": True,
                            "cholesky_launches": chol_launches}
        print("phase 3k hpd_solve " + json.dumps(res["hpd_solve"]),
              flush=True)
        del F, X, A, B, a, l, x

        (N, _), lu_pin = TUNER_PINS["lu"]
        nb = lu_pin["nb"]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        Ag = torch.randn(N, N, generator=gen, device="cuda")
        Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
        A = et.from_global(Ag, et.MC, et.MR, grid)
        B = et.from_global(Bg, et.MC, et.MR, grid)
        X, Xe, t, n = _solve_pair(
            lambda: et.lu_solve(A, B, nb="auto", panel="auto"),
            lambda: et.lu_solve(A, B, nb=nb), kern,
            {"lu_panel": N // nb, "potrf_inv": 0, "qr_panel": 0},
            "lu_solve")
        if not torch.equal(X.local, Xe.local):
            raise AssertionError(f"3k: lu_solve(nb='auto') differs from "
                                 f"nb={nb}")
        del Xe
        # every knob 'auto' but the wire and the route, which stay pinned
        # to None: its own resolution, held to the explicit pinned call
        (LU, perm), (LUe, perme), t_lu, n_lu = _solve_pair(
            lambda: et.lu(A, nb="auto", lookahead="auto", crossover="auto",
                          panel="auto", panel_impl="auto"),
            lambda: et.lu(A, **lu_pin), kern,
            {"lu_panel": N // nb, "potrf_inv": 0, "qr_panel": 0},
            "lu('auto' x5)")
        if not (torch.equal(LU.local, LUe.local) and _same(perm, perme)):
            raise AssertionError(f"3k: lu('auto' x5) differs from {lu_pin}")
        del LUe, perme
        g = _lu_gates(et, Ag, LU, perm, X, Bg, gen)
        if not (g["factor_residual"] < 1e-3
                and max(g["hpl_scaled_residuals"]) < 16 and g["finite"]):
            raise AssertionError(f"3k lu_solve gates {g}")
        res["lu_solve"] = {"launches": n, "s": t,
                           "phase3b_s": lu_path.get("lu_solve_s"),
                           "bit_equal": True, "lu_auto_launches": n_lu,
                           "lu_auto_s": t_lu, **g}
        print("phase 3k lu_solve " + json.dumps(res["lu_solve"]), flush=True)
        del LU, perm, X, A, B, Ag, Bg

        (m, n_), qr_pin = TUNER_PINS["qr"]
        nb = qr_pin["nb"]
        gen.manual_seed(0)
        A = et.from_global(torch.randn(m, n_, generator=gen, device="cuda"),
                           et.MC, et.MR, grid)
        B = et.from_global(torch.randn(m, nrhs, generator=gen, device="cuda"),
                           et.MC, et.MR, grid)
        X, Xe, t, n = _solve_pair(
            lambda: et.least_squares(A, B, nb="auto"),
            lambda: et.least_squares(A, B, nb=nb), kern,
            {"lu_panel": 0, "potrf_inv": 0, "qr_panel": n_ // nb},
            "least_squares")
        if not torch.equal(X.local, Xe.local):
            raise AssertionError(f"3k: least_squares(nb='auto') differs "
                                 f"from nb={nb}")
        del Xe
        (Ap, tau), (Ape, taue), t_qr, n_qr = _solve_pair(
            lambda: et.qr(A, nb="auto", panel="auto", panel_impl="auto"),
            lambda: et.qr(A, **qr_pin), kern,
            {"lu_panel": 0, "potrf_inv": 0, "qr_panel": n_ // nb},
            "qr('auto' x3)")
        if Ap._qr_nb != nb:
            raise AssertionError(f"3k: qr('auto') blocked at {Ap._qr_nb}")
        if not (torch.equal(Ap.local, Ape.local) and _same(tau, taue)):
            raise AssertionError(f"3k: qr('auto' x3) differs from {qr_pin}")
        del Ape, taue
        factor_res, orth, optimality = _ls_gates(
            et, grid, A.local, Ap.local, Ap, tau, X.local, B.local, gen)
        if not (factor_res < 1e-3 and orth < 1e-4 and optimality < 1e-4
                and bool(torch.isfinite(X.local).all())):
            raise AssertionError(f"3k least_squares: factor residual "
                                 f"{factor_res:.3e}, orthogonality "
                                 f"{orth:.3e}, optimality {optimality:.3e}")
        res["least_squares"] = {"launches": n, "s": t,
                                "phase3c_s": qr_path.get("least_squares_s"),
                                "bit_equal": True, "qr_auto_launches": n_qr,
                                "qr_auto_s": t_qr,
                                "factor_residual": factor_res,
                                "orthogonality": orth,
                                "normal_equations_optimality": optimality}
        print("phase 3k least_squares " + json.dumps(res["least_squares"]),
              flush=True)
        del Ap, tau, X, A, B

        # 3. gemm with its defaults (alg='auto' -> 'dot' on 1x1)
        mg, kg, ng = TUNER_PINS["gemm"][0]
        gen.manual_seed(4)
        a = torch.randn(mg, kg, generator=gen, device="cuda")
        b = torch.randn(kg, ng, generator=gen, device="cuda")
        Ad = et.from_global(a, et.MC, et.MR, grid)
        Bd = et.from_global(b, et.MC, et.MR, grid)
        for k in kern:
            k.launches = 0
        C = et.gemm(Ad, Bd)
        gemm_launches = _counts_now(*kern)
        if not torch.equal(C.local, et.gemm(Ad, Bd, alg="dot").local):
            raise AssertionError("3k: gemm(A, B) differs from alg='dot'")
        rel = float(torch.linalg.norm(C.local - a @ b)
                    / torch.linalg.norm(a @ b))
        # where the default call's time goes: the resolver on the host
        # (default against alg='dot'), the wrapper on the device ('dot'
        # against one matmul: C's zero fill and the alpha scaling, timed
        # alone on tensors of the product's shape)
        d = a @ b
        calls = {"default": lambda: et.gemm(Ad, Bd),
                 "dot": lambda: et.gemm(Ad, Bd, alg="dot"),
                 "matmul": lambda: torch.matmul(a, b),
                 "zeros_C": lambda: torch.zeros(mg, ng, device="cuda"),
                 "alpha_scale": lambda: 1.0 * d}
        ms = {k: [] for k in calls}
        for k in list(calls) + list(calls)[::-1]:
            ms[k].append(_time_ms(calls[k], 5))
        knobs = {"alg": "auto", "nb": None, "comm_precision": None,
                 "redist_path": None}
        et.tune.resolve_knobs("gemm", gshape=(mg, kg, ng), dtype=C.dtype,
                              grid=grid, knobs=knobs)
        t0 = time.perf_counter()
        for _ in range(1000):
            et.tune.resolve_knobs("gemm", gshape=(mg, kg, ng), dtype=C.dtype,
                                  grid=grid, knobs=knobs)
        hit_us = (time.perf_counter() - t0) * 1e3
        res["gemm"] = {"ms": ms["default"], "dot_ms": ms["dot"],
                       "matmul_ms": ms["matmul"],
                       "zeros_C_ms": ms["zeros_C"],
                       "alpha_scale_ms": ms["alpha_scale"],
                       "resolve_hit_us": hit_us,
                       "rel_to_matmul": rel, "bit_equal": True,
                       "launches": gemm_launches}
        print("phase 3k gemm(A, B) " + json.dumps(res["gemm"]), flush=True)
        del a, b, d, Ad, Bd, C

        # the card against the 'gpu' row of the machine model
        lat = measure._latency(torch.device("cuda"))
        mm = machine_for("gpu")
        res["card_vs_model"] = {
            "matmul_f32_tflops_n8192": measure._roofline(
                lat, torch.device("cuda"), n=8192),
            "model_peak_tflops": mm.peak_flops / 1e12,
            "total_memory_bytes": torch.cuda.get_device_properties(
                0).total_memory,
            "model_hbm_bytes": mm.hbm_bytes}
        print("phase 3k card vs model " + json.dumps(res["card_vs_model"]),
              flush=True)

        # 4. measure, record, read back from the cache, then clear
        for op in ("cholesky", "lu"):
            dims = TUNER_PINS[op][0]
            t0 = time.perf_counter()
            winner, measured, key = measure.search(
                op, dims, grid, torch.float32, top=4, reps=2)
            t_search = time.perf_counter() - t0
            table = [[m_.config, m_.seconds * 1e3, m_.tflops,
                      m_.roofline_tflops] for m_ in measured]
            print(f"phase 3k search {op} " + json.dumps(
                {"s": t_search, "key": key.filename(),
                 "table (config, ms, TFLOP/s, roofline TFLOP/s)": table}),
                flush=True)
            requested = {k: "auto" for k in et.tune.OPS[op].knobs}
            back = et.tune.resolve(op, gshape=dims, dtype=torch.float32,
                                   grid=grid, requested=requested)
            if back.source != "cache" or back.config != winner.config:
                raise AssertionError(f"3k: {op} resolved {back.config} "
                                     f"({back.source}) after the search, "
                                     f"winner {winner.config}")
            res[f"search_{op}"] = {"s": t_search, "winner": winner.config,
                                   "winner_ms": winner.seconds * 1e3,
                                   "measured": len(measured)}
        N = TUNER_PINS["cholesky"][0][0]
        nb_w = res["search_cholesky"]["winner"]["nb"]
        Ag, gen = _spd(N, torch.float32, seed=0)
        Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
        A = et.from_global(Ag, et.MC, et.MR, grid)
        B = et.from_global(Bg, et.MC, et.MR, grid)
        del Ag
        for k in kern:
            k.launches = 0
        X = et.hpd_solve(A, B, nb="auto")
        torch.cuda.synchronize()
        want = {"lu_panel": 0, "potrf_inv": -(-N // nb_w), "qr_panel": 0}
        if _counts_now(*kern) != want:
            raise AssertionError(f"3k: hpd_solve under the measured winner "
                                 f"launched {_counts_now(*kern)}, expected "
                                 f"{want}")
        res["hpd_solve_cached"] = {"launches": _counts_now(*kern),
                                   "nb": nb_w}
        del X, A, B
        removed = et.tune.clear_cache()
        if removed != 2 or et.tune.cache_entries():
            raise AssertionError(f"3k: clear_cache removed {removed}")
        res["cleared"] = removed
    finally:
        if old is None:
            os.environ.pop(tcache.ENV_DIR, None)
        else:
            os.environ[tcache.ENV_DIR] = old
        et.tune.clear_memo()
        shutil.rmtree(tmp, ignore_errors=True)
    return res



#: phase 3l's sizes (a rehearsal on the CPU shrinks them)
TRACE_SIZES = {"N": 32768, "m": 65536, "n_ls": 32768, "nb": 2048,
               "nrhs": 8, "n_virtual": 8192, "nb_virtual": 1024,
               "n_dense": 8192, "rank": 4096, "k_mod": 8,
               "n_block": 32768, "n_gemm": 8192, "n_updates": 1 << 24,
               "m_mv": 1 << 27, "n_gallery": 4096}

#: the JAX package's phase names of the three flagship factors on 1x1
FLAGSHIP_PHASES = {"cholesky": {"diag", "panel", "update"},
                   "lu": {"panel", "swap", "solve", "update"},
                   "qr": {"panel", "update"}}


def _gallery_cases(n: int) -> dict:
    """Every deterministic gallery generator at order ~n: name ->
    (args, tolerance relative to the largest entry; 0 = bit-equal).  The
    ones that call exp, pow or sqrt may round an ulp apart on the card
    (``gks``'s 1 / sqrt did: 1.1e-16)."""
    import numpy as np
    v = np.random.default_rng(3).normal(size=n)
    k = n.bit_length() - 1
    side2 = int(round(n ** 0.5))
    side3 = int(round(n ** (1 / 3)))
    return {
        "zeros": ((n,), 0), "ones": ((n,), 0), "identity": ((n,), 0),
        "hilbert": ((n,), 0), "lehmer": ((n,), 0), "minij": ((n,), 0),
        "fourier": ((n,), 1e-13), "toeplitz": ((v, v[::-1].copy()), 0),
        "hankel": ((v, v[::-1].copy()), 0), "circulant": ((v,), 0),
        "cauchy": ((v, v + 100.0), 0), "walsh": ((k,), 0),
        "wilkinson": ((n // 2 - 1,), 0), "laplacian_1d": ((n,), 0),
        "laplacian_2d": ((side2, side2), 0), "jordan": ((n, 2.5), 0),
        "kahan": ((n, 0.01), 1e-13), "grcar": ((n,), 0),
        "parter": ((n,), 0), "pei": ((n, 3.0), 0), "redheffer": ((n,), 0),
        "triw": ((n, -2.0), 0), "gear": ((n,), 0),
        "gepp_growth": ((n,), 0), "demmel": ((n,), 1e-13),
        "druinsky_toledo": ((n // 2,), 1e-13),
        "extended_kahan": ((1 << (k - 2),), 1e-13), "fiedler": ((v,), 0),
        "fox_li": ((n,), 1e-11), "gks": ((n,), 1e-14), "hanowa": ((n,), 0),
        "helmholtz_1d": ((n, 2.5), 0),
        "helmholtz_2d": ((side2, side2, 1.5), 0),
        "helmholtz_3d": ((side3, side3, side3, 0.5), 0),
        "laplacian_3d": ((side3, side3, side3), 0),
        "jordan_cholesky": ((n,), 0), "lauchli": ((n,), 0),
        "legendre": ((n,), 1e-14), "lotkin": ((n,), 0),
        "one_two_one": ((n,), 0), "riffle": ((n,), 1e-13),
        "ris": ((n,), 0), "whale": ((n,), 0), "kms": ((n, 0.5), 1e-13),
        "egorov": ((n,), 1e-13)}


def _label_counts(counter) -> dict:
    """``redist_counts()``'s Counter as the tracer's labels (storage-level
    row permutations excluded, as ``Tracer.redist_counts`` does)."""
    out: dict = {}
    for key, v in counter.items():
        if key == "row_permute":
            continue
        if key == "panel_spread":
            label = key
        else:
            (s0, s1), (d0, d1) = key
            label = f"[{s0.value},{s1.value}]->[{d0.value},{d1.value}]"
        out[label] = out.get(label, 0) + v
    return dict(sorted(out.items()))


def _sync_time(fn):
    """(fn(), its wall seconds between two device syncs)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _tracing_dense(et, grid, g22, gen) -> dict:
    """Phase 3l's dense surface: ``cholesky_pivoted``, ``cholesky_mod``,
    the BlockMatrix round trip and gemm, ``remote_updates`` and the
    ``DistMultiVec`` reductions (see :func:`phase_tracing`)."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    S = TRACE_SIZES
    kern = (lu_panel, potrf_inv, qr_panel)
    nb = S["nb"]
    sync_time = _sync_time
    res: dict = {}
    nd, rk = S["n_dense"], S["rank"]
    t_part = time.perf_counter()
    for k in kern:
        k.launches = 0
    gen.manual_seed(11)
    G = torch.randn(nd, rk, generator=gen, device="cuda")
    P = G @ G.T
    del G
    Pd = et.from_global(P, et.MC, et.MR, grid)
    (Lp, perm, rank), t = sync_time(lambda: et.cholesky_pivoted(Pd,
                                                                tol=1e-4))
    l = Lp.local
    PAP = P[perm][:, perm]
    piv_res = float(torch.linalg.norm(PAP - l @ l.T) / torch.linalg.norm(P))
    res["cholesky_pivoted"] = {"s": t, "rank": int(rank),
                               "residual": piv_res, "N": nd,
                               "launches": _counts_now(*kern),
                               "wall_s": time.perf_counter() - t_part}
    print("phase 3l cholesky_pivoted " + json.dumps(
        res["cholesky_pivoted"]), flush=True)
    if not (int(rank) == rk and piv_res < 1e-3):
        raise AssertionError(f"3l cholesky_pivoted: "
                             f"{json.dumps(res['cholesky_pivoted'])}")
    del P, Pd, Lp, PAP, l
    t_part = time.perf_counter()
    Sm, gen2 = _spd(nd, torch.float32, seed=12)
    V = torch.randn(nd, S["k_mod"], generator=gen2, device="cuda")
    L = et.cholesky(et.from_global(Sm, et.MC, et.MR, grid), nb=nb)
    Vd = et.from_global(V, et.MC, et.MR, grid)
    L2, t_up = sync_time(lambda: et.cholesky_mod(L, Vd, 1.0))
    L3, t_down = sync_time(lambda: et.cholesky_mod(L2, Vd, -1.0))
    Sup = Sm + V @ V.T
    Lref = torch.linalg.cholesky(Sup.double())
    up_err = float((L2.local.double() - Lref).abs().max()
                   / Lref.abs().max())
    Lref0 = torch.linalg.cholesky(Sm.double())
    down_err = float((L3.local.double() - Lref0).abs().max()
                     / Lref0.abs().max())
    res["cholesky_mod"] = {"update_s": t_up, "downdate_s": t_down,
                           "k": S["k_mod"], "N": nd,
                           "update_err_vs_factor": up_err,
                           "downdate_err_vs_factor": down_err}
    res["cholesky_mod"]["wall_s"] = time.perf_counter() - t_part
    print("phase 3l cholesky_mod " + json.dumps(res["cholesky_mod"]),
          flush=True)
    if not (up_err < 1e-3 and down_err < 1e-3):
        raise AssertionError(f"3l cholesky_mod: "
                             f"{json.dumps(res['cholesky_mod'])}")
    del Sm, V, L, L2, L3, Sup, Lref, Lref0, Vd
    torch.cuda.empty_cache()

    nbk = S["n_block"]
    t_part = time.perf_counter()
    gen.manual_seed(13)
    Fb = torch.randn(nbk, nbk, generator=gen, device="cuda")
    Ab = et.from_global(Fb, et.MC, et.MR, g22)
    del Fb
    Bt, t_from = sync_time(lambda: et.block_from_cyclic(Ab))
    Ab2, t_to = sync_time(lambda: et.block_to_cyclic(Bt))
    round_trip = _same(Ab, Ab2)
    del Ab, Ab2, Bt
    torch.cuda.empty_cache()
    ng = S["n_gemm"]
    Ga = et.from_global(torch.randn(ng, ng, generator=gen, device="cuda"),
                        et.MC, et.MR, g22)
    Gb = et.from_global(torch.randn(ng, ng, generator=gen, device="cuda"),
                        et.MC, et.MR, g22)
    Cc, t_cyc = sync_time(lambda: et.gemm(Ga, Gb))
    Ct, t_tiled = sync_time(lambda: et.gemm(et.block_from_cyclic(Ga),
                                            et.block_from_cyclic(Gb)))
    gemm_equal = _same(et.block_to_cyclic(Ct), Cc)
    res["block"] = {"n": nbk, "grid": "2x2", "from_cyclic_s": t_from,
                    "to_cyclic_s": t_to, "round_trip_bit_equal": round_trip,
                    "gemm_n": ng, "gemm_cyclic_s": t_cyc,
                    "gemm_tiled_s": t_tiled, "gemm_bit_equal": gemm_equal}
    res["block"]["wall_s"] = time.perf_counter() - t_part
    print("phase 3l block " + json.dumps(res["block"]), flush=True)
    if not (round_trip and gemm_equal):
        raise AssertionError(f"3l block: {json.dumps(res['block'])}")
    del Ga, Gb, Cc, Ct
    torch.cuda.empty_cache()

    nu = S["n_updates"]
    t_part = time.perf_counter()
    rows = torch.randint(0, nd, (nu,), generator=gen, device="cuda")
    cols = torch.randint(0, nd, (nu,), generator=gen, device="cuda")
    rows[: nu // 4] = rows[: nu // 4] % 64          # heavy duplicates
    cols[: nu // 4] = cols[: nu // 4] % 64
    vals = torch.randn(nu, generator=gen, device="cuda")
    Au = et.zeros(nd, nd, grid=grid, dtype=torch.float32)
    Ru, t_ru = sync_time(lambda: et.remote_updates(Au, rows, cols, vals))
    ref = torch.zeros(nd, nd, dtype=torch.float64, device="cuda")
    ref.index_put_((rows, cols), vals.double(), accumulate=True)
    mass = torch.zeros_like(ref)
    mass.index_put_((rows, cols), vals.double().abs(), accumulate=True)
    eps = torch.finfo(torch.float32).eps
    dup = torch.zeros_like(ref)
    dup.index_put_((rows, cols), torch.ones_like(vals, dtype=torch.float64),
                   accumulate=True)
    # f32 summation error of each entry: its count times eps times its
    # mass (the order of the sums is the device's)
    diff = (Ru.local.double() - ref).abs()
    within = bool((diff <= dup * eps * mass + eps).all())
    res["remote_updates"] = {"updates": nu, "s": t_ru,
                             "max_abs_err_vs_f64": float(diff.max()),
                             "within_entrywise_bound": within,
                             "max_duplicates": int(dup.max())}
    res["remote_updates"]["wall_s"] = time.perf_counter() - t_part
    print("phase 3l remote_updates " + json.dumps(res["remote_updates"]),
          flush=True)
    if not within:
        raise AssertionError(f"3l remote_updates: "
                             f"{json.dumps(res['remote_updates'])}")
    del rows, cols, vals, Au, Ru, ref, mass, dup, diff
    torch.cuda.empty_cache()

    mm = S["m_mv"]
    t_part = time.perf_counter()
    x = torch.randn(mm, generator=gen, device="cuda")
    y = torch.randn(mm, generator=gen, device="cuda")
    X = et.mv_from_global(x, grid=grid)
    Y = et.mv_from_global(y, grid=grid)
    Z, t_axpy = sync_time(lambda: et.mv_axpy(0.5, X, Y))
    d, t_dot = sync_time(lambda: et.mv_dot(X, Y))
    nrm, t_nrm = sync_time(lambda: et.mv_nrm2(X))
    xd, yd = x.double(), y.double()
    dot_ref = float(xd @ yd)
    nrm_ref = float(torch.linalg.vector_norm(xd))
    axpy_err = float((et.mv_to_global(Z).double().squeeze(1)
                      - (0.5 * xd + yd)).abs().max())
    res["multivec"] = {
        "m": mm, "axpy_s": t_axpy, "dot_s": t_dot, "nrm2_s": t_nrm,
        "dot_rel_err": abs(float(d) - dot_ref) / (nrm_ref * float(
            torch.linalg.vector_norm(yd))),
        "nrm2_rel_err": abs(float(nrm) - nrm_ref) / nrm_ref,
        "axpy_max_abs_err": axpy_err}
    mv = res["multivec"]
    mv["wall_s"] = time.perf_counter() - t_part
    print("phase 3l multivec " + json.dumps(mv), flush=True)
    if not (mv["dot_rel_err"] < 1e-5 and mv["nrm2_rel_err"] < 1e-5
            and axpy_err < 1e-5):
        raise AssertionError(f"3l multivec: {json.dumps(mv)}")
    del x, y, X, Y, Z, xd, yd
    torch.cuda.empty_cache()

    return res


def _tracing_gallery(et, grid) -> dict:
    """Phase 3l's gallery: every deterministic generator at n = 4096 on
    the card against the same call on the CPU, and the device-random
    ones for seeded determinism and moments."""
    import torch
    from elemental_tpu_torch import matrices as TM
    S = TRACE_SIZES
    ng = S["n_gallery"]
    cpu = et.Grid(device="cpu")
    gal: dict = {}
    t0 = time.perf_counter()

    def phase_fn(i, j):
        return (i * j).double() * 1e-4

    bad = []
    for name, (args, tol) in _gallery_cases(ng).items():
        fn = getattr(TM, name)
        if name == "egorov":
            args = (phase_fn,) + args
        a_card = et.to_global(fn(*args, grid=grid)).cpu()
        a_cpu = et.to_global(fn(*args, grid=cpu))
        diff = float((a_card - a_cpu).abs().max()) if a_cpu.numel() else 0.0
        scale = max(float(a_cpu.abs().max()), 1.0) if a_cpu.numel() else 1.0
        gal[name] = diff / scale
        if not (a_card.shape == a_cpu.shape and gal[name] <= tol):
            bad.append(f"{name}: {gal[name]:.3e} > {tol}")
    print("phase 3l gallery max relative difference card - cpu "
          + json.dumps(gal), flush=True)
    if bad:
        raise AssertionError(f"3l gallery: {bad}")
    rand: dict = {}
    for name in ("gaussian_device", "uniform_device", "bernoulli",
                 "rademacher"):
        fn = getattr(TM, name)
        a1 = fn(ng, grid=grid, seed=5).local
        a2 = fn(ng, grid=grid, seed=5).local
        a3 = fn(ng, grid=grid, seed=6).local
        rand[name] = {"mean": float(a1.mean()), "std": float(a1.std())}
        if not (torch.equal(a1, a2) and not torch.equal(a1, a3)):
            raise AssertionError(f"3l gallery {name}: not seeded")
    g = rand["gaussian_device"]
    if not (abs(g["mean"]) < 0.01 and abs(g["std"] - 1) < 0.01):
        raise AssertionError(f"3l gallery gaussian_device moments {g}")
    return {"n": ng, "s": time.perf_counter() - t0,
            "max_rel_diff_vs_cpu": gal, "device_random": rand}


def phase_tracing(et, card: str, main_path: dict, lu_path: dict,
                  qr_path: dict) -> dict:
    """3l: the drivers traced on the card, and the rest of the dense
    surface at full width.

    The three flagships at phases 3 / 3b / 3c's sizes (f32, nb = 2048,
    1x1): each wrapper untraced and under ``with Tracer():`` (bit-equal,
    N / nb launches, ``op_calls`` equal to the tracer's driver entries),
    and its factor untraced and with an explicit ``PhaseTimer`` under the
    tracer (bit-equal, N / nb steps with the JAX package's phase names,
    the phase seconds within 2% of the call's synchronized wall time);
    the Perfetto trace written and its events counted.  The guarded
    ``lu`` under the tracer with ``health=True``: a one-shot fault at
    step 1 (one ``abft:recover`` span, 17 launches, bit-equal to the
    clean guarded factor) and an unrecovered one (the ``health:*``
    instants on the ``events`` track).  A virtual 2x2 ``cholesky``: the
    tracer's collective labels equal ``redist_counts()``.  Then
    ``cholesky_pivoted``, ``cholesky_mod``, the BlockMatrix round trip
    and gemm, ``remote_updates``, the ``DistMultiVec`` reductions and
    every deterministic gallery generator against the CPU."""
    import os
    import tempfile
    import torch
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    from elemental_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                                fault_injection)
    S = TRACE_SIZES
    kern = (lu_panel, potrf_inv, qr_panel)
    grid = et.Grid()
    nb, nrhs = S["nb"], S["nrhs"]
    res: dict = {}
    tmp = tempfile.mkdtemp(prefix="trace_")

    sync_time = _sync_time

    def zero():
        for k in kern:
            k.launches = 0

    def ops_of(reg) -> dict:
        return {dict(labels)["op"]: int(v) for (_, labels), v
                in reg.counters("op_calls").items()}

    def flagship(label, wrapper, factor, drv, kernel, steps):
        """Untraced and traced runs of one flagship (see the docstring)."""
        first = (lambda x: x) if drv == "cholesky" else (lambda x: x[0])
        with obs.metrics_scope() as reg0:
            X0, t_plain = sync_time(wrapper)
        zero()
        tracer = obs.Tracer()
        with obs.metrics_scope() as reg1:
            with tracer:
                X1, t_traced = sync_time(wrapper)
        launches = _counts_now(*kern)
        ops0, ops1 = ops_of(reg0), ops_of(reg1)
        calls: dict = {}
        for _, d, _, _, _ in tracer.driver_calls():
            calls[d] = calls.get(d, 0) + 1
        F0, tf_plain = sync_time(lambda: factor(None))
        timer = obs.PhaseTimer()
        ftracer = obs.Tracer()
        zero()
        with obs.metrics_scope():
            with ftracer:
                F1, tf_traced = sync_time(lambda: factor(timer))
        rep = timer.report(driver=drv)
        phase_s = rep["total_seconds"]
        names = set(rep["totals"])
        trace_path = os.path.join(tmp, f"{label}.json")
        doc = obs.chrome_trace_doc(tracer, driver=label, card=card)
        obs.write_json(trace_path, doc)
        nevents = len(json.load(open(trace_path))["traceEvents"])
        out = {"untraced_s": t_plain, "traced_s": t_traced,
               "traced_over_untraced": t_traced / t_plain,
               "factor_untraced_s": tf_plain, "factor_traced_s": tf_traced,
               "factor_traced_over_untraced": tf_traced / tf_plain,
               "phase_sum_s": phase_s,
               "phase_sum_over_wall": phase_s / tf_traced,
               "wrapper_phase_sum_over_wall":
                   sum(r.seconds for r in tracer.phases) / t_traced,
               "steps": len(rep["steps"]), "phases": sorted(names),
               "op_calls": ops1, "launches": launches,
               "factor_launches": _counts_now(*kern),
               "trace_events": nevents, "phase_totals_s": rep["totals"]}
        ok = (_same(X0, X1) and _same(first(F0), first(F1))
              and (drv == "cholesky" or _same(F0[1], F1[1]))
              and launches[kernel] == steps
              and sum(launches.values()) == steps
              and out["factor_launches"][kernel] == steps
              and ops0 == ops1 and ops1 == calls
              and [s["step"] for s in rep["steps"]] == list(range(steps))
              and names == FLAGSHIP_PHASES[drv]
              and abs(phase_s / tf_traced - 1) <= 0.02
              and {r.phase for r in ftracer.phases} == names
              and nevents > 0)
        print(f"phase 3l {label} " + json.dumps(out), flush=True)
        if not ok:
            raise AssertionError(f"3l {label}: {json.dumps(out)}")
        return out, X0

    # warm-up at a small size (library handles, each kernel's first
    # launch), so that the untraced and traced calls below compare alike
    nw = min(4096, S["N"])
    Aw, _ = _spd(nw, torch.float32, seed=1)
    Bw = et.from_global(torch.ones(nw, nrhs, device="cuda"), et.MC, et.MR,
                        grid)
    Aw = et.from_global(Aw, et.MC, et.MR, grid)
    for fn in (et.hpd_solve, et.lu_solve, et.least_squares):
        fn(Aw, Bw, nb=nb)
    del Aw, Bw

    # 1. the three flagships at full width
    N = S["N"]
    Ag, gen = _spd(N, torch.float32, seed=0)
    Bg = torch.randn(N, nrhs, generator=gen, device="cuda")
    A = et.from_global(Ag, et.MC, et.MR, grid)
    B = et.from_global(Bg, et.MC, et.MR, grid)
    del Ag, Bg
    res["hpd_solve"], _ = flagship(
        "hpd_solve", lambda: et.hpd_solve(A, B, nb=nb),
        lambda t: et.cholesky(A, nb=nb, timer=t), "cholesky", "potrf_inv",
        N // nb)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    A = et.from_global(torch.randn(N, N, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    B = et.from_global(torch.randn(N, nrhs, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    res["lu_solve"], _ = flagship(
        "lu_solve", lambda: et.lu_solve(A, B, nb=nb),
        lambda t: et.lu(A, nb=nb, timer=t), "lu", "lu_panel", N // nb)

    # 2. the guarded lu under the tracer, health on (phase 3j's fault)
    zero()
    LUc, pc = et.lu(A, nb=nb, abft=True)
    guarded: dict = {"clean_launches": _counts_now(*kern)}
    for label, every, want in (("recovered", False, N // nb + 1),
                               ("unrecovered", True, None)):
        plan = FaultPlan(seed=7, faults=[FaultSpec(
            "compute", "scale", nelem=2, every=every, window=(1, 2))])
        tracer = obs.Tracer()
        zero()
        with obs.metrics_scope():
            with tracer, fault_injection(plan):
                (LUf, pf), t = sync_time(
                    lambda: et.lu(A, nb=nb, abft=True, health=True))
        spans = [s for s in tracer.spans if s.name == "abft:recover"]
        inst = [i.name for i in tracer.instants]
        doc = obs.chrome_trace_doc(tracer)
        lanes = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "thread_name"}
        on_events = {lanes[e["tid"]] for e in doc["traceEvents"]
                     if e["ph"] == "i" and e["name"].startswith("health:")}
        guarded[label] = {"s": t, "launches": _counts_now(*kern),
                          "recover_spans": len(spans),
                          "health_instants": sorted(set(inst)),
                          "n_health_instants": len(inst),
                          "bit_equal_to_clean": bool(
                              torch.equal(LUf.local, LUc.local)
                              and torch.equal(pf, pc))}
        g_ok = (len(spans) == 1 and guarded[label]["bit_equal_to_clean"]
                and lu_panel.launches == want and not inst) \
            if not every else \
            (len(spans) >= 1 and lu_panel.launches == N // nb + len(spans)
             and "health:abft" in inst and on_events == {"events"})
        if not g_ok:
            raise AssertionError(f"3l guarded lu {label}: "
                                 f"{json.dumps(guarded[label])}")
        del LUf, pf
    del LUc, pc, A, B
    res["guarded_lu_recovered"] = guarded["recovered"]
    res["guarded_lu_unrecovered"] = guarded["unrecovered"]
    print("phase 3l guarded lu " + json.dumps(guarded), flush=True)
    torch.cuda.empty_cache()

    m, n = S["m"], S["n_ls"]
    gen.manual_seed(0)
    A = et.from_global(torch.randn(m, n, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    B = et.from_global(torch.randn(m, nrhs, generator=gen, device="cuda"),
                       et.MC, et.MR, grid)
    res["least_squares"], _ = flagship(
        "least_squares", lambda: et.least_squares(A, B, nb=nb),
        lambda t: et.qr(A, nb=nb, timer=t), "qr", "qr_panel", n // nb)
    del A, B
    torch.cuda.empty_cache()

    # 3. a virtual 2x2 cholesky: the tracer's collectives equal the
    # engine's own counts of the same call
    nv = S["n_virtual"]
    g22 = et.Grid(2, 2)
    Sv, _ = _spd(nv, torch.float32, seed=4)
    Av = et.from_global(Sv, et.MC, et.MR, g22)
    del Sv
    L0 = et.cholesky(Av, nb=S["nb_virtual"])
    tracer = obs.Tracer()
    zero()
    with obs.metrics_scope():
        with et.redist_counts() as cnt, tracer:
            L1, t = sync_time(lambda: et.cholesky(Av, nb=S["nb_virtual"]))
    labels = _label_counts(cnt)
    virt = {"s": t, "tracer_counts": tracer.redist_counts(),
            "engine_counts": labels, "launches": _counts_now(*kern),
            "ring_bytes": tracer.redist_bytes_total(),
            "comm_events": len(tracer.comms)}
    if not (virt["tracer_counts"] == labels and labels
            and _same(L0, L1)):
        raise AssertionError(f"3l virtual 2x2 cholesky: {json.dumps(virt)}")
    res["virtual_2x2_cholesky"] = virt
    print("phase 3l virtual 2x2 cholesky " + json.dumps(virt), flush=True)
    del Av, L0, L1

    # 4. the dense surface, 5. the gallery on the card against the CPU
    res.update(_tracing_dense(et, grid, g22, gen))
    res["gallery"] = _tracing_gallery(et, grid)
    res["trace_dir"] = tmp
    res["card"] = card
    print("phase 3l tracing " + json.dumps(res), flush=True)
    return res


#: phase 3m's sizes: (a)'s serving mix, (c)'s escalations, (e)'s fleet
SERVE_SIZES = {"requests": 48, "n_lo": 700, "n_hi": 4096, "nrhs": 8,
               "max_batch": 8, "esc_n": 16384, "esc_nb": 2048,
               "esc_ls": (16384, 8192), "grid_requests": 8,
               "grid_n": 4096, "fleet_requests": 32, "fleet_n_hi": 2048,
               "chaos_n": 16}

#: ``bench_serve.py``'s semantic keys of ``serve_result/v1``: what the
#: sync and the async passes must agree on
SERVE_SEM_KEYS = ("op", "n", "nrhs", "bucket", "status", "path", "rung",
                  "residual", "tol", "retries", "bisected", "timed_out")


def _serve_mix(count: int, seed: int, n_lo: int, n_hi: int, nrhs: int,
               ops=("lu", "hpd", "lu", "hpd", "lstsq"),
               dev: str = "cuda") -> list:
    """``count`` requests cycling through ``ops`` (the mix lu : hpd :
    lstsq = 2 : 2 : 1 by default) with n uniform in [n_lo, n_hi] (lstsq
    m = 2n), f32, drawn by a seeded numpy generator; the SPD products
    G G^T / n + n I are formed on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        op = ops[i % len(ops)]
        n = int(rng.integers(n_lo, n_hi + 1))
        rows = 2 * n if op == "lstsq" else n
        F = rng.standard_normal((rows, n), dtype=np.float32)
        if op == "hpd":
            G = torch.from_numpy(F).to(dev)
            A = G @ G.T
            A.div_(n)
            A.diagonal().add_(n)
            A = A.cpu().numpy()
            del G
        elif op == "lu":
            A = F
            A[np.diag_indices(n)] += n
        else:
            A = F
        B = rng.standard_normal((rows, nrhs), dtype=np.float32)
        out.append((op, A, B))
    return out


def _compiles(reg) -> int:
    return int(sum(v for (_, lb), v in
                   reg.counters("serve_exec_cache_events").items()
                   if dict(lb).get("event") == "compile"))


def _pctl(vals, q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, max(int(q * len(s) + 0.5) - 1, 0))]


def _serve_sync(et, work, sizes, grid) -> dict:
    """3m (a): the sync fast path, warmed over every (bucket, slots)
    geometry by a first pass of the same requests, then measured."""
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.serve import SolverService
    from elemental_tpu_torch.serve.executor import residual, ls_residual
    svc = SolverService(grid, max_batch=sizes["max_batch"],
                        escalate_nb=sizes["esc_nb"])
    t0 = time.perf_counter()
    for op, A, B in work:
        svc.submit(op, A, B)
    warm = svc.drain()
    warm_s = time.perf_counter() - t0
    with obs.metrics_scope() as reg:
        t0 = time.perf_counter()
        ids = [svc.submit(op, A, B) for op, A, B in work]
        docs = svc.drain()
        wall = time.perf_counter() - t0
        captures = _compiles(reg)
        batches = int(sum(reg.counters("serve_batches").values()))
    bad = []
    for rid, (op, A, B) in zip(ids, work):
        d = docs[rid]
        res = (ls_residual if op == "lstsq" else residual)(
            A, B, svc.solutions.get(rid))
        if d["status"] != "ok" or d["path"] != "fastpath" \
                or not res <= d["tol"]:
            bad.append({"id": rid, "status": d["status"], "res": res,
                        "tol": d["tol"]})
    lat = [docs[r]["latency_s"] for r in ids]
    stats = svc.executor.cache.stats()
    out = {"requests": len(ids), "warm_pass_s": warm_s, "wall_s": wall,
           "solves_per_s": len(ids) / wall,
           "p50_ms": 1e3 * _pctl(lat, 0.50), "p99_ms": 1e3 * _pctl(lat, 0.99),
           "batches": batches, "captures_in_measured_pass": captures,
           "warm_ok": sum(d["status"] == "ok" for d in warm.values()),
           "graph_ops": stats["graph_ops"], "graphs": len(stats["graphs"]),
           "entries": len(stats["entries"]), "failures": bad,
           "buckets": sorted({docs[r]["bucket"] for r in ids})}
    if bad or captures != 0:
        raise AssertionError(f"3m (a) sync fast path: {json.dumps(out)}")
    return out, svc, ids, docs


def _serve_peaks(et, work, sizes, grid) -> dict:
    """3m (a): the closed-form ``batch_peak_bytes`` of the largest buckets
    (n = 4096)
    beside the allocator's peak for one cold batch of each (a fresh
    executor: capture, warm-up call and the batch) and what stays
    resident after it."""
    import torch
    from elemental_tpu_torch.serve import AdmissionController, Executor
    from elemental_tpu_torch.serve.executor import (batch_peak_bytes,
                                                    batch_slots)
    from elemental_tpu_torch.tune.cost_model import machine_for
    ctrl = AdmissionController(max_batch=sizes["max_batch"])
    admitted = [ctrl.admit(op, A, B) for op, A, B in work]
    top = max(r.bucket.n for r in admitted)
    reqs: dict = {}
    for r in admitted:
        if r.bucket.n == top:
            reqs.setdefault(r.bucket, []).append(r)
    out = {}
    for bucket, rs in sorted(reqs.items(), key=lambda kv: kv[0].key()):
        rs = rs[:sizes["max_batch"]]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        ex = Executor()
        ex.place = grid.device
        ex.run(bucket, rs)
        torch.cuda.synchronize()
        slots = batch_slots(len(rs))
        out[bucket.key()] = {
            "slots": slots, "batch_peak_bytes": batch_peak_bytes(bucket,
                                                                 slots),
            "max_memory_allocated_delta":
                torch.cuda.max_memory_allocated() - m0,
            "resident_after": torch.cuda.memory_allocated() - m0}
        del ex
    out["gpu_row_hbm_bytes"] = machine_for("gpu").hbm_bytes
    out["card_total_memory"] = torch.cuda.get_device_properties(
        0).total_memory
    return out


def _serve_async(et, work, sizes, grid, sync_svc, sync_ids, sync_docs):
    """3m (b): the same requests through ``AsyncSolverService(donate=
    True)``: a warm-up front fills the executor's entries; a second front
    over that executor, its queue pre-loaded so that batch membership is
    the sync pass's, is the measured window."""
    import threading
    import numpy as np
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.serve import AsyncSolverService, SolverService

    def front(executor=None):
        svc = SolverService(grid, max_batch=sizes["max_batch"],
                            escalate_nb=sizes["esc_nb"])
        if executor is not None:
            svc.executor = executor
        return AsyncSolverService(svc, donate=True, autostart=False)

    f0 = front()
    futs = [f0.submit(op, A, B) for op, A, B in work]
    f0.start()
    for f in futs:
        f.result(timeout=600)
    f0.shutdown(drain=True)
    f1 = front(f0.service.executor)
    with obs.metrics_scope() as reg:
        t0 = time.perf_counter()
        futs = [f1.submit(op, A, B) for op, A, B in work]
        f1.start()
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        f1.shutdown(drain=True)
        captures = _compiles(reg)
    live = [t.name for t in threading.enumerate()
            if t.name.startswith("elemental-serve-worker") and t.is_alive()]
    equal_x = all(np.array_equal(x, sync_svc.solutions[r])
                  for (x, _), r in zip(outs, sync_ids))
    equal_doc = all({k: d[k] for k in SERVE_SEM_KEYS}
                    == {k: sync_docs[r][k] for k in SERVE_SEM_KEYS}
                    for (_, d), r in zip(outs, sync_ids))
    lat = [d["latency_s"] for _, d in outs]
    out = {"donate": f1.donate, "wall_s": wall,
           "solves_per_s": len(outs) / wall,
           "p50_ms": 1e3 * _pctl(lat, 0.50), "p99_ms": 1e3 * _pctl(lat, 0.99),
           "pipeline": f1.pipeline_stats(),
           "captures_in_measured_window": captures,
           "solutions_bit_equal_to_sync": equal_x,
           "semantic_keys_equal_to_sync": equal_doc,
           "live_workers_after_shutdown": live,
           "donated_entries": sum(k.endswith("__donated") for k in
                                  f1.service.executor.cache.stats()[
                                      "entries"])}
    if not (equal_x and equal_doc and captures == 0 and not live
            and f1.donate):
        raise AssertionError(f"3m (b) async front: {json.dumps(out)}")
    return out


def _serve_escalation(et, sizes, grid, kern) -> dict:
    """3m (c): ``fastpath=False`` serving of 2 hpd and 2 lu at N = 16384
    and one lstsq at 16384 x 8192 (nrhs 8): every request certified
    through the kernels, ``certify.py``'s float64 host copies timed."""
    import torch
    from elemental_tpu_torch.resilience import certify
    from elemental_tpu_torch.serve import SolverService
    from elemental_tpu_torch.serve.executor import residual, ls_residual
    N, nb, nrhs = sizes["esc_n"], sizes["esc_nb"], sizes["nrhs"]
    m_ls, n_ls = sizes["esc_ls"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    work = []
    for op in ("hpd", "lu", "hpd", "lu"):
        G = torch.randn(N, N, generator=gen, device="cuda")
        if op == "hpd":
            A = G @ G.T
            A.div_(N)
            A.diagonal().add_(N)
        else:
            A = G
            A.diagonal().add_(N)
        B = torch.randn(N, nrhs, generator=gen, device="cuda")
        work.append((op, A.cpu().numpy(), B.cpu().numpy()))
        del G, A, B
    A = torch.randn(m_ls, n_ls, generator=gen, device="cuda")
    B = torch.randn(m_ls, nrhs, generator=gen, device="cuda")
    work.append(("lstsq", A.cpu().numpy(), B.cpu().numpy()))
    del A, B
    torch.cuda.empty_cache()
    host_s = [0.0]
    plain_host = certify._host

    def timed_host(X):
        t = time.perf_counter()
        try:
            return plain_host(X)
        finally:
            host_s[0] += time.perf_counter() - t

    # four requests a batch: the closed-form peak of an 8-slot N = 16384
    # hpd batch, double-buffered, is over the 'gpu' row's memory budget
    # (admission would shed it, though no batch is ever built here)
    svc = SolverService(grid, fastpath=False, escalate_nb=nb, max_batch=4)
    certify._host = timed_host
    try:
        for k in kern:
            k.launches = 0
        t0 = time.perf_counter()
        ids = [svc.submit(op, A, B) for op, A, B in work]
        rejects = [r for r in ids if isinstance(r, dict)]
        if rejects:
            raise AssertionError(f"3m (c) rejected: {json.dumps(rejects)}")
        docs = svc.drain()
        wall = time.perf_counter() - t0
        launches = _counts_now(*kern)
    finally:
        certify._host = plain_host
    want = {"lu_panel": 0, "potrf_inv": 0, "qr_panel": 0}
    rows, bad = [], []
    for rid, (op, A, B) in zip(ids, work):
        d = docs[rid]
        X = svc.solutions.get(rid)
        res = (ls_residual if op == "lstsq" else residual)(A, B, X) \
            if X is not None else float("inf")
        cert = d["certificate"]
        refactors = 0
        if cert is not None:
            refactor = {r.name: r.refactor
                        for r in certify.default_ladder(op)}
            refactors = sum(1 for a in cert["attempts"]
                            if refactor[a["rung"]])
            want["potrf_inv" if op == "hpd" else "lu_panel"] += \
                refactors * (N // nb)
        rows.append({"id": rid, "op": op, "status": d["status"],
                     "path": d["path"], "rung": d["rung"],
                     "latency_s": d["latency_s"], "residual": d["residual"],
                     "host_residual": res, "tol": d["tol"],
                     "refactorizations": refactors})
        cert_res = d["residual"]
        if d["status"] != "ok" or d["path"] != "escalated" \
                or not res <= d["tol"] or cert_res is None \
                or not res <= 1.01 * cert_res + 1e-30:
            bad.append(rows[-1])
    qr_ok = launches["qr_panel"] in (n_ls // nb, n_ls // nb + 1)
    out = {"requests": rows, "wall_s": wall, "launches": launches,
           "want_launches": {k: v for k, v in want.items()
                             if k != "qr_panel"},
           "f64_host_copy_s": host_s[0],
           "f64_host_copy_share": host_s[0] / wall}
    if bad or not qr_ok \
            or launches["potrf_inv"] != want["potrf_inv"] \
            or launches["lu_panel"] != want["lu_panel"]:
        raise AssertionError(f"3m (c) escalation: {json.dumps(out)}")
    return out


def _serve_grid_route(et, work, sizes, grid, sync_svc, kern) -> dict:
    """3m (d): a measured ``cholesky`` winner for the n = 4096 bucket in
    a temporary tuning cache, then 8 hpd requests of that bucket on (a)'s
    warm service: each request's route is ``route_for`` of that entry
    against (a)'s EWMA estimate."""
    import os
    import tempfile
    from elemental_tpu_torch.serve import make_bucket, route_for
    from elemental_tpu_torch.tune import cache as tcache, measure, policy
    n = sizes["grid_n"]
    tmp = tempfile.mkdtemp(prefix="serve_tune_")
    prev = os.environ.get(tcache.ENV_DIR)
    os.environ[tcache.ENV_DIR] = tmp
    policy.clear_memo()
    try:
        winner, measured, key = measure.search(
            "cholesky", (n, n), grid, "float32",
            requested={"nb": sizes["esc_nb"], "panel_impl": "kernel"},
            top=2, reps=2)
        bucket = make_bucket("hpd", n, sizes["nrhs"], "float32")
        est = sync_svc.admission.estimate_batch_s(bucket) \
            / sync_svc.max_batch
        backend = "gpu" if grid.device.type == "cuda" else "cpu"
        want_route, prov = route_for(bucket, (1, 1), backend, est)
        reqs = _serve_mix(sizes["grid_requests"], 29, n // 2 + 1, n,
                          sizes["nrhs"], ops=("hpd",))
        for k in kern:
            k.launches = 0
        t0 = time.perf_counter()
        ids = [sync_svc.submit(op, A, B) for op, A, B in reqs]
        docs = sync_svc.drain()
        wall = time.perf_counter() - t0
        launches = _counts_now(*kern)
    finally:
        if prev is None:
            os.environ.pop(tcache.ENV_DIR, None)
        else:
            os.environ[tcache.ENV_DIR] = prev
        policy.clear_memo()
    routes = [docs[r]["dispatch"]["route"] for r in ids]
    ok = all(docs[r]["status"] == "ok" for r in ids)
    per_req = launches["potrf_inv"] / len(ids)
    out = {"measured_s": winner.seconds, "config": winner.config,
           "vmap_est_s": est, "route_for": want_route, "routes": routes,
           "paths": [docs[r]["path"] for r in ids], "wall_s": wall,
           "launches": launches, "potrf_inv_per_request": per_req}
    if not ok or routes != [want_route] * len(ids) \
            or (want_route == "grid"
                and launches["potrf_inv"] != (n // sizes["esc_nb"]) * len(ids)):
        raise AssertionError(f"3m (d) grid route: {json.dumps(out)}")
    return out


def _serve_fleet(et, sizes) -> dict:
    """3m (e): ``SolverFleet(grids=2, depth=3)`` over the 8 virtual ranks
    on the card, two tenants under quotas, (a)'s mix at n <= 2048, under
    an active ``Tracer``."""
    import threading
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.obs.lifecycle import check_timeline
    from elemental_tpu_torch.serve import (REJECT_SCHEMA, SolverFleet,
                                           TenantQuota)
    from elemental_tpu_torch.serve.executor import residual, ls_residual
    work = _serve_mix(sizes["fleet_requests"], 31, sizes["n_lo"],
                      sizes["fleet_n_hi"], sizes["nrhs"])
    fleet = SolverFleet(grids=2, depth=3, max_batch=sizes["max_batch"],
                        quotas={"acme": TenantQuota(max_outstanding=6),
                                "blue": TenantQuota(share=2.0)})
    tracer = obs.Tracer()
    t0 = time.perf_counter()
    with tracer:
        futs = [fleet.submit(op, A, B, tenant=("acme", "blue")[i % 2])
                for i, (op, A, B) in enumerate(work)]
        outs = [f.result(timeout=600) for f in futs]
        fleet.shutdown(drain=True)
    wall = time.perf_counter() - t0
    bad, rejects, grids = [], [], set()
    for f, (op, A, B), (x, d) in zip(futs, work, outs):
        if d.get("schema") == REJECT_SCHEMA:
            rejects.append(d)
            if d["reason"] != "quota" or d["tenant"] != "acme" \
                    or d["timeline"] is None:
                bad.append({"fleet_id": f.fleet_id, "reject": d["reason"]})
            continue
        grids.add(d["grid"])
        res = (ls_residual if op == "lstsq" else residual)(A, B, x)
        errs = check_timeline(d["timeline"], path=d["path"], fleet=True)
        if d["status"] != "ok" or not res <= d["tol"] or errs:
            bad.append({"fleet_id": f.fleet_id, "status": d["status"],
                        "res": res, "timeline": errs})
    slo = fleet.slo.snapshot(source="chip_smoke 3m")
    doc = obs.chrome_trace_doc(tracer, mode="serve", grids=2)
    live = [t.name for t in threading.enumerate()
            if t.name.startswith("elemental-serve-worker") and t.is_alive()]
    out = {"requests": len(work), "served": len(work) - len(rejects),
           "quota_rejects": len(rejects), "grids_used": sorted(grids),
           "wall_s": wall, "slo_p99_ms": fleet.slo.per_tenant_p99_ms(),
           "slo_series": len(slo["series"]),
           "chrome_events": len(doc["traceEvents"]),
           "live_workers_after_shutdown": live, "failures": bad}
    if bad or grids != {"g0", "g1"} or live or not slo["series"]:
        raise AssertionError(f"3m (e) fleet: {json.dumps(out)}")
    return out


def _serve_chaos(et, sizes, kern) -> dict:
    """3m (f): the chaos matrix at the JAX tests' size on a virtual 2x2
    grid on the card (f32), and both replays."""
    from elemental_tpu_torch.serve import (chaos_matrix,
                                           fleet_replay_identical,
                                           replay_identical)
    for k in kern:
        k.launches = 0
    t0 = time.perf_counter()
    report = chaos_matrix(et.Grid(2, 2), n=sizes["chaos_n"])
    launches = _counts_now(*kern)
    replay = replay_identical(et.Grid(2, 2), n=sizes["chaos_n"])
    fleet_replay = fleet_replay_identical(n=sizes["chaos_n"])
    wall = time.perf_counter() - t0
    kinds: dict = {}
    for c in report["cells"]:
        for v in c["violations"]:
            kinds[v["kind"]] = kinds.get(v["kind"], 0) + 1
    out = {"cells": len(report["cells"]), "ok": report["ok"],
           "violations_total": report["violations_total"],
           "violation_kinds": kinds,
           "vacuous_cells": report["vacuous_cells"],
           "verdicts": {f"{c['op']}/{c['target']}/{c['kind']}/{c['mode']}"
                        + (f"/{c['column']}" if "column" in c else ""):
                        c["verdict"] for c in report["cells"]},
           "replay_identical": replay,
           "fleet_replay_identical": fleet_replay, "launches": launches,
           "wall_s": wall}
    if kinds.get("silent_garbage") or not replay or not fleet_replay:
        raise AssertionError(f"3m (f) chaos: {json.dumps(out)}")
    return out


def phase_serving(et, card: str) -> dict:
    """3m: serving on the card (see the module docstring): (a) the sync
    fast path at serving size, (b) the async front, (c) escalation
    through the kernels, (d) the tuner-fed 'grid' route, (e) the fleet,
    (f) the chaos matrix.  1x1 grid, f32, TF32 off."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    S = SERVE_SIZES
    kern = (lu_panel, potrf_inv, qr_panel)
    grid = et.Grid()
    res: dict = {"card": card}
    t = time.perf_counter()
    work = _serve_mix(S["requests"], 7, S["n_lo"], S["n_hi"], S["nrhs"])
    res["workload_s"] = time.perf_counter() - t
    for k in kern:
        k.launches = 0
    t = time.perf_counter()
    res["sync"], svc, ids, docs = _serve_sync(et, work, S, grid)
    res["sync"]["launches"] = _counts_now(*kern)
    res["sync"]["phase_s"] = time.perf_counter() - t
    print("phase 3m (a) sync " + json.dumps(res["sync"]), flush=True)
    res["peaks"] = _serve_peaks(et, work, S, grid)
    print("phase 3m (a) peaks " + json.dumps(res["peaks"]), flush=True)
    t = time.perf_counter()
    res["async"] = _serve_async(et, work, S, grid, svc, ids, docs)
    res["async"]["phase_s"] = time.perf_counter() - t
    print("phase 3m (b) async " + json.dumps(res["async"]), flush=True)
    torch.cuda.empty_cache()
    res["escalation"] = _serve_escalation(et, S, grid, kern)
    print("phase 3m (c) escalation " + json.dumps(res["escalation"]),
          flush=True)
    torch.cuda.empty_cache()
    res["grid_route"] = _serve_grid_route(et, work, S, grid, svc, kern)
    print("phase 3m (d) grid route " + json.dumps(res["grid_route"]),
          flush=True)
    del svc, work
    torch.cuda.empty_cache()
    res["fleet"] = _serve_fleet(et, S)
    print("phase 3m (e) fleet " + json.dumps(res["fleet"]), flush=True)
    res["chaos"] = _serve_chaos(et, S, kern)
    print("phase 3m (f) chaos " + json.dumps(res["chaos"]), flush=True)
    return res


#: phase 3n's sizes: (a) the dense LP, (b) NNLS, (c) RPCA, (d) the conic
#: steps (KKT order ~2048), (e) the sparse solvers, (f) the sparse IPMs,
#: (g) the lattice and IO steps
SOLVER_SIZES = {"lp_m": 8192, "lp_n": 16384, "nnls_m": 32768,
                "nnls_n": 4096, "rpca_m": 2048, "rpca_n": 1024,
                "rpca_rank": 10, "socp_n": 512, "socp_m": 64,
                "socp_cones": 184, "socp_order": 8, "qp_n": 682,
                "cg_k": 1024, "gmres_k": 256, "direct_k": 512,
                "lav_m": 10_000, "lav_n": 5_000, "lav_w": 10,
                "bp_m": 5_000, "bp_n": 10_000, "bp_w": 12, "lll_n": 24,
                "ckpt_n": 8192}


def _sync():
    import torch
    torch.cuda.synchronize()


def _reset(kern) -> None:
    for k in kern:
        k.launches = 0


def _dm(et, F, grid):
    import numpy as np
    F = np.asarray(F)
    return et.from_global(F.reshape(-1, 1) if F.ndim == 1 else F,
                          et.MC, et.MR, grid=grid)


def _host(et, A):
    return et.to_global(A).cpu().numpy()


def _laplacian_2d(k: int):
    """COO triplets of the 5-point Laplacian on a k x k grid."""
    import numpy as np
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = (r + dr >= 0) & (r + dr < k) & (c + dc >= 0) & (c + dc < k)
        rows.append(i[ok])
        cols.append(((r + dr) * k + c + dc)[ok])
        vals.append(np.full(int(ok.sum()), -1.0))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), n)


#: phase 3n (a)'s stopping tolerance: at m = 8192 the normal equations'
#: accuracy floors primal feasibility at ~1.6e-8, above the default
#: ``MehrotraCtrl`` tol of 1e-8 (``tools/lp_accuracy.py``; PERF.md)
LP_TOL = 1e-7


def _solver_lp(et, grid, kern, S) -> dict:
    """3n (a): ``lp`` at m x n float64, ``MehrotraCtrl(tol=LP_TOL)``,
    Ruiz on.  The instance is ``tests/optimization/test_solvers.py::
    _feasible_lp``'s construction with complementary supports: x0 > 0 on
    a random basis of m columns and 0 off it, z0 = 0 on the basis and
    U(0.5, 2) off it, b = A x0, c = A^T y0 + z0, so (x0, y0, z0)
    satisfies the KKT conditions and c^T x0 = b^T y0 is the optimum."""
    import numpy as np
    import torch
    m, n = S["lp_m"], S["lp_n"]
    rng = np.random.default_rng(14)
    A = rng.normal(size=(m, n))
    basis = rng.choice(n, m, replace=False)
    x0 = np.zeros(n)
    x0[basis] = rng.uniform(0.5, 2.0, m)
    z0 = rng.uniform(0.5, 2.0, n)
    z0[basis] = 0.0
    y0 = rng.normal(size=m)
    b, c = A @ x0, A.T @ y0 + z0
    opt = float(c @ x0)
    Ad, bd, cd = _dm(et, A, grid), _dm(et, b, grid), _dm(et, c, grid)
    out: dict = {"m": m, "n": n, "dtype": "float64", "tol": LP_TOL,
                 "opt": opt}
    runs = []
    for _ in range(2):
        _reset(kern)
        _sync()
        t = time.perf_counter()
        x, y, z, info = et.lp(Ad, bd, cd, et.MehrotraCtrl(tol=LP_TOL))
        _sync()
        runs.append((x, y, z, info, time.perf_counter() - t,
                     _counts_now(*kern)))
    x, y, z, info, wall, launches = runs[0]
    nb = 2048                          # cholesky's block on the 1x1 grid
    blocks = -(-m // nb)
    want = (1 + info["iters"]) * blocks
    pobj_err = abs(info["pobj"] - opt) / (1 + abs(opt))
    same = all(torch.equal(a.local, b_.local)
               for a, b_ in zip(runs[0][:3], runs[1][:3]))
    # where an iteration's time goes: the normal-matrix gemm against the
    # Cholesky of the normal matrix (one of each, timed apart)
    At = et.redistribute(et.transpose_dist(Ad), et.MC, et.MR)
    gemm_ms = _time_ms(lambda: et.gemm(Ad, At), 2)
    M = et.shift_diagonal(et.gemm(Ad, At), float(m))
    chol_ms = _time_ms(lambda: et.cholesky(M), 2)
    out.update(iters=info["iters"], converged=info["converged"],
               rel_gap=info["rel_gap"], pfeas=info["pfeas"],
               dfeas=info["dfeas"], pobj=info["pobj"],
               pobj_rel_err=pobj_err, wall_s=wall, wall_s_2=runs[1][4],
               s_per_iter=wall / (info["iters"] + 1),
               launches=launches, factorizations=1 + info["iters"],
               potrf_inv_want=want, bit_equal_second_call=same,
               normal_gemm_ms=gemm_ms, normal_cholesky_ms=chol_ms,
               host_x_min=float(_host(et, x).min()))
    ok = (info["converged"] and info["rel_gap"] < LP_TOL
          and info["pfeas"] < LP_TOL and info["dfeas"] < LP_TOL
          and pobj_err < 1e-6 and launches["potrf_inv"] == want
          and runs[1][5]["potrf_inv"] == want and same
          and launches["lu_panel"] == launches["qr_panel"] == 0)
    if not ok:
        raise AssertionError(f"3n (a) lp: {json.dumps(out)}")
    return out


def _solver_nnls(et, grid, kern, S) -> dict:
    """3n (b): ``nnls`` (``qp`` without constraints: a Cholesky of Q +
    X^{-1} Z an iteration) at m x n float64; the KKT conditions checked
    on the host in float64."""
    import numpy as np
    m, n = S["nnls_m"], S["nnls_n"]
    rng = np.random.default_rng(15)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=(m, 1))
    Ad, bd = _dm(et, A, grid), _dm(et, b, grid)
    _reset(kern)
    _sync()
    t = time.perf_counter()
    x, info = et.nnls(Ad, bd)
    _sync()
    wall = time.perf_counter() - t
    launches = _counts_now(*kern)
    xh = _host(et, x)
    g = A.T @ (A @ xh - b)
    atb = float(np.linalg.norm(A.T @ b))
    # one factorization an iteration; a converged run stops before its
    # last iteration's (the dual feasibility can stall above the tol on
    # this problem class: the gates are the KKT conditions)
    factorizations = info["iters"] + (not info["converged"])
    want = factorizations * -(-n // 2048)
    out = {"m": m, "n": n, "dtype": "float64", "iters": info["iters"],
           "converged": info["converged"], "wall_s": wall,
           "dfeas": info["dfeas"], "launches": launches,
           "factorizations": factorizations, "potrf_inv_want": want,
           "x_min": float(xh.min()), "grad_min_rel": float(g.min()) / atb,
           "compl_rel": float(np.abs(xh * g).max())
           / (atb * max(1.0, float(np.abs(xh).max()))),
           "active": int((xh > 1e-9).sum())}
    ok = (out["x_min"] > -1e-9
          and out["grad_min_rel"] >= -1e-6 and out["compl_rel"] < 1e-6
          and launches["potrf_inv"] == want)
    if not ok:
        raise AssertionError(f"3n (b) nnls: {json.dumps(out)}")
    return out


def _solver_rpca(et, grid, kern, S) -> dict:
    """3n (c): ``rpca`` of L0 + S0 (rank r, 5% gross outliers, built as
    ``tests/optimization/test_solvers.py::test_rpca_recovery`` builds its
    input), float64, tol 1e-7: each iteration's ``svt`` is an ``svd``
    (QDWH: ``qr_panel`` and ``potrf_inv``)."""
    import numpy as np
    m, n, r = S["rpca_m"], S["rpca_n"], S["rpca_rank"]
    rng = np.random.default_rng(8)
    L0 = rng.normal(size=(m, r)) @ rng.normal(size=(r, n))
    S0 = np.zeros((m, n))
    idx = rng.choice(m * n, m * n // 20, replace=False)
    S0.flat[idx] = rng.normal(size=len(idx)) * 5
    Md = _dm(et, L0 + S0, grid)
    _reset(kern)
    _sync()
    t = time.perf_counter()
    L, Sp, info = et.rpca(Md, tol=1e-7, max_iters=100)
    _sync()
    wall = time.perf_counter() - t
    launches = _counts_now(*kern)
    err = float(np.linalg.norm(_host(et, L) - L0) / np.linalg.norm(L0))
    out = {"m": m, "n": n, "rank": r, "dtype": "float64",
           "iters": info["iters"], "converged": info["converged"],
           "L_rel_err": err, "wall_s": wall,
           "s_per_iter": wall / (info["iters"] + 1), "launches": launches}
    if not (info["converged"] and err < 1e-5 and launches["qr_panel"] > 0
            and launches["potrf_inv"] > 0):
        raise AssertionError(f"3n (c) rpca: {json.dumps(out)}")
    return out


def _cone_interior(rng, orders):
    import numpy as np
    parts = []
    for k in orders:
        v = rng.normal(size=k)
        v[0] = np.linalg.norm(v[1:]) + rng.uniform(0.5, 2.0)
        parts.append(v)
    return np.concatenate(parts)


def _solver_conic(et, grid, kern, S) -> dict:
    """3n (d): ``socp_affine`` and ``qp_affine`` built as
    ``tests/optimization/test_affine.py`` builds them, at a KKT order of
    ~2048 (each iteration one ``ldl`` of the stacked KKT matrix on the
    card); those tests' checks, relative to the data's size."""
    import numpy as np
    res: dict = {}
    rng = np.random.default_rng(7)
    orders = [S["socp_order"]] * S["socp_cones"]
    k = sum(orders)
    n, m = S["socp_n"], S["socp_m"]
    A = rng.normal(size=(m, n))
    G = rng.normal(size=(k, n))
    x0, y0 = rng.normal(size=n), rng.normal(size=m)
    s0, z0 = _cone_interior(rng, orders), _cone_interior(rng, orders)
    b, h, c = A @ x0, G @ x0 + s0, -A.T @ y0 - G.T @ z0
    _reset(kern)
    t = time.perf_counter()
    x, y, z, s, info = et.socp_affine(*[_dm(et, F, grid)
                                        for F in (A, G, b, c, h)], orders)
    wall = time.perf_counter() - t
    heads = np.cumsum([0] + orders[:-1])
    tails = [np.linalg.norm(v[hd + 1:hd + kk]) for v in (s, z)
             for hd, kk in zip(heads, orders)]
    cone_gap = min(min(s[heads] - tails[:len(orders)]),
                   min(z[heads] - tails[len(orders):]))
    out = {"n": n, "m": m, "k": k, "kkt_order": n + m + k,
           "iters": info["iters"], "converged": info["converged"],
           "wall_s": wall, "s_per_iter": wall / (info["iters"] + 2),
           "primal_eq": float(np.linalg.norm(A @ x - b)
                              / (1 + np.linalg.norm(b))),
           "primal_cone": float(np.linalg.norm(G @ x + s - h)
                                / (1 + np.linalg.norm(h))),
           "dual": float(np.linalg.norm(c + A.T @ y + G.T @ z)
                         / (1 + np.linalg.norm(c))),
           "compl": float(abs(s @ z) / (1 + abs(info["pobj"]))),
           "cone_margin": float(cone_gap), "launches": _counts_now(*kern)}
    res["socp_affine"] = out
    if not (info["converged"] and out["primal_eq"] < 1e-6
            and out["primal_cone"] < 1e-6 and out["dual"] < 1e-5
            and out["compl"] < 1e-5 and cone_gap > -1e-7):
        raise AssertionError(f"3n (d) socp_affine: {json.dumps(out)}")
    rng = np.random.default_rng(6)
    n = S["qp_n"]
    Q0 = rng.normal(size=(n, n))
    Q = Q0 @ Q0.T + n * np.eye(n)
    c = rng.normal(size=n)
    A = np.ones((1, n))
    b = np.array([n / 2.0])
    G = np.vstack([-np.eye(n), np.eye(n)])
    h = np.concatenate([np.zeros(n), np.ones(n)])
    _reset(kern)
    t = time.perf_counter()
    x, y, z, s, info = et.qp_affine(*[_dm(et, F, grid)
                                      for F in (Q, A, G, b, c, h)])
    wall = time.perf_counter() - t
    kkt = Q @ x + c + A.T @ y + G.T @ z
    out = {"n": n, "kkt_order": 3 * n + 1, "iters": info["iters"],
           "converged": info["converged"], "wall_s": wall,
           "s_per_iter": wall / (info["iters"] + 2),
           "stationarity": float(np.linalg.norm(kkt)
                                 / (1 + np.linalg.norm(c))),
           "z_min": float(z.min()),
           "compl": float(abs(z @ (h - G @ x)) / (1 + abs(info["pobj"]))),
           "launches": _counts_now(*kern)}
    res["qp_affine"] = out
    if not (info["converged"] and out["stationarity"] < 1e-5
            and out["z_min"] > -1e-8 and out["compl"] < 1e-5):
        raise AssertionError(f"3n (d) qp_affine: {json.dumps(out)}")
    return res


def _solver_sparse(et, grid, S) -> dict:
    """3n (e): ``cg`` on the 2-D Laplacian, ``gmres`` on one
    backward-Euler step of 2-D convection-diffusion, ``sparse_direct_solve``
    on a smaller Laplacian; each residual recomputed on the host in
    float64; ``spmv`` / ``spmv_adjoint`` bit-equal run to run."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from elemental_tpu_torch.core.multivec import (mv_from_global,
                                                   mv_to_global)
    res: dict = {}
    rows, cols, vals, n = _laplacian_2d(S["cg_k"])
    t = time.perf_counter()
    A = et.dist_sparse_from_coo(rows, cols, vals, n, n, grid=grid)
    A._plan("adjoint")
    freeze_s = time.perf_counter() - t
    Ah = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    b = np.random.default_rng(16).normal(size=(n, 1))
    bd = mv_from_global(b, grid=grid)
    y1, y2 = A.spmv(bd), A.spmv(bd)
    a1, a2 = A.spmv_adjoint(bd), A.spmv_adjoint(bd)
    same = torch.equal(y1.local, y2.local) and torch.equal(a1.local,
                                                           a2.local)
    spmv_ms = _time_ms(lambda: A.spmv(bd), 20)
    spmv_adj_ms = _time_ms(lambda: A.spmv_adjoint(bd), 20)
    spmv_err = float(np.abs(mv_to_global(y1).cpu().numpy() - Ah @ b).max())
    _sync()
    t = time.perf_counter()
    x, info = et.cg(A, bd, tol=1e-8)
    _sync()
    wall = time.perf_counter() - t
    xh = mv_to_global(x).cpu().numpy()
    true_res = float(np.linalg.norm(Ah @ xh - b) / np.linalg.norm(b))
    res["cg"] = {"n": n, "nnz": A.nnz, "freeze_s": freeze_s,
                 "iters": info["iters"], "relres": float(info["relres"]),
                 "true_relres": true_res, "wall_s": wall,
                 "ms_per_iter": 1e3 * wall / max(info["iters"], 1),
                 "spmv_ms": spmv_ms, "spmv_adjoint_ms": spmv_adj_ms,
                 "spmv_bytes_floor_ms": 1e3 * (A.nnz * 16 + 2 * n * 8)
                 / PEAK_BYTES,
                 "spmv_max_abs_err": spmv_err, "spmv_bit_equal": same}
    if not (info["converged"] and info["relres"] < 1e-8
            and true_res < 1e-7 and same and spmv_err < 1e-12):
        raise AssertionError(f"3n (e) cg: {json.dumps(res['cg'])}")
    # gmres: (I + dt L_conv-diff) with dt-scaled central convection
    k = S["gmres_k"]
    rows, cols, vals, n = _laplacian_2d(k)
    vals = vals + np.where(cols == rows + 1, 0.4, 0.0) \
        - np.where(cols == rows - 1, 0.4, 0.0) + (rows == cols) * 1.0
    A = et.dist_sparse_from_coo(rows, cols, vals, n, n, grid=grid)
    Ah = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    b = np.random.default_rng(17).normal(size=(n, 1))
    _sync()
    t = time.perf_counter()
    x, info = et.gmres(A, mv_from_global(b, grid=grid), tol=1e-8)
    _sync()
    xh = mv_to_global(x).cpu().numpy()
    res["gmres"] = {"n": n, "iters": info["iters"],
                    "relres": float(info["relres"]),
                    "true_relres": float(np.linalg.norm(Ah @ xh - b)
                                         / np.linalg.norm(b)),
                    "wall_s": time.perf_counter() - t}
    if not (info["converged"] and res["gmres"]["true_relres"] < 1e-7):
        raise AssertionError(f"3n (e) gmres: {json.dumps(res['gmres'])}")
    rows, cols, vals, n = _laplacian_2d(S["direct_k"])
    A = et.dist_sparse_from_coo(rows, cols, vals, n, n, grid=grid)
    Ah = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    b = np.random.default_rng(18).normal(size=(n, 1))
    t = time.perf_counter()
    x, info = et.sparse_direct_solve(A, mv_from_global(b, grid=grid))
    xh = mv_to_global(x).cpu().numpy()
    res["sparse_direct_solve"] = {
        "n": n, "relres": float(info["relres"]),
        "true_relres": float(np.linalg.norm(Ah @ xh - b)
                             / np.linalg.norm(b)),
        "wall_s": time.perf_counter() - t}
    if not (info["converged"]
            and res["sparse_direct_solve"]["true_relres"] < 1e-10):
        raise AssertionError("3n (e) sparse_direct_solve: "
                             + json.dumps(res["sparse_direct_solve"]))
    return res


def _banded(seed, m, n, w, last_start):
    """``tests/optimization/test_sparse_ipm.py``'s banded operators: row i
    covers the w columns from a start drawn in [0, last_start)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, last_start, m)
    rows = np.repeat(np.arange(m), w)
    cols = (starts[:, None] + np.arange(w)[None, :]).reshape(-1)
    return rng, rows, cols, rng.normal(size=m * w)


def _solver_sparse_ipm(et, grid, S) -> dict:
    """3n (f): ``lav_sparse`` on the banded 10 000 x 5 000 matrix of
    ``tests/optimization/test_sparse_ipm.py::test_lav_sparse_10k_cg_engine``
    with ``kkt='cg'`` (that test's ctrl; two runs bit-equal; the captured
    CG graph's replays and host reads per solve), the same problem with
    ``kkt='direct'`` at tol 1e-6, and ``bp_sparse`` at 5 000 x 10 000
    (``test_bp_sparse_5k_x_10k``)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from elemental_tpu_torch.core.multivec import (mv_from_global,
                                                   mv_to_global)
    from elemental_tpu_torch.optimization import sparse_ipm
    res: dict = {}
    m, n, w = S["lav_m"], S["lav_n"], S["lav_w"]
    rng, rows, cols, vals = _banded(4, m, n, w, n - w)
    As = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    xt = rng.normal(size=n)
    b = As @ xt
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid,
                                dtype=np.float64)
    bd = mv_from_global(b.reshape(-1, 1), grid=grid)
    xs = []
    for rep in range(2):
        before = dict(sparse_ipm.PCG_COUNTS)
        _sync()
        t = time.perf_counter()
        x, info = et.lav_sparse(A, bd, et.MehrotraCtrl(tol=1e-3,
                                                       max_iters=25),
                                kkt="cg", cg_maxiter=4000)
        _sync()
        wall = time.perf_counter() - t
        d = {k: sparse_ipm.PCG_COUNTS[k] - before[k] for k in before}
        xs.append(x)
    solves = max(d["solves"], 1)
    res["lav_cg"] = {"m": m, "n": n, "iters": info["iters"],
                     "rel_gap": info["rel_gap"], "cg_iters": info["cg_iters"],
                     "wall_s": wall, "cg_solves": d["solves"],
                     "captures": d["captures"],
                     "replays_per_solve": d["chunks"] / solves,
                     "host_reads_per_solve": d["reads"] / solves,
                     "cg_iters_per_solve": d["iters"] / solves,
                     "bit_equal_second_run": torch.equal(xs[0].local,
                                                         xs[1].local)}
    if not (info["cg_iters"] > 0 and info["rel_gap"] < 1e-3
            and res["lav_cg"]["bit_equal_second_run"]
            and d["captures"] == 1 and d["reads"] == d["chunks"]):
        raise AssertionError(f"3n (f) lav_sparse cg: "
                             f"{json.dumps(res['lav_cg'])}")
    _sync()
    t = time.perf_counter()
    x, info = et.lav_sparse(A, bd, et.MehrotraCtrl(tol=1e-6, max_iters=60),
                            kkt="direct")
    xg = mv_to_global(x).cpu().numpy().ravel()
    cover = np.zeros(n, np.int64)
    np.add.at(cover, cols, 1)
    well = cover >= 10
    rec = float(np.linalg.norm((xg - xt)[well]) / np.linalg.norm(xt[well]))
    res["lav_direct"] = {"iters": info["iters"], "rel_gap": info["rel_gap"],
                         "converged": info["converged"],
                         "recovery_rel_err": rec,
                         "wall_s": time.perf_counter() - t}
    if not (info["converged"] and info["rel_gap"] < 1e-6 and rec < 1e-4):
        raise AssertionError(f"3n (f) lav_sparse direct: "
                             f"{json.dumps(res['lav_direct'])}")
    m, n, w = S["bp_m"], S["bp_n"], S["bp_w"]
    rng, rows, cols, vals = _banded(5, m, n, w, n - w + 1)
    As = sp.csr_matrix((vals, (rows, cols)), shape=(m, n))
    xs_ = np.zeros(n)
    sup = rng.choice(n, 120, replace=False)
    xs_[sup] = rng.normal(size=sup.size) * 3
    b = As @ xs_
    A = et.dist_sparse_from_coo(rows, cols, vals, m, n, grid=grid,
                                dtype=np.float64)
    t = time.perf_counter()
    x, info = et.bp_sparse(A, mv_from_global(b.reshape(-1, 1), grid=grid),
                           et.MehrotraCtrl(tol=1e-6, max_iters=80), refine=2)
    xg = mv_to_global(x).cpu().numpy().ravel()
    res["bp"] = {"m": m, "n": n, "iters": info["iters"],
                 "rel_gap": info["rel_gap"], "pfeas": info["pfeas"],
                 "dfeas": info["dfeas"],
                 "residual": float(np.linalg.norm(As @ xg - b)
                                   / np.linalg.norm(b)),
                 "l1_over_planted": float(np.abs(xg).sum()
                                          / np.abs(xs_).sum()),
                 "wall_s": time.perf_counter() - t}
    if not (info["rel_gap"] < 1e-6 and info["pfeas"] < 1e-5
            and info["dfeas"] < 1e-5 and res["bp"]["residual"] < 1e-5
            and res["bp"]["l1_over_planted"] <= 1 + 1e-6):
        raise AssertionError(f"3n (f) bp_sparse: {json.dumps(res['bp'])}")
    return res


def _solver_lattice_io(et, grid, S) -> dict:
    """3n (g): ``lll`` of a knapsack lattice (built as
    ``tests/lattice/test_lll.py::test_lll_knapsack_short_vector`` builds
    it) against the same call on a CPU grid; ``checkpoint`` / ``restore``
    of an n x n float32 DistMatrix on a virtual 2x2 grid; a Matrix Market
    round trip of (e)'s direct-solve Laplacian."""
    import os
    import tempfile
    import numpy as np
    import torch
    res: dict = {}
    n = S["lll_n"]
    rng = np.random.default_rng(1)
    a = rng.integers(100, 500, n)
    xk = rng.integers(0, 2, n)
    B = np.zeros((n + 1, n + 1))
    B[:n, :n] = np.eye(n)
    B[n, :n] = 1000 * a
    B[n, n] = -1000 * int(a @ xk)
    t = time.perf_counter()
    R, U, info = et.lll(_dm(et, B, grid))
    wall = time.perf_counter() - t
    Rc, Uc, info_c = et.lll(_dm(et, B, et.Grid(device="cpu")))
    same = (np.array_equal(_host(et, R), _host(et, Rc))
            and np.array_equal(_host(et, U), _host(et, Uc))
            and info == info_c)
    res["lll"] = {"n": n + 1, "swaps": info["swaps"],
                  "first_norm": info["first_norm"],
                  "min_norm": float(np.linalg.norm(_host(et, R),
                                                   axis=0).min()),
                  "reduced": et.is_lll_reduced(R), "equal_to_cpu": same,
                  "wall_s": wall}
    if not (res["lll"]["reduced"] and same):
        raise AssertionError(f"3n (g) lll: {json.dumps(res['lll'])}")
    g22 = et.Grid(2, 2)
    nn = S["ckpt_n"]
    gen = torch.Generator(device=grid.device)
    gen.manual_seed(19)
    F = torch.randn(nn, nn, generator=gen, device=grid.device)
    D = et.from_global(F, et.MC, et.MR, grid=g22)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        et.checkpoint(tmp, D=D)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        back = et.restore(tmp, ["D"], grid=g22)["D"]
        read_s = time.perf_counter() - t
        size = os.path.getsize(os.path.join(tmp, "D.npz"))
        ok_ck = torch.equal(back.local, D.local) and back.gshape == D.gshape
        rows, cols, vals, nl = _laplacian_2d(S["direct_k"])
        L = et.dist_sparse_from_coo(rows, cols, vals, nl, nl, grid=grid)
        p = os.path.join(tmp, "laplacian.mtx")
        t = time.perf_counter()
        et.write_matrix_market(L, p)
        L2 = et.read_matrix_market(p, grid=grid)
        mm_s = time.perf_counter() - t
        mm_same = all(np.array_equal(u, v) for u, v in
                      zip(et.sparse.sparse_to_coo(L),
                          et.sparse.sparse_to_coo(L2)))
    res["checkpoint"] = {"n": nn, "grid": "2x2", "bytes": size,
                         "write_s": write_s, "read_s": read_s,
                         "bit_equal": ok_ck}
    res["matrix_market"] = {"n": nl, "nnz": L.nnz, "s": mm_s,
                            "triplets_equal": mm_same}
    if not (ok_ck and mm_same):
        raise AssertionError(f"3n (g) io: {json.dumps(res)}")
    return res


def phase_solvers(et, card: str) -> dict:
    """3n: the solvers of the long tail on the card (see the module
    docstring): (a) the dense LP, (b) NNLS, (c) RPCA, (d) the conic
    steps, (e) the sparse solvers, (f) the sparse IPMs, (g) lattice and
    IO.  1x1 grid, float64 unless said, TF32 off."""
    import torch
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    S = SOLVER_SIZES
    kern = (lu_panel, potrf_inv, qr_panel)
    grid = et.Grid()
    res: dict = {"card": card}
    steps = (("a", "lp", lambda: _solver_lp(et, grid, kern, S)),
             ("b", "nnls", lambda: _solver_nnls(et, grid, kern, S)),
             ("c", "rpca", lambda: _solver_rpca(et, grid, kern, S)),
             ("d", "conic", lambda: _solver_conic(et, grid, kern, S)),
             ("e", "sparse", lambda: _solver_sparse(et, grid, S)),
             ("f", "sparse_ipm", lambda: _solver_sparse_ipm(et, grid, S)),
             ("g", "lattice_io", lambda: _solver_lattice_io(et, grid, S)))
    for tag, name, fn in steps:
        t = time.perf_counter()
        res[name] = fn()
        res[name]["step_s"] = time.perf_counter() - t
        print(f"phase 3n ({tag}) {name} " + json.dumps(res[name]),
              flush=True)
        torch.cuda.empty_cache()
    return res


#: (n, nb) of 3o (b): every matrix 256 MiB in float32, four blocked
#: steps per driver
METER_GEOMETRY = (8192, 1024)
#: 3o (b)'s bound on |meter peak - allocator peak| / allocator peak.  The
#: profiler reports the caching allocator's own block sizes, so the two
#: count the same bytes; what could sit between them is an allocation the
#: warm run did not make (a cuBLAS workspace on a new stream, a grown
#: cache), which the warm-up excludes
METER_TOL = 0.01
#: the drivers of 3o (b)
METER_DRIVERS = ("cholesky_lookahead", "lu_crossover", "qr")


def _analysis_invariance(et, kern) -> dict:
    """3o (a): each factorization driver's comm plan with the kernels on
    the card equals its plan with the plain panels on the CPU."""
    import torch
    from elemental_tpu_torch import analysis as an
    names = [d for d in an.driver_names()
             if d.split("_")[0] in ("cholesky", "lu", "qr")]
    cuda, cpu = et.Grid(2, 2), et.Grid(2, 2, device="cpu")
    _reset(kern)
    docs = {}
    with an.panel_impl_override("kernel"):
        for name in names:
            docs[name] = an.golden_doc(an.trace_driver(name, cuda)[0])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kern}
    with an.panel_impl_override("torch"):
        for name in names:
            want = an.golden_doc(an.trace_driver(name, cpu)[0])
            if json.dumps(docs[name]) != json.dumps(want):
                raise RuntimeError(
                    f"3o (a): {name}'s comm plan with the kernels differs "
                    f"from the plain panels': "
                    f"{an.diff_docs(want, docs[name])}")
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"3o (a): {k} was not launched")
    return {"drivers": len(names), "byte_equal": True,
            "launches": launches}


def _analysis_meter(et) -> dict:
    """3o (b): the memory meter's peak against the allocator's."""
    import torch
    from elemental_tpu_torch import analysis as an
    from elemental_tpu_torch.redist import engine
    n, nb = METER_GEOMETRY
    g = et.Grid(2, 2)
    out = {"n": n, "nb": nb, "tol": METER_TOL}
    for name in METER_DRIVERS:
        fn, args, _ = an.build_driver(name, g, n, nb)
        timed = an.DRIVERS[name].timed
        with engine.isolated_probe(refs=False):
            fn(*args)                                   # warm every cache
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with engine.isolated_probe(refs=False):
            stats, res = an.measure_call(fn, args, (2, 2), name, timed,
                                         "cuda")
        secs = time.perf_counter() - t
        alloc = torch.cuda.max_memory_allocated() - base
        rel = abs(stats.total_peak_bytes - alloc) / max(alloc, 1)
        out[name] = {"meter_peak_bytes": stats.total_peak_bytes,
                     "allocator_peak_bytes": alloc, "rel_gap": rel,
                     "per_device_peak_bytes": stats.peak_bytes,
                     "peak_at": "/".join(stats.peak_path),
                     "peak_op": stats.peak_prim, "measure_s": secs}
        if rel > METER_TOL:
            raise RuntimeError(f"3o (b): {name}'s meter peak "
                               f"{stats.total_peak_bytes} B is off the "
                               f"allocator's {alloc} B by {rel:.2%}")
        del fn, args, res
        torch.cuda.empty_cache()
    return out


def _analysis_smem() -> dict:
    """3o (c): EL007's 'gpu' row against the card and the kernel."""
    import importlib
    import torch
    from elemental_tpu_torch import analysis as an
    # the module, not the wrapper the package rebinds its name to
    lpm = importlib.import_module("elemental_tpu_torch.kernels.lu_panel")
    row = an.SMEM_ROWS["gpu"]
    props = torch.cuda.get_device_properties(0)
    got = {"sm_count": props.multi_processor_count,
           "smem_optin": props.shared_memory_per_block_optin}
    out = {"row": {"sm_count": row.sm_count, "smem_optin": row.smem_optin,
                   "static_smem": dict(row.static_smem)},
           "props": got, "kernel": {}}
    for dt in (torch.float32, torch.float64):
        name = str(dt).removeprefix("torch.")
        k = lpm.smem_constants(dt)
        out["kernel"][name] = k
        want = {"sm_count": row.sm_count, "smem_optin": row.smem_optin,
                "static_smem": row.static_smem[name]}
        if k != want or got != {kk: want[kk] for kk in got}:
            raise RuntimeError(f"3o (c): the EL007 row {want} differs from "
                               f"the kernel's {k} / the card's {got}")
    out["spill_rows"] = {dt: an.spill_rows(dt)
                         for dt in ("float32", "float64")}
    return out


def phase_analysis(et, card: str) -> dict:
    """3o: the static analysis on the card (see the module docstring)."""
    from elemental_tpu_torch.kernels import lu_panel, potrf_inv, qr_panel
    kern = (potrf_inv, lu_panel, qr_panel)
    res: dict = {"card": card}
    for tag, name, fn in (("a", "invariance",
                           lambda: _analysis_invariance(et, kern)),
                          ("b", "meter", lambda: _analysis_meter(et)),
                          ("c", "smem", _analysis_smem)):
        t = time.perf_counter()
        res[name] = fn()
        res[name]["step_s"] = time.perf_counter() - t
        print(f"phase 3o ({tag}) {name} " + json.dumps(res[name]),
              flush=True)
    return res


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
    common.build(["potrf_inv", "lu_panel", "qr_panel"])
    print(f"phase 1 build_s {time.perf_counter() - t0:.3f}", flush=True)

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {label} wall_s {time.perf_counter() - t:.1f}",
              flush=True)
        return out

    rows = timed("2 potrf_inv", phase_kernels, et)
    lu_rows = timed("2 lu_panel", phase_lu_panel)
    qr_rows = timed("2 qr_panel", phase_qr_panel)
    main_path = timed("3", phase_main_path, et, card)
    lu_path = timed("3b", phase_lu_main_path, et, card)
    qr_path = timed("3c", phase_qr_main_path, et, card)
    eig_path = timed("3d", phase_eig_main_path, et, card)
    svd_path = timed("3e", phase_svd_main_path, et, card)
    svd_rest = timed("3f", phase_svd_rest, et, card)
    ldl_path = timed("3g", phase_ldl_main_path, et, card)
    ldl_rest = timed("3h", phase_ldl_rest, et, card)
    calu_tsqr = timed("3i", phase_calu_tsqr, et, card, lu_path, qr_path)
    resilience = timed("3j", phase_resilience, et, card, main_path, lu_path,
                       qr_path)
    tuner = timed("3k", phase_tuner, et, card, main_path, lu_path, qr_path)
    tracing = timed("3l", phase_tracing, et, card, main_path, lu_path,
                    qr_path)
    serving = timed("3m", phase_serving, et, card)
    solvers = timed("3n", phase_solvers, et, card)
    analysis = timed("3o", phase_analysis, et, card)
    t4 = time.perf_counter()
    phase_distributed(et)
    phase_lu_distributed(et)
    phase_qr_distributed(et)
    phase_eig_distributed(et)
    phase_svd_distributed(et)
    phase_ldl_distributed(et)
    et.entry.dryrun_multichip(8)
    print(f"phase 4 wall_s {time.perf_counter() - t4:.1f}", flush=True)

    at_path = next(r for r in rows if r["w"] == 2048 and r["dtype"] == "float32")
    at_eig = next(r for r in rows if r["w"] == 512 and r["dtype"] == "float32")
    print("phase 3d/3e potrf_inv at w = 512 " + json.dumps(
        {k: at_eig[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "max_abs_err")}
        | {"launches_3d": eig_path["potrf_inv_launches"],
           "launches_3e": svd_path["potrf_inv_launches"]}), flush=True)
    qr_svd = next(r for r in qr_rows if r["path"] == "3e")
    print("phase 3e qr_panel at 16384 x 512 " + json.dumps(
        {k: qr_svd[k] for k in ("kernel_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "max_abs_err")}
        | {"launches_3e": svd_path["qr_panel_launches"]}), flush=True)
    keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    qr_ridge = next(r for r in qr_rows if r["path"] == "3h")
    print("phase 3h qr_panel at 40960 x 512 (ridge, tikhonov) " + json.dumps(
        {k: qr_ridge[k] for k in keys}
        | {f"launches_3h_{k}": ldl_rest[k]["launches"]["qr_panel"]
           for k in ("ridge", "tikhonov")}), flush=True)
    lu_det = next(r for r in lu_rows if r["M"] == 8192 and r["nbw"] == 512)
    print("phase 3h lu_panel at 8192 x 512 (determinants) " + json.dumps(
        {k: lu_det[k] for k in keys}
        | {f"launches_3h_{k}": ldl_rest[k]["launches"]["lu_panel"]
           for k in ("determinant", "safe_determinant")}), flush=True)

    at_lp = next(r for r in rows
                 if r["w"] == 2048 and r["dtype"] == "float64")
    print("phase 3n potrf_inv at w = 2048 float64 (lp, nnls) " + json.dumps(
        {k: at_lp[k] for k in keys}
        | {f"launches_3n_{k}": solvers[k]["launches"]["potrf_inv"]
           for k in ("lp", "nnls")}), flush=True)

    def by_phase(name):
        """The kernel's launches on each path that runs it."""
        key = f"{name}_launches"
        out = {p: d[key] for p, d in (("3", main_path), ("3b", lu_path),
                                      ("3c", qr_path), ("3d", eig_path),
                                      ("3e", svd_path), ("3g", ldl_path))
               if d.get(key)}
        for ph, rest in (("3f", svd_rest), ("3h", ldl_rest),
                         ("3i", calu_tsqr), ("3j", resilience),
                         ("3k", tuner), ("3l", tracing),
                         ("3m", serving), ("3n", solvers),
                         ("3o", analysis)):
            for step, d in rest.items():
                if isinstance(d, dict) and d.get("launches", {}).get(name):
                    out[f"{ph} {step}"] = d["launches"][name]
        return out

    kernels = [{
        "name": "potrf_inv", "route": "cuda",
        "source": "elemental_tpu_torch/kernels/csrc/potrf_inv.cu",
        "replaces": "elemental_tpu/kernels/chol_panel.py:122",
        "launches": main_path["potrf_inv_launches"],
        "max_abs_err": at_path["max_abs_err"], "ms": at_path["kernel_ms"],
        "plain_ms": at_path["plain_ms"], "bound_ms": at_path["bound_ms"],
        "bound_by": at_path["bound_by"], "library_ms": at_path["library_ms"],
        "launches_by_phase": by_phase("potrf_inv"),
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
        "library_ms": lu_at["library_ms"],
        "launches_by_phase": by_phase("lu_panel")})
    qr_at = next(r for r in qr_rows if r["path"] == "3c")
    kernels.append({
        "name": "qr_panel", "route": "cuda",
        "source": "elemental_tpu_torch/kernels/csrc/qr_panel.cu",
        "replaces": "elemental_tpu/kernels/qr_panel.py:95",
        "launches": qr_path["qr_panel_launches"],
        "max_abs_err": qr_at["max_abs_err"],
        "ms": qr_at["kernel_ms"], "plain_ms": qr_at["plain_ms"],
        "bound_ms": qr_at["bound_ms"], "bound_by": qr_at["bound_by"],
        "library_ms": qr_at["library_ms"],
        "launches_by_phase": by_phase("qr_panel")})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
