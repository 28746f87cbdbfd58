"""A/B perf harness of the port's schedules (the twin of the JAX package's
``perf/ab_harness.py``).

Runs several schedule variants IN ONE PROCESS on the card, bracketing
each timing with a full-float32 matmul roofline (TF32 off, timed with
CUDA events) so the card's weather is factored out per variant: never
land a "perf" change without a before/after pair.  Usage:

    python -m elemental_tpu_torch.perf.ab_harness chol [N]
                        # _potrf_inv variants (default N = 32768)
    python -m elemental_tpu_torch.perf.ab_harness lu [N]
                        # LU: classic vs look-ahead, nb + inners sweep
                        #   (default 16384)
    python -m elemental_tpu_torch.perf.ab_harness cholesky [N]
                        # Cholesky: classic vs look-ahead x nb x
                        #   crossover (default 16384)
    python -m elemental_tpu_torch.perf.ab_harness lu-dist [N]
                        # distributed LU: classic panel vs CALU
                        #   tournament x look-ahead x tail crossover x
                        #   comm_precision wire
    python -m elemental_tpu_torch.perf.ab_harness gemm [N]
                        # the gemm alg family (A/B/C/dot/gspmd/slice/
                        #   auto) x shape class (square / tall-skinny /
                        #   outer-product), with wire twins of the slice
                        #   rows
    python -m elemental_tpu_torch.perf.ab_harness panel [M]
                        # the three panel primitives: plain version, CUDA
                        #   kernel and library call, nb in {64..2048} x
                        #   {float32, float64} at panel height M
                        #   (default 16384)
    python -m elemental_tpu_torch.perf.ab_harness phases [lu|cholesky] [N NB]
                        # per-step phase wall clock as one
                        #   phase_timings/v1 JSON line

Flags: ``--grid RxC``, the virtual grid of ``cholesky``, ``lu-dist`` and
``gemm`` (default 1x1; the JAX harness takes every visible device);
``--comm-precision bf16,int8`` (or ``none``), the wire modes the
distributed modes sweep; ``--device cpu`` (default ``cuda``; without a
card the harness exits 2).  On the CPU the sizes default small (512, a
panel height of 1024, nb 128) and the times say nothing of the card.

Each row prints ``name  TFLOP/s  roof  norm``: the variant's rate, the
mean of the matmul rates measured just before and after it, and the
ratio.  The rates keep the JAX harness's operation counts (``chol`` and
``cholesky`` N^3/3, ``lu`` 2N^3/3, ``gemm`` 2mkn; the panel rows say
theirs: ``lu`` M nb^2 - nb^3/3, ``chol`` nb^3, ``qr`` 2 nb^2 (M - nb/3)),
which are not the bounds of ``PERF.md``'s kernel table.  A row whose
variant the port refuses (a knob it has not ported, a chunk the kernel
does not take) prints ``skip`` with the reason.  In ``panel`` the kernel
rows print ``skip (cpu: plain route)`` on the CPU; on the card a failing
kernel raises.
"""
from __future__ import annotations

import importlib
import json
import sys
import time

import torch

#: panel widths of the ``panel`` sweep (those <= M)
PANEL_NBS = (64, 128, 256, 512, 1024, 2048)
#: the three panel primitives, in the JAX harness's order
PANEL_PRIMS = ("lu", "chol", "qr")
#: the operation count each panel row's rate uses (the JAX harness's)
PANEL_FLOPS = {"lu": "M nb^2 - nb^3/3", "chol": "nb^3",
               "qr": "2 nb^2 (M - nb/3)"}

#: what a refused variant raises: a knob the port has not ported, a
#: chunk or shape the kernel does not take, a schedule too large for the
#: card
REFUSED = (NotImplementedError, ValueError, torch.OutOfMemoryError)


def _min3(fn, reps=3):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


class Bench:
    """The device a harness run times on, with its roofline bracket."""

    def __init__(self, device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        self.device = dev
        self.on_card = dev.type == "cuda"
        self._roof_x = None
        t = torch.zeros((), device=dev)
        self.sync()
        self.latency_s = _min3(lambda: (t + 1.0, self.sync()))

    @property
    def name(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.on_card \
            else "cpu"

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def elapsed(self, fn) -> float:
        """Seconds of one ``fn()``: CUDA events around it on the card (the
        stream's time from its first launch to its last), the host clock
        on the CPU."""
        if not self.on_card:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / 1e3

    def roofline(self, n=None) -> float:
        """TFLOP/s of a full-float32 ``torch.matmul`` (TF32 off) at ``n``,
        by default 8192 (512 on the CPU, where the bracket is only an
        in-run yardstick)."""
        n = n or (8192 if self.on_card else 512)
        if self._roof_x is None or self._roof_x.shape[0] != n:
            g = torch.Generator(device=self.device)
            g.manual_seed(9)
            self._roof_x = torch.randn(n, n, generator=g,
                                       device=self.device)
        x = self._roof_x
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            torch.matmul(x, x)
            dt = min(self.elapsed(lambda: torch.matmul(x, x))
                     for _ in range(3))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return 2 * n ** 3 / max(dt, 1e-9) / 1e12

    def timed(self, make_input, step, reps=3) -> float:
        """Least seconds of ``step(make_input())`` over ``reps`` runs,
        after one untimed run; the input is made outside the timing."""
        out = step(make_input())
        self.sync()
        del out
        times = []
        for _ in range(reps):
            a = make_input()
            self.sync()
            times.append(self.elapsed(lambda: step(a)))
            del a
        return max(min(times), 1e-9)

    def bracketed(self, make_input, step, reps=3) -> tuple:
        """``(seconds, mean roofline TFLOP/s)`` of one timed variant."""
        r0 = self.roofline()
        dt = self.timed(make_input, step, reps)
        r1 = self.roofline()
        return dt, 0.5 * (r0 + r1)


def report(name, tflops, roof, extra="") -> dict:
    """Print one row and return it."""
    print(f"{name:44s} {tflops:8.3f} TFLOP/s   roof {roof:6.2f}"
          f"   norm {100 * tflops / roof:5.1f}%{extra}", flush=True)
    return {"name": name, "tflops": tflops, "roof": roof}


def skip(name, err) -> dict:
    print(f"{name:44s} skip ({type(err).__name__}: {err})", flush=True)
    return {"name": name, "skip": f"{type(err).__name__}: {err}"}


def _spd(bench, n, dtype=torch.float32, seed=0):
    """G G^T / n + n I, made on the device from a seeded generator."""
    g = torch.Generator(device=bench.device)
    g.manual_seed(seed)
    G = torch.randn(n, n, generator=g, device=bench.device, dtype=dtype)
    A = G @ G.T
    A.div_(n)
    A.diagonal().add_(n)
    return A


def _normal(bench, shape, seed, dtype=torch.float32):
    g = torch.Generator(device=bench.device)
    g.manual_seed(seed)
    return torch.randn(*shape, generator=g, device=bench.device, dtype=dtype)


def _grid(spec, device):
    import elemental_tpu_torch as el
    r, c = (int(x) for x in (spec or "1x1").split("x"))
    return el.Grid(r, c, device=device)


def _dm(a, grid):
    import elemental_tpu_torch as el
    return el.from_global(a, el.MC, el.MR, grid=grid)


def run_chol(bench, n=None) -> list:
    """``cholesky`` on the 1x1 grid with ``_potrf_inv`` variants: the
    port's (``bs`` 512 and 1024, nb and 2 nb) and the library's
    ``cholesky`` + ``solve_triangular(L, I)`` in its place."""
    import elemental_tpu_torch as el
    chol_mod = importlib.import_module("elemental_tpu_torch.lapack.cholesky")
    n = int(n) if n else (32768 if bench.on_card else 512)
    nb0 = 2048 if bench.on_card else 128
    grid = el.Grid(device=bench.device)
    orig = chol_mod._potrf_inv

    def native_potrf_inv(D, precision, bs=512, plan=None):
        L = torch.linalg.cholesky(D)
        eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
        return L, torch.linalg.solve_triangular(L, eye, upper=False)

    def bs1024(D, precision, bs=512, plan=None):
        return orig(D, precision, 1024, plan)

    variants = [(f"_potrf_inv bs512 nb={nb}", orig, nb)
                for nb in (nb0, 2 * nb0)]
    variants += [(f"native potrf+trsm-inv nb={nb0}", native_potrf_inv, nb0),
                 (f"_potrf_inv bs1024 nb={2 * nb0}", bs1024, 2 * nb0),
                 (f"_potrf_inv bs1024 nb={nb0}", bs1024, nb0)]
    rows = []
    try:
        for name, fn, nb in variants:
            chol_mod._potrf_inv = fn
            dt, roof = bench.bracketed(
                lambda: _dm(_spd(bench, n), grid),
                lambda a, _nb=nb: el.cholesky(a, nb=_nb).local)
            rows.append(report(name, (n ** 3 / 3) / dt / 1e12, roof))
    finally:
        chol_mod._potrf_inv = orig
    return rows


def run_lu(bench, n=None) -> list:
    """Single-grid LU schedules: classic vs look-ahead at equal nb, the nb
    and ``inners`` sweep, the reduced-precision update (not ported: the
    row says so) and the ``panel_impl='kernel'`` twin of the headline."""
    import elemental_tpu_torch as el
    n = int(n) if n else (16384 if bench.on_card else 512)
    grid = el.Grid(device=bench.device)
    nb0 = 2048 if bench.on_card else 128
    # (name, lookahead, inners, nb, update_precision, panel_impl)
    cases = [
        (f"classic        inners=(512,64) nb={nb0}", False, (512, 64), nb0,
         None, None),
        (f"look-ahead     inners=(512,64) nb={nb0}", True, (512, 64), nb0,
         None, None),
        (f"look-ahead     inners=(512,64) nb={nb0 // 2}", True, (512, 64),
         nb0 // 2, None, None),
        (f"look-ahead     inners=(512,64) nb={nb0 * 2}", True, (512, 64),
         nb0 * 2, None, None),
        (f"look-ahead     inners=(768,96) nb={nb0}", True, (768, 96), nb0,
         None, None),
        (f"look-ahead     inners=(1024,128) nb={nb0}", True, (1024, 128),
         nb0, None, None),
        (f"look-ahead     inners=(512,128,32) nb={nb0}", True,
         (512, 128, 32), nb0, None, None),
        (f"look-ahead+bf16upd inners=(512,64) nb={nb0}", True, (512, 64),
         nb0, "bfloat16", None),
        (f"look-ahead     inners=(512,64) nb={nb0} panel=kernel", True,
         (512, 64), nb0, None, "kernel"),
    ]
    rows = []
    for name, la, inners, nb, upd, impl in cases:
        def step(a, _nb=nb, _la=la, _in=inners, _u=upd, _pi=impl):
            LU, perm = el.lu(a, nb=_nb, update_precision=_u, lookahead=_la,
                             crossover=0, inners=_in, panel_impl=_pi)
            return LU.local, perm

        try:
            dt, roof = bench.bracketed(
                lambda: _dm(_normal(bench, (n, n), 1), grid), step)
        except REFUSED as e:
            rows.append(skip(name, e))
            continue
        rows.append(report(name, (2 * n ** 3 / 3) / dt / 1e12, roof))
    return rows


def run_lu_dist(bench, n=None, grid_spec=None, cps=("bf16", "int8")) -> list:
    """Distributed LU on the ``--grid`` virtual grid: classic panel vs
    the CALU tournament, each under classic and look-ahead x tail
    crossover, with comm_precision wire twins of the headline rows.  On a
    1x1 grid only the two schedule rows run, as on one JAX device."""
    import elemental_tpu_torch as el
    n = int(n) if n else (16384 if bench.on_card else 512)
    grid = _grid(grid_spec, bench.device)
    p = grid.size
    nb0 = 2048 if bench.on_card else 128
    # (name, lookahead, nb, crossover, panel, comm_precision)
    cases = [
        (f"classic        nb={nb0} xover=0", False, nb0, 0, "classic", None),
        (f"look-ahead     nb={nb0} xover=0", True, nb0, 0, "classic", None),
    ]
    if p > 1:
        for xo in (n // 8, n // 4, n // 2):
            cases.append((f"look-ahead     nb={nb0} xover={xo}",
                          True, nb0, xo, "classic", None))
        cases.append((f"classic        nb={nb0} xover={n // 4}",
                      False, nb0, n // 4, "classic", None))
        for cp in cps:
            cases.append((f"look-ahead     nb={nb0} xover=0 wire={cp}",
                          True, nb0, 0, "classic", cp))
    if grid.height > 1:
        cases.append((f"calu           nb={nb0} xover=0",
                      True, nb0, 0, "calu", None))
        cases.append((f"calu classic-sched nb={nb0} xover=0",
                      False, nb0, 0, "calu", None))
        for xo in (n // 8, n // 4):
            cases.append((f"calu look-ahead nb={nb0} xover={xo}",
                          True, nb0, xo, "calu", None))
        for cp in cps:
            cases.append((f"calu           nb={nb0} xover=0 wire={cp}",
                          True, nb0, 0, "calu", cp))
    print(f"grid {grid.height}x{grid.width}, n={n}", flush=True)
    rows = []
    for name, la, nb, xo, pan, cp in cases:
        dt, roof = bench.bracketed(
            lambda: _dm(_normal(bench, (n, n), 1), grid),
            lambda a, _nb=nb, _la=la, _xo=xo, _p=pan, _c=cp: el.lu(
                a, nb=_nb, lookahead=_la, crossover=_xo, panel=_p,
                comm_precision=_c)[0].local)
        rows.append(report(name, (2 * n ** 3 / 3) / dt / 1e12, roof))
    return rows


def run_cholesky(bench, n=None, grid_spec=None, cps=("bf16", "int8")) -> list:
    """Cholesky on the ``--grid`` virtual grid: classic vs look-ahead x nb
    x tail crossover, the ``panel_impl='kernel'`` twin, and wire twins of
    the headline row with the factor residual printed beside each."""
    import elemental_tpu_torch as el
    n = int(n) if n else (16384 if bench.on_card else 512)
    grid = _grid(grid_spec, bench.device)
    p = grid.size
    nb0 = 2048 if bench.on_card else 128
    # (name, lookahead, nb, crossover, comm_precision, panel_impl)
    cases = [
        (f"classic        nb={nb0} xover=0", False, nb0, 0, None, None),
        (f"look-ahead     nb={nb0} xover=0", True, nb0, 0, None, None),
        (f"look-ahead     nb={nb0 // 2} xover=0", True, nb0 // 2, 0, None,
         None),
        (f"look-ahead     nb={nb0 * 2} xover=0", True, nb0 * 2, 0, None,
         None),
        (f"look-ahead     nb={nb0} xover=0 panel=kernel", True, nb0, 0,
         None, "kernel"),
    ]
    if p > 1:
        for xo in (n // 8, n // 4, n // 2):
            cases.append((f"look-ahead     nb={nb0} xover={xo}", True, nb0,
                          xo, None, None))
        cases.append((f"classic        nb={nb0} xover={n // 4}",
                      False, nb0, n // 4, None, None))
        for cp in cps:
            cases.append((f"look-ahead     nb={nb0} xover=0 wire={cp}",
                          True, nb0, 0, cp, None))
    print(f"grid {grid.height}x{grid.width}, n={n}", flush=True)
    rows = []
    for name, la, nb, xo, cp, impl in cases:
        def step(a, _nb=nb, _la=la, _xo=xo, _c=cp, _pi=impl):
            return el.cholesky(a, nb=_nb, lookahead=_la, crossover=_xo,
                               comm_precision=_c, panel_impl=_pi)

        dt, roof = bench.bracketed(lambda: _dm(_spd(bench, n), grid),
                                   lambda a: step(a).local)
        extra = ""
        if cp is not None:
            # the accuracy cost of the narrow wire, beside its rate
            a = _spd(bench, n)
            lg = el.to_global(step(_dm(a, grid)))
            v = _normal(bench, (n, 1), 2)
            r = a @ v - lg @ (lg.T @ v)
            extra = (f"   resid "
                     f"{float(r.norm() / (a.norm() * v.norm())):.2e}")
            del a, lg, v, r
        rows.append(report(name, (n ** 3 / 3) / dt / 1e12, roof, extra))
    return rows


def run_gemm(bench, n=None, grid_spec=None, cps=("bf16", "int8")) -> list:
    """The gemm alg family x shape class on the ``--grid`` virtual grid:
    ``square``, ``tall-skinny`` (m >> n) and ``outer-product`` (k small);
    ``auto`` shows what the tuner picks, the slice rows get wire twins.
    A schedule that cannot run a shape prints ``skip``."""
    import elemental_tpu_torch as el
    n = int(n) if n else (8192 if bench.on_card else 256)
    grid = _grid(grid_spec, bench.device)
    shapes = [("square", (n, n, n)),
              ("tall-skinny", (16 * n, n, max(n // 4, 1))),
              ("outer-product", (n, max(n // 16, 1), n))]
    algs = ["C", "A", "B", "dot", "gspmd", "slice", "auto"]
    print(f"grid {grid.height}x{grid.width}", flush=True)
    rows = []
    for cls, (m, k, nn) in shapes:
        print(f"-- {cls}: m={m} k={k} n={nn}", flush=True)

        def make(_m=m, _k=k, _n=nn):
            return (_dm(_normal(bench, (_m, _k), 2), grid),
                    _dm(_normal(bench, (_k, _n), 3), grid))

        for alg, cp in [(a, None) for a in algs] + [("slice", c) for c in cps]:
            name = f"{cls:13s} alg={alg}" + (f" wire={cp}" if cp else "")
            try:
                dt, roof = bench.bracketed(
                    make, lambda ab, _a=alg, _c=cp: el.gemm(
                        ab[0], ab[1], alg=_a, comm_precision=_c).local)
            except REFUSED as e:
                rows.append(skip(name, e))
                continue
            rows.append(report(name, 2 * m * k * nn / dt / 1e12, roof))
    return rows


def _panel_fns(prim, nb):
    """(plain, kernel, library) callables of one panel primitive."""
    from elemental_tpu_torch import kernels
    inner = kernels.default_inners()[-1]
    if prim == "lu":
        return (lambda p: kernels.lu_panel_reference(p, nb, inner),
                lambda p: kernels.lu_panel(p, nb, inner=inner),
                torch.linalg.lu_factor)
    if prim == "chol":
        def library(d):
            L = torch.linalg.cholesky(d)
            eye = torch.eye(nb, dtype=d.dtype, device=d.device)
            return L, torch.linalg.solve_triangular(L, eye, upper=False)
        return kernels.potrf_inv_reference, kernels.potrf_inv, library
    return kernels.qr_panel_reference, kernels.qr_panel, torch.geqrf


def panel_input(bench, prim, m, nb, dtype):
    """The seeded input of one panel row: an (m, nb) normal panel for
    ``lu`` and ``qr``, G G^T / nb + nb I of order nb for ``chol``."""
    if prim == "chol":
        return _spd(bench, nb, dtype, seed=nb)
    return _normal(bench, (m, nb), nb, dtype)


def run_panel(bench, m=None, nbs=None, dtypes=None, prims=PANEL_PRIMS) -> list:
    """The panel primitives at panel height ``m`` across ``nbs`` x
    ``dtypes``: for each, the plain version (the function the kernel is
    held against), the CUDA kernel and the library call, each bracketed
    by the roofline.  Rows carry ``prim``, ``nb``, ``m``, ``dtype``,
    ``impl`` and ``seconds`` besides the printed numbers."""
    from elemental_tpu_torch import kernels
    m = int(m) if m else (16384 if bench.on_card else 1024)
    nbs = [nb for nb in (nbs or PANEL_NBS) if nb <= m]
    dtypes = dtypes or (torch.float32, torch.float64)
    print(f"panel height m={m}, lu chunk {kernels.default_inners()[-1]}",
          flush=True)
    rows = []
    for dt in dtypes:
        dname = str(dt).replace("torch.", "")
        for nb in nbs:
            for prim in prims:
                x = panel_input(bench, prim, m, nb, dt)
                flops = {"lu": m * nb * nb - nb ** 3 / 3, "chol": nb ** 3,
                         "qr": 2 * nb * nb * (m - nb / 3)}[prim]
                for impl, fn in zip(("plain", "kernel", "library"),
                                    _panel_fns(prim, nb)):
                    name = f"{prim:5s} nb={nb:<5d} {dname:8s} {impl}"
                    if impl == "kernel" and not bench.on_card:
                        print(f"{name:44s} skip (cpu: plain route)",
                              flush=True)
                        continue
                    secs, roof = bench.bracketed(lambda: x, fn)
                    row = report(name, flops / secs / 1e12, roof,
                                 f"   flops {PANEL_FLOPS[prim]}")
                    row.update(prim=prim, nb=nb, m=m, dtype=dname,
                               impl=impl, seconds=secs)
                    rows.append(row)
                del x
    return rows


def run_phases(bench, *args) -> dict:
    """Per-step phase wall clock through the real driver on the 1x1 grid
    (the ``PhaseTimer`` syncs at each boundary) -> one
    ``phase_timings/v1`` JSON line, returned as a dict.  ``phases
    [lu|cholesky] [N NB]`` (the driver defaults to lu)."""
    import elemental_tpu_torch as el
    from elemental_tpu_torch import kernels
    from elemental_tpu_torch.perf.phase_timer import PhaseTimer
    args = list(args)
    driver = "lu"
    if args and not str(args[0]).isdigit():
        driver = args.pop(0)
    n = int(args[0]) if args else (16384 if bench.on_card else 512)
    nb = int(args[1]) if len(args) > 1 else (2048 if bench.on_card else 128)
    grid = el.Grid(device=bench.device)
    t = PhaseTimer()
    if driver == "cholesky":
        chol_mod = importlib.import_module(
            "elemental_tpu_torch.lapack.cholesky")
        A = _dm(_spd(bench, n), grid)
        bench.sync()
        L = el.cholesky(A, nb=nb, lookahead=True, timer=t)
        bench.sync()
        del L
        meta = dict(driver="cholesky", flops=n ** 3 / 3,
                    crossover=chol_mod._CROSSOVER)
    else:
        A = _dm(_normal(bench, (n, n), 1), grid)
        bench.sync()
        LU, perm = el.lu(A, nb=nb, lookahead=True, timer=t)
        bench.sync()
        del LU, perm
        meta = dict(driver="lu", flops=2 * n ** 3 / 3,
                    inners=list(kernels.default_inners()))
    r = bench.roofline()
    doc = t.report(n=n, nb=nb, lookahead=True, roofline_tflops=round(r, 2),
                   device=bench.name, **meta)
    print(json.dumps(doc), flush=True)
    return doc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    opts = {"--comm-precision": "bf16,int8", "--grid": "1x1",
            "--device": "cuda"}
    for flag in opts:
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1] if i + 1 < len(argv) else "none"
            del argv[i: i + 2]
    cps = tuple(c for c in opts["--comm-precision"].split(",")
                if c and c != "none")
    if torch.device(opts["--device"]).type == "cuda" \
            and not torch.cuda.is_available():
        print("ab_harness: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    mode = argv[0] if argv else "chol"
    modes = ("chol", "lu", "lu-dist", "cholesky", "gemm", "panel", "phases")
    if mode not in modes:
        print(__doc__)
        raise SystemExit(f"unknown mode {mode!r}; want one of {modes}")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # full-f32 drivers
    try:
        bench = Bench(opts["--device"])
        if mode != "phases":
            print(f"device {bench.name}, rt latency "
                  f"{bench.latency_s * 1e3:.2f} ms", flush=True)
        rest, grid = argv[1:], opts["--grid"]
        if mode == "chol":
            run_chol(bench, *rest[:1])
        elif mode == "lu":
            run_lu(bench, *rest[:1])
        elif mode == "lu-dist":
            run_lu_dist(bench, *rest[:1], grid_spec=grid, cps=cps)
        elif mode == "cholesky":
            run_cholesky(bench, *rest[:1], grid_spec=grid, cps=cps)
        elif mode == "gemm":
            run_gemm(bench, *rest[:1], grid_spec=grid, cps=cps)
        elif mode == "panel":
            run_panel(bench, *rest[:1])
        else:
            run_phases(bench, *rest[:3])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
