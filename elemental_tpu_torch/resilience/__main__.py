"""Resilience command line: checksum-guarded factorizations and certified
solves, optionally under seeded fault injection.

The twin of the JAX package's ``perf/abft.py`` and ``perf/certify.py``,
with the same commands, arguments and output:

    python -m elemental_tpu_torch.resilience abft run lu 256 --grid 2x2
                                            # lu(..., abft=guard): one
                                            #   abft_report/v1 line on
                                            #   stdout, summary rows
                                            #   # -prefixed
    python -m elemental_tpu_torch.resilience abft run qr \\
        --fault compute:bitflip --window 1:2
                                            # corrupt the panel factor at
                                            #   step 1: detection and one
                                            #   panel re-execution
    python -m elemental_tpu_torch.resilience abft smoke
                                            # clean guarded runs on 1x1
                                            #   and 2x2 for lu, hpd, qr,
                                            #   and one injected fault per
                                            #   op recovered at panel
                                            #   granularity; exit 1 on any
                                            #   violation
    python -m elemental_tpu_torch.resilience certify run lu 256 --grid 2x2
                                            # certified_solve('lu', ...):
                                            #   one solve_certificate/v1
                                            #   line on stdout
    python -m elemental_tpu_torch.resilience certify run lu \\
        --fault redistribute:nan:2 --seed 7 # watch the ladder escalate
    python -m elemental_tpu_torch.resilience certify smoke
                                            # clean certification on 1x1
                                            #   and 2x2 for lu and hpd, a
                                            #   repaired one-shot fault and
                                            #   a surfaced persistent one

``--fault`` is ``target:kind[:call[:every]]`` (``resilience.faults``);
abft's ``--window start:stop`` scopes the last ``--fault`` to those panel
steps.  Flags of ``abft run``: ``--n N`` (or positional; default 128),
``--nb NB`` (default 32), ``--grid RxC`` (default 2x2), ``--dtype NAME``,
``--comm-precision P``, ``--seed S``, ``--fault SPEC`` (repeatable),
``--window A:B``, ``--retries K``, ``--json``.  Flags of ``certify
run``: ``--n N`` (or positional; default 128), ``--nb NB``, ``--grid
RxC``, ``--dtype NAME``, ``--tol X``, ``--seed S``, ``--fault SPEC``
(repeatable), ``--health`` / ``--no-health``, ``--json``.

Everything runs on ``cuda:0`` unless ``--device cpu``; without a card the
command exits 2 (there is no fallback to the CPU).
"""
import dataclasses
import json
import sys
import time


def _grid(spec, device):
    from elemental_tpu_torch.core.grid import Grid
    r, c = (int(x) for x in (spec or "2x2").split("x"))
    return Grid(r, c, device=device)


def _parse_fault(spec: str):
    from elemental_tpu_torch.resilience import FaultSpec
    parts = spec.split(":")
    if len(parts) < 2:
        raise SystemExit(f"--fault needs target:kind[:call[:every]], "
                         f"got {spec!r}")
    call = int(parts[2]) if len(parts) > 2 else 0
    every = len(parts) > 3 and parts[3] == "every"
    return FaultSpec(target=parts[0], kind=parts[1], call=call, every=every)


def _matrix(op, n, dtype):
    import numpy as np
    rng = np.random.default_rng(0)
    F = rng.normal(size=(n, n)).astype(dtype)
    M = (F @ F.T / n + n * np.eye(n)).astype(dtype) if op == "hpd" \
        else (F + n * np.eye(n, dtype=dtype))
    return rng, M


# ---------------------------------------------------------------------
# abft
# ---------------------------------------------------------------------

def _abft_residual(op, M, out):
    import numpy as np
    import elemental_tpu_torch as et
    n = M.shape[0]
    if op == "lu":
        LU, perm = out
        g = et.to_global(LU).cpu().numpy()
        L = np.tril(g, -1) + np.eye(n, dtype=g.dtype)
        return float(np.linalg.norm(M[perm.cpu().numpy()] - L @ np.triu(g))
                     / np.linalg.norm(M))
    if op == "qr":
        Ap, tau = out
        Q = et.to_global(et.explicit_q(Ap, tau)).cpu().numpy()
        R = np.triu(et.to_global(Ap).cpu().numpy())
        return float(np.linalg.norm(M - Q @ R) / np.linalg.norm(M))
    Lg = et.to_global(out).cpu().numpy()
    return float(np.linalg.norm(M - Lg @ Lg.conj().T) / np.linalg.norm(M))


def _abft_one(op, n, nb, grid, dtype, faults, seed, retries,
              comm_precision=None):
    """One guarded factorization: (report, residual, plan, seconds)."""
    import torch
    import elemental_tpu_torch as et
    from elemental_tpu_torch.resilience import (AbftGuard, FaultPlan,
                                                fault_injection)
    _, M = _matrix(op, n, dtype)
    A = et.from_global(torch.from_numpy(M), et.MC, et.MR, grid)
    guard = AbftGuard(max_retries=retries)
    drv = {"lu": et.lu, "qr": et.qr, "hpd": et.cholesky}[op]
    t0 = time.perf_counter()
    plan = FaultPlan(seed=seed, faults=faults) if faults else None
    if plan is not None:
        with fault_injection(plan):
            out = drv(A, nb=nb, abft=guard, comm_precision=comm_precision)
    else:
        out = drv(A, nb=nb, abft=guard, comm_precision=comm_precision)
    if grid.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return guard.report(), _abft_residual(op, M, out), plan, secs


def abft_run(op, n, nb, grid, dtype, faults, seed, retries, comm_precision,
             as_json) -> int:
    rep, res, plan, secs = _abft_one(op, n, nb, grid, dtype, faults, seed,
                                     retries, comm_precision)
    if not as_json:
        print(f"# abft {op} n={n} nb={nb} "
              f"grid={grid.height}x{grid.width} "
              f"quantized_wire={rep['quantized_wire']} "
              f"wall={secs:.3f}s")
        print(f"#   panels={rep['panels']} checks={rep['checks']} "
              f"violations={len(rep['violations'])} "
              f"recompute_count={rep['recompute_count']} "
              f"recovered={rep['recovered_panels']} "
              f"unrecovered={rep['unrecovered_panels']}")
        for v in rep["violations"]:
            print(f"#   step={v['step']} attempt={v['attempt']} "
                  f"phase={v['phase']} kind={v['kind']} "
                  f"nonfinite={v['nonfinite']} columns={v['columns']}")
        if plan is not None:
            print(f"# faults fired: {plan.fired()} "
                  f"({json.dumps(plan.summary())})")
        print(f"# residual={res:.3e} -> "
              f"{'OK' if rep['ok'] else 'UNRECOVERED'}")
    print(json.dumps(rep))
    return 0 if rep["ok"] else 1


def abft_smoke(device) -> int:
    """Clean guarded runs on 1x1 and 2x2 for the three ops (no violation,
    no recompute) and one windowed fault per op on 2x2, detected at the
    injected panel and repaired by exactly one panel re-execution."""
    from elemental_tpu_torch.resilience import FaultSpec
    rc = 0
    n, nb = 32, 8
    for spec in ("1x1", "2x2"):
        grid = _grid(spec, device)
        for op in ("lu", "hpd", "qr"):
            rep, res, _, secs = _abft_one(op, n, nb, grid, "float32", (),
                                          0, 2)
            clean = (rep["ok"] and not rep["violations"]
                     and rep["recompute_count"] == 0 and res < 1e-4)
            print(f"# smoke {op} {spec}: checks={rep['checks']} "
                  f"violations={len(rep['violations'])} "
                  f"residual={res:.2e} wall={secs:.3f}s "
                  f"{'ok' if clean else 'FAILED'}")
            rc |= not clean
    grid = _grid("2x2", device)
    for op, target, kind in (("lu", "redistribute", "scale"),
                             ("hpd", "compute", "scale"),
                             ("qr", "compute", "bitflip")):
        fault = FaultSpec(target, kind, nelem=2, window=(1, 2))
        rep, res, plan, _ = _abft_one(op, n, nb, grid, "float32", (fault,),
                                      7, 2)
        steps = sorted({v["step"] for v in rep["violations"]})
        good = (plan.fired() >= 1 and steps == [1]
                and rep["recompute_count"] == 1
                and rep["recovered_panels"] == [1]
                and rep["ok"] and res < 1e-4)
        print(f"# smoke fault({op} {target} {kind}@panel1): "
              f"fired={plan.fired()} viol_steps={steps} "
              f"recompute={rep['recompute_count']} "
              f"recovered={rep['recovered_panels']} residual={res:.2e} "
              f"{'ok' if good else 'FAILED'}")
        rc |= not good
    print("# abft smoke:", "ok" if rc == 0 else "FAILED")
    return int(rc)


# ---------------------------------------------------------------------
# certify
# ---------------------------------------------------------------------

def _certify_one(op, n, nb, grid, dtype, tol, faults, seed, health):
    """One certified solve: (certificate, plan or None)."""
    import torch
    import elemental_tpu_torch as et
    from elemental_tpu_torch.resilience import (FaultPlan, certified_solve,
                                                fault_injection)
    rng, M = _matrix(op, n, dtype)
    B = rng.normal(size=(n, max(1, min(4, n)))).astype(dtype)
    A = et.from_global(torch.from_numpy(M), et.MC, et.MR, grid)
    Bd = et.from_global(torch.from_numpy(B), et.MC, et.MR, grid)
    if faults:
        plan = FaultPlan(seed=seed, faults=faults)
        with fault_injection(plan):
            _, info = certified_solve(op, A, Bd, tol=tol, nb=nb,
                                      health=health)
        return info, plan
    _, info = certified_solve(op, A, Bd, tol=tol, nb=nb, health=health)
    return info, None


def certify_run(op, n, nb, grid, dtype, tol, faults, seed, health,
                as_json) -> int:
    info, plan = _certify_one(op, n, nb, grid, dtype, tol, faults, seed,
                              health)
    if not as_json:
        print(f"# certify {op} n={n} grid={grid.height}x{grid.width} "
              f"tol={info['tol']:.3e}")
        for att in info["attempts"]:
            res = att["residual"]
            print(f"#   rung={att['rung']:8s} residual="
                  f"{'nan' if res is None else format(res, '.3e')} "
                  f"refine={att['refine_iters']} "
                  f"singular={att['singular']}")
        if plan is not None:
            print(f"# faults fired: {plan.fired()} "
                  f"({json.dumps(plan.summary())})")
        verdict = (f"CERTIFIED at rung {info['rung']!r}" if info["certified"]
                   else f"NOT certified (failing phase: "
                        f"{info['failing_phase']})")
        print(f"# {verdict}")
    print(json.dumps(info))
    return 0 if info["certified"] or info["failing_phase"] is not None else 1


def certify_smoke(device) -> int:
    """Clean certification on 1x1 and 2x2 for lu and hpd; a one-shot NaN
    repaired by escalation; a persistent NaN surfaced, never certified."""
    from elemental_tpu_torch.resilience import FaultSpec
    rc = 0
    n, nb = 32, 8
    for spec in ("1x1", "2x2"):
        grid = _grid(spec, device)
        for op in ("lu", "hpd"):
            info, _ = _certify_one(op, n, nb, grid, "float32", None, (), 0,
                                   True)
            print(f"# smoke {op} {spec}: certified={info['certified']} "
                  f"rung={info['rung']} residual={info['residual']}")
            rc |= not info["certified"]
    grid = _grid("2x2", device)
    info, plan = _certify_one("hpd", n, nb, grid, "float32", None,
                              (FaultSpec("panel_spread", "nan", call=0),),
                              0, True)
    print(f"# smoke fault(one-shot nan): certified={info['certified']} "
          f"rung={info['rung']} fired={plan.fired()}")
    rc |= not (plan.fired() and info["certified"])
    info, plan = _certify_one("lu", n, nb, grid, "float32", None,
                              (FaultSpec("redistribute", "nan", call=1,
                                         every=True),), 0, True)
    surfaced = (not info["certified"]) and info["failing_phase"] is not None
    print(f"# smoke fault(persistent nan): surfaced={surfaced} "
          f"failing_phase={info['failing_phase']} fired={plan.fired()}")
    rc |= not (plan.fired() and surfaced)
    print("# certify smoke:", "ok" if rc == 0 else "FAILED")
    return int(rc)


# ---------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------

def _parse_run(tool: str, argv: list) -> dict:
    """The ``run`` flags of ``tool`` ('abft' or 'certify'), as the JAX
    CLIs parse them."""
    opts = {"pos": [], "n": None, "nb": None, "grid": None,
            "dtype": "float32", "seed": 0, "retries": 2, "tol": None,
            "comm_precision": None, "faults": [], "window": None,
            "health": True, "json": False, "device": "cuda"}
    it = iter(argv)
    for arg in it:
        key = arg[2:].replace("-", "_")
        if arg in ("--n", "--nb", "--seed", "--retries"):
            opts[key] = int(next(it))
        elif arg == "--tol" and tool == "certify":
            opts["tol"] = float(next(it))
        elif arg in ("--grid", "--dtype", "--device") or (
                arg == "--comm-precision" and tool == "abft"):
            opts[key] = next(it)
        elif arg == "--fault":
            opts["faults"].append(next(it))
        elif arg == "--window" and tool == "abft":
            opts["window"] = tuple(int(x) for x in next(it).split(":"))
        elif arg in ("--health", "--no-health") and tool == "certify":
            opts["health"] = arg == "--health"
        elif arg == "--json":
            opts["json"] = True
        elif arg.startswith("--"):
            raise SystemExit(f"unknown flag {arg!r}")
        else:
            opts["pos"].append(arg)
    return opts


def _device_ok(device) -> bool:
    import torch
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        print("resilience: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return False
    return True


def _run(tool: str, argv: list) -> int:
    o = _parse_run(tool, argv)
    ops = ("lu", "hpd", "qr") if tool == "abft" else ("lu", "hpd")
    if not o["pos"]:
        raise SystemExit(f"run needs an op ({'/'.join(ops)})")
    op = o["pos"].pop(0)
    op = "hpd" if op == "cholesky" else op
    if op not in ops:
        raise SystemExit(f"unknown op {op!r}; expected {', '.join(ops)}")
    n = o["n"]
    if o["pos"] and n is None:
        n = int(o["pos"].pop(0))
    n = 128 if n is None else n
    if not _device_ok(o["device"]):
        return 2
    fspecs = [_parse_fault(s) for s in o["faults"]]
    grid = _grid(o["grid"], o["device"])
    if tool == "certify":
        return certify_run(op, n, o["nb"], grid, o["dtype"], o["tol"],
                           tuple(fspecs), o["seed"], o["health"], o["json"])
    if o["window"] is not None:
        if not fspecs:
            raise SystemExit("--window needs a preceding --fault")
        fspecs[-1] = dataclasses.replace(fspecs[-1], window=o["window"])
    nb = 32 if o["nb"] is None else o["nb"]
    return abft_run(op, n, nb, grid, o["dtype"], tuple(fspecs), o["seed"],
                    o["retries"], o["comm_precision"], o["json"])


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    tool, cmd = argv.pop(0), argv.pop(0)
    if tool not in ("abft", "certify") or cmd not in ("run", "smoke"):
        print(__doc__)
        raise SystemExit(f"unknown command {tool!r} {cmd!r}")
    import torch
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # full-f32 solves
    try:
        if cmd == "run":
            return _run(tool, argv)
        device = "cuda"
        it = iter(argv)
        for arg in it:
            if arg == "--device":
                device = next(it)
            else:
                raise SystemExit(f"unknown flag {arg!r}")
        if not _device_ok(device):
            return 2
        return abft_smoke(device) if tool == "abft" else certify_smoke(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


if __name__ == "__main__":
    raise SystemExit(main())
