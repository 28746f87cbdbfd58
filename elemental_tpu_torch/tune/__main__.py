"""Autotuning command line: explain / search / show / clear.

The twin of the JAX package's ``perf/tune.py``, with the same flags:

    python -m elemental_tpu_torch.tune explain cholesky      # cost-model
                                                             #   breakdown
    python -m elemental_tpu_torch.tune explain gemm --n 8192 --grid 2x2
    python -m elemental_tpu_torch.tune search cholesky --n 4096
                                                             # MEASURE the
                                                             #   top configs
                                                             #   on the card
    python -m elemental_tpu_torch.tune show [op]             # cache contents
    python -m elemental_tpu_torch.tune clear [op]            # drop entries

``explain`` and the cache commands touch no card: ``explain`` scores on
a CPU grid (default 2x2; ``--device cuda`` scores the card's context,
backend 'gpu', still without touching a card) and doubles as the cost
model's self-check -- it exits non-zero if any candidate scores
non-finite or non-positive, or if the pipelined cholesky/lu schedules
rank below classic at the golden comm-plan geometry (n=64, nb=16).  ``search`` runs on the card (default
1x1 grid; ``--device cpu`` measures on the CPU instead) and persists a
``tuning_cache/v1`` winner that every later ``'auto'`` resolution on the
same key picks up first.

Flags: ``--n N`` (square problem size; search default 4096 on the card /
256 on the CPU, explain default 2048), ``--grid RxC``, ``--dtype NAME``,
``--machine {gpu,cpu}`` (cost-model constants override), ``--top K``
(search: how many cost-ranked candidates to measure), ``--reps R``,
``--dry-run`` (search without writing the cache), ``--device
{cuda,cpu}``.
"""
import math
import sys


def _grid(spec, device, default):
    from elemental_tpu_torch.core.grid import Grid
    r, c = (int(x) for x in (spec or default).split("x"))
    return Grid(r, c, device=device)


def _dims(op: str, n: int):
    return (n, n, n) if op == "gemm" else (n, n)


def _fmt_cfg(cfg: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in sorted(cfg.items()))


def cmd_explain(op, n, grid_spec, dtype_name, machine_name, device) -> int:
    from elemental_tpu_torch import tune
    from elemental_tpu_torch.tune import cost_model as _cm
    grid = _grid(grid_spec, device or "cpu", "2x2")
    machine = _cm.MACHINES.get(machine_name) if machine_name else None
    dims = _dims(op, n)
    ctx, scored = tune.explain(op, gshape=dims, dtype=dtype_name, grid=grid,
                               machine=machine)
    mname = machine.name if machine else ctx.backend
    print(f"# {op} dims={tuple(dims)} dtype={ctx.dtype} "
          f"grid={ctx.grid_shape[0]}x{ctx.grid_shape[1]} "
          f"machine-model={mname}  ({len(scored)} candidates, best first)")
    print(f"{'config':42s} {'total':>10s} {'compute':>10s} {'latency':>10s} "
          f"{'bandwidth':>10s} {'rounds':>7s} {'bytes':>12s}")
    bad = 0
    for b in scored:
        t = b.total_s
        if not math.isfinite(t) or t <= 0:
            bad += 1
        print(f"{_fmt_cfg(b.config):42s} {t:10.3e} {b.compute_s:10.3e} "
              f"{b.latency_s:10.3e} {b.bandwidth_s:10.3e} {b.rounds:7.0f} "
              f"{b.comm_bytes:12.0f}")
    best = scored[0]
    print(f"chosen: {_fmt_cfg(best.config)}  "
          f"(cost model; a measured cache entry would take precedence)")
    if bad:
        print(f"SELF-CHECK FAILED: {bad} candidate(s) scored non-finite or "
              "non-positive", file=sys.stderr)
        return 1
    # pipelined-schedule invariant at the golden comm-plan geometry
    # (n=64, nb=16, tail crossover=32): lookahead+crossover must rank at
    # or above classic
    if op in ("cholesky", "lu"):
        gctx = tune.TuneContext(op, (64, 64), "float32", ctx.grid_shape,
                                ctx.backend)

        def _score(la, xo):
            return _cm.score_config(
                op, {"nb": 16, "lookahead": la, "crossover": xo},
                ctx=gctx, machine=machine)

        cl, xo = _score(False, 0), _score(True, 32)
        tag = (f"golden-geometry invariant (n=64 nb=16): "
               f"lookahead+crossover {xo.total_s:.3e} "
               f"({xo.prim_counts.get('all_gather', 0)} all_gathers) vs "
               f"classic {cl.total_s:.3e} "
               f"({cl.prim_counts.get('all_gather', 0)} all_gathers)")
        if xo.total_s > cl.total_s * (1 + 1e-9):
            print(f"SELF-CHECK FAILED: {tag}", file=sys.stderr)
            return 1
        print(f"self-check ok: {tag}")
    return 0


def cmd_search(op, n, grid_spec, dtype_name, top, reps, dry_run,
               device) -> int:
    from elemental_tpu_torch.tune import measure
    device = device or "cuda"
    grid = _grid(grid_spec, device, "1x1")
    if n is None:
        n = 4096 if grid.device.type == "cuda" else 256
    dims = _dims(op, n)
    winner, measured, key = measure.search(
        op, dims, grid, dtype_name, top=top, reps=reps,
        write_cache=not dry_run, verbose=True)
    print(f"winner: {_fmt_cfg(winner.config)}  {winner.seconds * 1e3:.2f} ms "
          f"{winner.tflops:.3f} TFLOP/s")
    if dry_run:
        print("dry run: cache not written")
    else:
        print(f"recorded: {key.path()}")
    return 0


def cmd_show(op) -> int:
    from elemental_tpu_torch import tune
    from elemental_tpu_torch.obs import metrics as obs_metrics
    docs, rejects = tune.cache_scan()
    if op:
        docs = [d for d in docs if d.get("op") == op]
        rejects = [r for r in rejects if r["file"].startswith(f"{op}__")]
    print(f"# cache dir: {tune.cache_dir()}  ({len(docs)} entries, "
          f"{len(rejects)} invalid)")
    for d in docs:
        metric = d.get("metric", {})
        extra = f"  {metric.get('tflops', 0):.3f} TFLOP/s" if metric else ""
        print(f"{d['_file']:64s} {_fmt_cfg(d['config'])} "
              f"[{d.get('source', '?')}]{extra}")
    for r in rejects:
        print(f"INVALID {r['file']:56s} ({r['reason']}; ignored by the "
              "resolver)")
    events = obs_metrics.current().counters("tune_cache_events")
    if events:
        tally: dict = {}
        for (_, labels), v in events.items():
            ev = dict(labels).get("event", "?")
            tally[ev] = tally.get(ev, 0) + v
        row = "  ".join(f"{k}={int(v)}" for k, v in sorted(tally.items()))
        print(f"# tune_cache_events (this process): {row}")
    return 0


def cmd_clear(op) -> int:
    from elemental_tpu_torch import tune
    n = tune.clear_cache(op)
    print(f"removed {n} entr{'y' if n == 1 else 'ies'} from "
          f"{tune.cache_dir()}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd not in ("search", "show", "clear", "explain"):
        print(__doc__)
        raise SystemExit(f"unknown command {cmd!r}")
    op = n = grid_spec = machine_name = device = None
    top, reps, dry_run = 8, 3, False
    dtype_name = "float32"
    it = iter(argv)
    for arg in it:
        if arg == "--n":
            n = int(next(it))
        elif arg == "--grid":
            grid_spec = next(it)
        elif arg == "--dtype":
            dtype_name = next(it)
        elif arg == "--machine":
            machine_name = next(it)
        elif arg == "--top":
            top = int(next(it))
        elif arg == "--reps":
            reps = int(next(it))
        elif arg == "--dry-run":
            dry_run = True
        elif arg == "--device":
            device = next(it)
        elif arg.startswith("--"):
            raise SystemExit(f"unknown flag {arg!r}")
        else:
            op = arg
    if cmd in ("search", "explain") and op is None:
        raise SystemExit(f"{cmd} needs an op "
                         "(cholesky/lu/qr/gemm/trsm/herk)")
    if cmd == "explain":
        return cmd_explain(op, n if n is not None else 2048, grid_spec,
                           dtype_name, machine_name, device)
    if cmd == "search":
        return cmd_search(op, n, grid_spec, dtype_name, top, reps, dry_run,
                          device)
    if cmd == "show":
        return cmd_show(op)
    return cmd_clear(op)


if __name__ == "__main__":
    try:
        import signal
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)   # `| head` etc.
    except (ImportError, AttributeError, ValueError):
        pass
    raise SystemExit(main())
