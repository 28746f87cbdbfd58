"""Runtime tracing command line: one driver run -> Perfetto trace +
``obs_metrics/v1`` document.

The twin of the JAX package's ``perf/trace.py``, with the same flags:

    python -m elemental_tpu_torch.obs run cholesky 4096 --out trace.json
                                            # trace one driver: nested
                                            #   driver/step/phase spans +
                                            #   collective instants ->
                                            #   Chrome-trace JSON (load it
                                            #   at https://ui.perfetto.dev)
                                            #   + one obs_metrics/v1 line
    python -m elemental_tpu_torch.obs run lu --n 256 --nb 64 --grid 2x2 \\
        --device cpu
    python -m elemental_tpu_torch.obs summary trace.json
                                            # per-lane totals of a trace
    python -m elemental_tpu_torch.obs export phases.json --out trace.json
                                            # convert a phase_timings/v1
                                            #   doc to the same format
    python -m elemental_tpu_torch.obs serve --out trace.json
                                            # drive a small 2-grid fleet
                                            #   workload: the trace
                                            #   carries one track per grid
                                            #   worker plus flow arrows
                                            #   linking each request
                                            #   submit -> worker -> done;
                                            #   also emits the
                                            #   serve_slo/v1 snapshot and
                                            #   a chaos-triggered
                                            #   flight_record/v1 dump

Flags for ``serve``: ``--requests N`` (default 12), ``--grids G``
(default 2), ``--out trace.json``, ``--slo-out slo.json``,
``--flight-out flight.json``, ``--device {cuda,cpu}``, ``--smoke``
(self-check mode: validate every timeline with ``check_timeline``,
require flow events + >= 2 grid-worker tracks in the export, a
non-trivial per-tenant SLO snapshot, and a BIT-IDENTICAL flight-record
replay of the grid-loss chaos cell under the virtual clock; exit 1 on
any failure).  The fleet's grids partition the virtual grid's eight
ranks on the chosen device.

Drivers: ``cholesky``, ``lu``, ``qr``, ``gemm``, ``trsm``, ``herk`` (the
six tuned drivers, which all tick through ``obs.phase_hook``).  ``run``
goes to ``cuda:0`` unless ``--device cpu``; every tick waits for the
card, so the phase times are synchronized wall-clock.

Flags for ``run``: ``--n N`` (or positional; default 2048 on the card /
64 on the CPU), ``--nb NB``, ``--grid RxC`` (default 1x1 on the card,
2x2 on the CPU), ``--dtype NAME``, ``--alg {A,B,C,dot,gspmd,slice,auto}``
(gemm), ``--classic`` (lookahead off), ``--crossover X``, ``--out
trace.json``, ``--metrics-out metrics.json``, ``--device {cuda,cpu}``.
The metrics document always prints to stdout as the final line; summary
rows are ``#``-prefixed above it.
"""
import json
import sys

DRIVERS = ("cholesky", "lu", "qr", "gemm", "trsm", "herk")


def _grid(spec, device):
    from elemental_tpu_torch.core.grid import Grid
    if spec is None:
        spec = "1x1" if device.startswith("cuda") else "2x2"
    r, c = (int(x) for x in spec.split("x"))
    return Grid(r, c, device=device)


def _device_name(grid) -> str:
    if grid.device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(grid.device)
    return "cpu"


def _run_driver(driver, grid, n, nb, lookahead, crossover, alg, dtype):
    """Build the inputs (outside the trace, from seed 0), run the driver
    once, and return its output tensors (synced by the caller's span)."""
    import numpy as np
    import elemental_tpu_torch as et
    from elemental_tpu_torch.obs.tracer import block_until_ready
    rng = np.random.default_rng(0)
    F = rng.normal(size=(n, n)).astype(dtype)
    kw = {}
    if driver in ("cholesky", "lu"):
        kw = {"lookahead": lookahead, "crossover": crossover}
    if driver in ("cholesky", "trsm", "herk"):
        S = (F @ F.T / n + n * np.eye(n)).astype(dtype)
        A = et.from_global(S, et.MC, et.MR, grid=grid)
    else:
        A = et.from_global(F + n * np.eye(n, dtype=dtype), et.MC, et.MR,
                           grid=grid)
    B = None
    if driver in ("gemm", "trsm"):
        B = et.from_global(rng.normal(size=(n, n)).astype(dtype),
                           et.MC, et.MR, grid=grid)
    block_until_ready((A, B))
    if driver == "cholesky":
        return et.cholesky(A, nb=nb, **kw).local
    if driver == "lu":
        LU, perm = et.lu(A, nb=nb, **kw)
        return (LU.local, perm)
    if driver == "qr":
        Ap, tau = et.qr(A, nb=nb)
        return (Ap.local, tau)
    if driver == "gemm":
        return et.gemm(A, B, alg=alg, nb=nb).local
    if driver == "trsm":
        return et.trsm("L", "L", "N", A, B, nb=nb).local
    return et.herk("L", A, nb=nb).local


def cmd_run(driver, n, nb, grid_spec, dtype_name, alg, lookahead, crossover,
            out, metrics_out, device="cuda") -> int:
    import torch
    from elemental_tpu_torch import obs
    grid = _grid(grid_spec, device)
    if n is None:
        n = 2048 if grid.device.type == "cuda" else 64
    meta = {"driver": driver, "n": n, "nb": nb,
            "grid": f"{grid.height}x{grid.width}", "dtype": dtype_name,
            "device": _device_name(grid)}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # full-f32 drivers
    try:
        with obs.metrics_scope() as reg:
            tracer = obs.Tracer()
            with tracer:
                with tracer.span("run", **meta):
                    leaves = _run_driver(driver, grid, n, nb, lookahead,
                                         crossover, alg, dtype_name)
                    obs.tracer.block_until_ready(leaves)
            trace_doc = obs.chrome_trace_doc(tracer, **meta)
            mdoc = reg.to_doc(**meta)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    if out:
        obs.write_json(out, trace_doc)
        print(f"# trace: {out}  ({len(trace_doc['traceEvents'])} events; "
              "load at https://ui.perfetto.dev)")
    for drv, totals in tracer.phase_totals().items():
        row = "  ".join(f"{p}={t * 1e3:.2f}ms" for p, t in totals.items())
        print(f"# phases[{drv}]: {row}")
    rc = tracer.redist_counts()
    print(f"# collectives: {sum(rc.values())} redistribute/panel_spread "
          f"entries, ~{tracer.redist_bytes_total()} ring-model bytes")
    if metrics_out:
        obs.write_json(metrics_out, mdoc)
        print(f"# metrics: {metrics_out}")
    print(json.dumps(mdoc))
    return 0


def cmd_summary(path) -> int:
    with open(path) as f:
        doc = json.load(f)
    if "traceEvents" not in doc:
        raise SystemExit(f"{path}: not a Chrome trace document")
    names = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    lanes: dict = {}
    ninstant = nbytes = 0
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X":
            lane = names.get(ev.get("tid"), str(ev.get("tid")))
            cur = lanes.setdefault(lane, [0, 0.0])
            cur[0] += 1
            cur[1] += ev.get("dur", 0.0)
        elif ev.get("ph") == "i":
            ninstant += 1
            nbytes += ev.get("args", {}).get("bytes", 0)
    other = doc.get("otherData", {})
    print(f"# {path}: schema={doc.get('schema')} "
          + " ".join(f"{k}={v}" for k, v in sorted(other.items())))
    print(f"{'lane':24s} {'spans':>6s} {'total_ms':>10s}")
    for lane, (cnt, dur) in sorted(lanes.items(), key=lambda kv: -kv[1][1]):
        print(f"{lane:24s} {cnt:6d} {dur / 1e3:10.3f}")
    if ninstant:
        print(f"{'collectives':24s} {ninstant:6d} {'~' + str(nbytes):>10s}B")
    return 0


def cmd_export(path, out) -> int:
    from elemental_tpu_torch import obs
    with open(path) as f:
        doc = json.load(f)
    trace = obs.phase_timings_to_chrome(doc)
    if out:
        obs.write_json(out, trace)
        print(f"# trace: {out}  ({len(trace['traceEvents'])} events)")
    else:
        print(json.dumps(trace))
    return 0


def cmd_serve(requests, grids, out, slo_out, flight_out, smoke,
              device="cuda") -> int:
    """Drive a small pipelined fleet workload under the tracer and emit
    the three serving artifacts: Chrome trace (flow-linked lifecycle),
    ``serve_slo/v1`` snapshot, ``flight_record/v1`` dump."""
    import torch
    import elemental_tpu_torch as et
    from elemental_tpu_torch import obs
    from elemental_tpu_torch.core import grid as grid_mod
    from elemental_tpu_torch.obs.lifecycle import check_timeline
    from elemental_tpu_torch.serve.chaos import build_workload
    from elemental_tpu_torch.serve.fleet import SolverFleet

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        print("obs serve: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    requests = 12 if requests is None else int(requests)
    grids = 2 if grids is None else int(grids)
    tenants = ("acme", "blue")
    prev_grid = grid_mod._default_grid
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    et.set_default_grid(et.Grid(device=device))
    torch.backends.cuda.matmul.allow_tf32 = False    # full-f32 solves
    try:
        fleet = SolverFleet(grids=grids, depth=2, max_batch=4, shed=False,
                            retries=0)
        tracer = obs.Tracer()
        with tracer:
            with tracer.span("serve:fleet", grids=grids, requests=requests):
                work = build_workload("hpd", 16, 2, requests, seed=7)
                futs = [fleet.submit("hpd", A, B,
                                     tenant=tenants[i % len(tenants)])
                        for i, (A, B) in enumerate(work)]
                for f in futs:
                    f.result(timeout=300.0)
                fleet.shutdown(drain=True)
        docs = [f.result(timeout=0)[1] for f in futs]
        replay = None
        if smoke:
            from elemental_tpu_torch.serve.chaos import \
                fleet_replay_identical
            replay = fleet_replay_identical(requests=4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        et.set_default_grid(prev_grid)
    problems = []
    for f, doc in zip(futs, docs):
        errs = check_timeline(doc.get("timeline"), path=doc.get("path"),
                              fleet=True)
        problems.extend(f"request f{f.fleet_id}: {e}" for e in errs)
    n_ok = sum(1 for d in docs if d.get("status") == "ok")
    print(f"# fleet: {grids} grids, {len(docs)} requests, {n_ok} ok, "
          f"{len(problems)} timeline problems")

    trace_doc = obs.chrome_trace_doc(tracer, mode="serve", grids=grids)
    evs = trace_doc["traceEvents"]
    flows = [ev for ev in evs if ev.get("ph") in ("s", "t", "f")]
    worker_tracks = {ev["args"]["name"] for ev in evs
                     if ev.get("ph") == "M"
                     and ev.get("name") == "thread_name"
                     and str(ev["args"]["name"])
                     .startswith("elemental-serve-worker")}
    print(f"# trace: {len(evs)} events, {len(flows)} flow events, "
          f"{len(worker_tracks)} grid-worker tracks")
    if out:
        obs.write_json(out, trace_doc)
        print(f"# trace file: {out} (load at https://ui.perfetto.dev)")

    sdoc = fleet.slo.snapshot(source="elemental_tpu_torch.obs serve")
    per_tenant = fleet.slo.per_tenant_p99_ms()
    for t in sorted(per_tenant):
        print(f"# slo[{t}]: p99={per_tenant[t]:.2f}ms")
    if slo_out:
        obs.write_json(slo_out, sdoc)
        print(f"# slo file: {slo_out}")

    # injected chaos trigger: dump the run's lifecycle record
    fdoc = fleet.flight.trigger("chaos_fault",
                                source="elemental_tpu_torch.obs serve")
    edge_events = sum(1 for ev in fdoc["events"]
                      if str(ev.get("kind", "")).startswith("edge:"))
    print(f"# flight: {len(fdoc['events'])} events in dump "
          f"({edge_events} lifecycle edges, {fdoc['dropped']} dropped)")
    if flight_out:
        obs.write_json(flight_out, fdoc)
        print(f"# flight file: {flight_out}")

    if smoke:
        if problems:
            for p in problems[:10]:
                print(f"SMOKE FAIL timeline: {p}", file=sys.stderr)
            return 1
        if n_ok != len(docs):
            print(f"SMOKE FAIL: only {n_ok}/{len(docs)} requests ok",
                  file=sys.stderr)
            return 1
        if not any(ev["ph"] == "s" for ev in flows) \
                or not any(ev["ph"] == "f" for ev in flows):
            print("SMOKE FAIL: export has no complete s->f flow chains",
                  file=sys.stderr)
            return 1
        if len(worker_tracks) < min(grids, 2):
            print(f"SMOKE FAIL: {len(worker_tracks)} grid-worker tracks "
                  f"in export, want >= {min(grids, 2)}", file=sys.stderr)
            return 1
        missing = [t for t in tenants if t not in per_tenant]
        if missing or not sdoc.get("series"):
            print(f"SMOKE FAIL: SLO snapshot incomplete "
                  f"(missing tenants {missing})", file=sys.stderr)
            return 1
        if edge_events == 0:
            print("SMOKE FAIL: flight dump has no lifecycle edges",
                  file=sys.stderr)
            return 1
        if not replay:
            print("SMOKE FAIL: grid-loss flight record not bit-identical "
                  "on replay", file=sys.stderr)
            return 1
        print("# smoke: timelines complete, flows linked, SLO per-tenant "
              "recorded, flight replay bit-identical")
    print(json.dumps(sdoc))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd not in ("run", "summary", "export", "serve"):
        print(__doc__)
        raise SystemExit(f"unknown command {cmd!r}")
    pos = []
    n = nb = crossover = None
    grid_spec = out = metrics_out = None
    requests = serve_grids = slo_out = flight_out = None
    smoke = False
    dtype_name, alg, lookahead, device = "float32", "auto", True, "cuda"
    it = iter(argv)
    for arg in it:
        if arg == "--n":
            n = int(next(it))
        elif arg == "--requests":
            requests = int(next(it))
        elif arg == "--grids":
            serve_grids = int(next(it))
        elif arg == "--slo-out":
            slo_out = next(it)
        elif arg == "--flight-out":
            flight_out = next(it)
        elif arg == "--smoke":
            smoke = True
        elif arg == "--nb":
            nb = int(next(it))
        elif arg == "--grid":
            grid_spec = next(it)
        elif arg == "--dtype":
            dtype_name = next(it)
        elif arg == "--alg":
            alg = next(it)
        elif arg == "--classic":
            lookahead = False
        elif arg == "--crossover":
            crossover = int(next(it))
        elif arg == "--out":
            out = next(it)
        elif arg == "--metrics-out":
            metrics_out = next(it)
        elif arg == "--device":
            device = next(it)
        elif arg.startswith("--"):
            raise SystemExit(f"unknown flag {arg!r}")
        else:
            pos.append(arg)
    if cmd == "run":
        if not pos:
            raise SystemExit(f"run needs a driver ({'/'.join(DRIVERS)})")
        driver = pos.pop(0)
        if driver not in DRIVERS:
            print(f"unknown driver {driver!r}; registered drivers:",
                  file=sys.stderr)
            for d in DRIVERS:
                print(f"  {d}", file=sys.stderr)
            return 1
        if pos and n is None:
            n = int(pos.pop(0))
        return cmd_run(driver, n, nb, grid_spec, dtype_name, alg, lookahead,
                       crossover, out, metrics_out, device)
    if cmd == "serve":
        return cmd_serve(requests, serve_grids, out, slo_out, flight_out,
                         smoke, device)
    if not pos:
        raise SystemExit(f"{cmd} needs a JSON file path")
    if cmd == "summary":
        return cmd_summary(pos[0])
    return cmd_export(pos[0], out)


if __name__ == "__main__":
    try:
        import signal
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)   # `| head` etc.
    except (ImportError, AttributeError, ValueError):
        pass
    raise SystemExit(main())
