"""Solver-service command line: run, smoke-test, or chaos-test the
batched serving front-end.

The twin of the JAX package's ``perf/serve.py``, with the same commands
and flags:

    python -m elemental_tpu_torch.serve run --requests 32 --n 96 --grid 2x2
                                            # drive a mixed workload
                                            #   through SolverService;
                                            #   per-request summary rows
                                            #   (#-prefixed) + one JSON
                                            #   tally line on stdout
    python -m elemental_tpu_torch.serve run --budget 0.5 \\
        --fault redistribute:nan:2:every    # deadline-bounded requests
                                            #   under fault injection
    python -m elemental_tpu_torch.serve smoke
                                            # mixed-size serving on 1x1
                                            #   AND 2x2 grids, all ok,
                                            #   entry-cache reuse proven,
                                            #   an escalated solve, the
                                            #   lstsq fast path and the
                                            #   async pipelined front
                                            #   (streamed callbacks, no
                                            #   thread leak); exit 1 on
                                            #   failure
    python -m elemental_tpu_torch.serve chaos
                                            # the acceptance matrix
                                            #   {bitflip,scale,nan} x
                                            #   {redistribute,compute} x
                                            #   {oneshot,persistent} plus
                                            #   the abft-guarded qr column
                                            #   and the async column:
                                            #   chaos_report/v1 on stdout,
                                            #   exit 1 on any violation
    python -m elemental_tpu_torch.serve fleet-smoke
                                            # 2-grid fleet on the virtual
                                            #   grid's 8 ranks: pipelined
                                            #   multi-tenant serving with
                                            #   grid/tenant provenance,
                                            #   structured quota rejects,
                                            #   grid-loss re-routing
                                            #   (replayed bit-identically)
                                            #   and saturation shedding
                                            #   with flat admitted latency

Everything runs on ``cuda:0`` unless ``--device cpu``; the chosen
device becomes the default grid's, so fleets and chaos cells run there
too.  Workloads are float32 (the card's serving dtype).  ``--fault``
takes ``target:kind[:call[:every]]``, the ``compute`` target included.
"""
import json
import sys


def _grid(spec, device):
    from elemental_tpu_torch.core.grid import Grid
    if spec is None:
        spec = "1x1" if str(device).startswith("cuda") else "2x2"
    r, c = (int(x) for x in spec.split("x"))
    return Grid(r, c, device=device)


def _parse_fault(spec: str):
    """``target:kind[:call[:every]]`` -> FaultSpec."""
    from elemental_tpu_torch.resilience import FaultSpec
    parts = spec.split(":")
    if len(parts) < 2:
        raise SystemExit(f"--fault needs target:kind[:call[:every]], "
                         f"got {spec!r}")
    target, kind = parts[0], parts[1]
    call = int(parts[2]) if len(parts) > 2 else 0
    every = len(parts) > 3 and parts[3] == "every"
    return FaultSpec(target=target, kind=kind, call=call, every=every)


def _workload(rng, count, n):
    """Mixed lu/hpd problems around size n (two adjacent buckets)."""
    import numpy as np
    out = []
    for i in range(count):
        op = "lu" if i % 2 else "hpd"
        ni = n if i % 3 else max(8, (3 * n) // 4)
        F = rng.normal(size=(ni, ni)).astype(np.float32)
        A = (F @ F.T / ni + ni * np.eye(ni)).astype(np.float32) \
            if op == "hpd" else F + ni * np.eye(ni, dtype=np.float32)
        B = rng.normal(size=(ni, 2)).astype(np.float32)
        out.append((op, A, B))
    return out


def _tally(svc, docs) -> dict:
    st: dict = {}
    for doc in docs.values():
        st[doc["status"]] = st.get(doc["status"], 0) + 1
    lat = sorted(d["latency_s"] for d in docs.values())
    return {"schema": "serve_run/v1", "requests": len(docs), "status": st,
            "p50_ms": 1e3 * lat[len(lat) // 2] if lat else None,
            "p99_ms": 1e3 * lat[min(len(lat) - 1,
                                    (99 * len(lat)) // 100)] if lat else None,
            "exec_cache": svc.executor.cache.stats()}


def cmd_run(requests, n, grid_spec, budget, faults, seed, fastpath,
            device) -> int:
    import numpy as np
    from elemental_tpu_torch.resilience import FaultPlan, fault_injection
    from elemental_tpu_torch.serve import SolverService
    grid = _grid(grid_spec, device)
    svc = SolverService(grid, fastpath=fastpath)
    rng = np.random.default_rng(seed)
    rejects = 0
    for op, A, B in _workload(rng, requests, n):
        rid = svc.submit(op, A, B, budget_s=budget)
        if isinstance(rid, dict):
            rejects += 1
            print(f"# reject: {rid['reason']} bucket={rid['bucket']}")
    if faults:
        plan = FaultPlan(seed=seed, faults=faults)
        with fault_injection(plan):
            docs = svc.drain()
        print(f"# faults fired: {plan.fired()}")
    else:
        docs = svc.drain()
    for rid in sorted(docs):
        d = docs[rid]
        res = d["residual"]
        print(f"# req {rid:3d} {d['op']:3s} n={d['n']:5d} "
              f"{d['status']:9s} path={d['path']:9s} "
              f"rung={str(d['rung']):8s} "
              f"residual={'-' if res is None else format(res, '.2e')} "
              f"latency={1e3 * d['latency_s']:.2f}ms")
    tally = _tally(svc, docs)
    tally["rejects"] = rejects
    print(json.dumps(tally))
    bad = sum(1 for d in docs.values()
              if d["status"] not in ("ok", "failed", "timed_out"))
    return 1 if bad else 0


def _leaked() -> bool:
    import threading
    return any(t.name.startswith("elemental-serve-worker") and t.is_alive()
               for t in threading.enumerate())


def cmd_smoke(device) -> int:
    """Mixed-size workloads must ALL certify on the fast path on 1x1 and
    2x2 grids, the entry cache must be reused (a second drain of the same
    geometries captures nothing), and one escalated solve must certify
    end-to-end."""
    import numpy as np
    from elemental_tpu_torch.obs import metrics as _metrics
    from elemental_tpu_torch.serve import AsyncSolverService, SolverService
    rc = 0
    for spec in ("1x1", "2x2"):
        svc = SolverService(_grid(spec, device))
        rng = np.random.default_rng(0)
        with _metrics.scoped() as reg:
            for op, A, B in _workload(rng, 8, 48):
                rid = svc.submit(op, A, B)
                if isinstance(rid, dict):
                    print(f"# smoke {spec}: unexpected reject {rid}")
                    rc = 1
            docs = svc.drain()
            ok = sum(d["status"] == "ok" for d in docs.values())
            # same geometries again: every batch must hit the entry cache
            for op, A, B in _workload(rng, 8, 48):
                svc.submit(op, A, B)
            docs2 = svc.drain()
            ok2 = sum(d["status"] == "ok" for d in docs2.values())
            events = reg.counters("serve_exec_cache_events").items()
            compiles = sum(v for (_, labels), v in events
                           if dict(labels).get("event") == "compile")
            hits = sum(v for (_, labels), v in events
                       if dict(labels).get("event") == "hit")
        print(f"# smoke {spec}: ok={ok}/8 + {ok2}/8 "
              f"exec compiles={compiles} hits={hits}")
        if ok != 8 or ok2 != 8 or hits == 0:
            rc = 1
    # escalated path: fastpath off, must certify through certified_solve
    svc = SolverService(_grid("2x2", device), fastpath=False)
    rng = np.random.default_rng(1)
    F = rng.normal(size=(32, 32)).astype(np.float32)
    X, doc = svc.solve("lu", F + 32 * np.eye(32, dtype=np.float32),
                       rng.normal(size=(32, 2)).astype(np.float32))
    print(f"# smoke escalate: status={doc['status']} rung={doc['rung']}")
    if doc["status"] != "ok" or doc["path"] != "escalated":
        rc = 1
    # batched QR least squares: a tall lstsq must certify on the fast
    # path against the normal-equations residual
    svc = SolverService(_grid("1x1", device))
    At = rng.normal(size=(40, 12)).astype(np.float32)
    Bt = rng.normal(size=(40, 2)).astype(np.float32)
    X, doc = svc.solve("lstsq", At, Bt)
    print(f"# smoke lstsq: status={doc['status']} bucket={doc['bucket']}")
    if doc["status"] != "ok" or doc["path"] != "fastpath":
        rc = 1
    # async pipelined front: the same mixed workload streams through
    # AsyncSolverService -- all ok, every completion streamed via
    # callback, and the worker thread joined (no leak)
    front = AsyncSolverService(grid=_grid("1x1", device))
    streamed: list = []
    futs = [front.submit(op, A, B,
                         callback=lambda f: streamed.append(f.id))
            for op, A, B in _workload(rng, 8, 32)]
    outs = [f.result(timeout=300.0) for f in futs]
    ok_async = sum(d["status"] == "ok" for _, d in outs)
    front.shutdown(drain=True)
    leak = _leaked()
    occ = front.pipeline_stats()["occupancy"]
    print(f"# smoke async: ok={ok_async}/8 streamed={len(streamed)} "
          f"leak={leak} occupancy={occ:.2f}")
    if ok_async != 8 or len(streamed) != 8 or leak:
        rc = 1
    print("# serve smoke:", "ok" if rc == 0 else "FAILED")
    return rc


def cmd_fleet_smoke(seed) -> int:
    """Partition the virtual grid's ranks into a 2-grid fleet and pin
    four contracts end to end: (1) pipelined multi-tenant serving uses
    BOTH members and stamps grid/tenant provenance into every doc, with
    a clean shutdown; (2) tenant quotas reject structurally
    (``reason='quota'``); (3) the grid-loss chaos cell re-routes around
    an opened member, replayed bit-identically; (4) the saturation cell
    sheds structurally with flat admitted latency."""
    import numpy as np
    from elemental_tpu_torch.serve import SolverFleet, TenantQuota
    from elemental_tpu_torch.serve.chaos import (fleet_replay_identical,
                                                 run_fleet_grid_loss_cell,
                                                 run_fleet_saturation_cell)
    rc = 0
    # leg 1: pipelined 2-grid fleet, two tenants, full provenance
    fleet = SolverFleet(grids=2, depth=2, shed=False)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(16):
        ni = 24
        F = rng.normal(size=(ni, ni)).astype(np.float32)
        A = (F @ F.T / ni + ni * np.eye(ni)).astype(np.float32)
        B = rng.normal(size=(ni, 2)).astype(np.float32)
        reqs.append((A, B, f"t{i % 2}"))
    futs = [fleet.submit("hpd", A, B, tenant=t) for A, B, t in reqs]
    outs = [f.result(timeout=300.0) for f in futs]
    fleet.shutdown(drain=True)
    ok = sum(d["status"] == "ok" for _, d in outs)
    grids_used = {d["grid"] for _, d in outs}
    tenants = {d["tenant"] for _, d in outs}
    leak = _leaked()
    print(f"# fleet smoke pipelined: ok={ok}/16 grids={sorted(grids_used)} "
          f"tenants={sorted(tenants)} leak={leak}")
    if ok != 16 or grids_used != {"g0", "g1"} \
            or tenants != {"t0", "t1"} or leak:
        rc = 1
    # leg 2: max_outstanding quota rejects fast and structured
    fleet = SolverFleet(grids=2, pipelined=False, shed=False,
                        quotas={"q": TenantQuota(max_outstanding=4)})
    futs = [fleet.submit("hpd", A, B, tenant="q") for A, B, _ in reqs[:8]]
    quota_rej = [f.result(timeout=0)[1] for f in futs if f.done()
                 and f.result(timeout=0)[1].get("reason") == "quota"]
    fleet.drain()
    fleet.shutdown(drain=True)
    served = sum(1 for f in futs
                 if f.result(timeout=0)[1].get("status") == "ok")
    print(f"# fleet smoke quota: served={served} rejects={len(quota_rej)}")
    if len(quota_rej) != 4 or served != 4 \
            or any(d.get("tenant") != "q" for d in quota_rej):
        rc = 1
    # leg 3: grid loss re-routes, bit-identical replay
    cell, _ = run_fleet_grid_loss_cell(seed=seed + 7)
    replay = fleet_replay_identical(seed=seed + 7)
    print(f"# fleet smoke grid-loss: verdict={cell['verdict']} "
          f"ok={cell['ok']}/{cell['requests']} replay={replay}")
    if cell["violations"] or not replay:
        for v in cell["violations"]:
            print(f"#   violation: {v}")
        rc = 1
    # leg 4: saturation sheds structurally, admitted latency flat
    cell, _ = run_fleet_saturation_cell(seed=seed + 11)
    sheds = sum(w["sheds"] for w in cell["waves"])
    print(f"# fleet smoke saturation: verdict={cell['verdict']} "
          f"waves={cell['waves']}")
    if cell["violations"] or sheds == 0:
        for v in cell["violations"]:
            print(f"#   violation: {v}")
        rc = 1
    print("# fleet smoke:", "ok" if rc == 0 else "FAILED")
    return rc


def cmd_chaos(seed, device) -> int:
    from elemental_tpu_torch.serve import chaos_matrix, replay_identical
    grid = _grid("2x2", device)
    report = chaos_matrix(grid, seed=seed)
    for cell in report["cells"]:
        print(f"# {cell['op']:3s} {cell['target']:12s} {cell['kind']:8s} "
              f"{cell['mode']:10s} -> {cell['verdict']:10s} "
              f"ok={cell['ok']}/{cell['requests']} fired={cell['fired']} "
              f"violations={len(cell['violations'])}")
    replay = replay_identical(grid, seed=seed + 16)
    print(f"# replay deterministic: {replay}")
    print(json.dumps(report))
    ok = report["ok"] and replay
    print("# serve chaos:", "ok" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd not in ("run", "smoke", "chaos", "fleet-smoke"):
        print(__doc__)
        raise SystemExit(f"unknown command {cmd!r}")
    requests, n, budget = 16, 64, None
    grid_spec = None
    seed = 0
    fastpath = True
    faults = []
    device = "cuda"
    it = iter(argv)
    for arg in it:
        if arg == "--requests":
            requests = int(next(it))
        elif arg == "--n":
            n = int(next(it))
        elif arg == "--grid":
            grid_spec = next(it)
        elif arg == "--budget":
            budget = float(next(it))
        elif arg == "--seed":
            seed = int(next(it))
        elif arg == "--fault":
            faults.append(next(it))
        elif arg == "--no-fastpath":
            fastpath = False
        elif arg == "--device":
            device = next(it)
        elif arg.startswith("--"):
            raise SystemExit(f"unknown flag {arg!r}")
        else:
            raise SystemExit(f"unexpected argument {arg!r}")
    import torch
    import elemental_tpu_torch as et
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        print("serve: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    et.set_default_grid(et.Grid(device=device))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # full-f32 solves
    try:
        if cmd == "smoke":
            return cmd_smoke(device)
        if cmd == "chaos":
            return cmd_chaos(seed, device)
        if cmd == "fleet-smoke":
            return cmd_fleet_smoke(seed)
        fspecs = tuple(_parse_fault(s) for s in faults)
        return cmd_run(requests, n, grid_spec, budget, fspecs, seed,
                       fastpath, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


if __name__ == "__main__":
    raise SystemExit(main())
