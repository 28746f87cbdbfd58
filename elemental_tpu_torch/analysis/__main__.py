"""Comm-plan and memory-plan audit command line.

The twin of the JAX package's ``perf/comm_audit.py``, with the same
commands, selection rules and flags.  Each command runs the registered
drivers once on a virtual grid (1x1 and 2x2 unless ``--grid``) and works
with the ``comm_plan/v1`` / ``memory_plan/v1`` documents:

    python -m elemental_tpu_torch.analysis audit cholesky
                                            # print plans (every
                                            #   cholesky_* x grids)
    python -m elemental_tpu_torch.analysis audit lu_classic --grid 2x2 --events
    python -m elemental_tpu_torch.analysis diff
                                            # every driver against the
                                            #   goldens under
                                            #   tests/golden/comm_plans/
    python -m elemental_tpu_torch.analysis lint --all --fix-hint
                                            # EL001-EL005; exit 1 on
                                            #   any finding
    python -m elemental_tpu_torch.analysis mem cholesky
                                            # print memory plans
    python -m elemental_tpu_torch.analysis mem-diff
                                            # against
                                            #   tests/golden/memory_plans/
    python -m elemental_tpu_torch.analysis mem-lint --all
                                            # EL006-EL009; exit 1 on
                                            #   any finding

A driver name selects by exact match or prefix.  ``diff`` / ``mem-diff``
exit 1 when a plan deviates from its golden.  The goldens under
``tests/golden/`` are the JAX package's: a port comm plan equals its
golden key for key; a port memory plan is held to the golden's shared
fields (meta, ``static``, ``args_bytes``, ``outs_bytes``,
``nonstatic_peak_bytes``, the replicated census), since its peak and
timeline are measured, not walked.  ``--golden-dir DIR`` reads port
goldens from ``DIR/comm_plans`` and ``DIR/memory_plans`` instead (all
fields compared), and ``--update-golden`` writes them there; without
``--golden-dir``, or with a directory inside ``tests/golden``, it exits 2
and writes nothing.

Flags: ``--grid RxC``, ``--all``, ``--events``, ``--fix-hint``, ``--n N``,
``--nb NB``, ``--golden-dir DIR``, ``--update-golden``, ``--device D``
(default ``cuda``; ``cpu`` for the CPU).  Without a card and without
``--device cpu`` the command exits 2.
"""
import json
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]
GOLDEN_ROOT = _REPO / "tests" / "golden"

#: grids every audit runs on: the single device and the smallest 2-D grid
GRIDS = ((1, 1), (2, 2))


def _select(name) -> list:
    from elemental_tpu_torch import analysis as an
    names = an.driver_names()
    if name is None:
        return names
    if name in names:
        return [name]
    picked = [d for d in names if d.startswith(name)]
    if not picked:
        raise SystemExit(f"unknown driver {name!r}; known: {names}")
    return picked


class _Ctx:
    """The command's options."""

    def __init__(self, device, n, nb, golden_dir):
        self.device = device
        self.kw = {k: v for k, v in (("n", n), ("nb", nb)) if v is not None}
        self.golden_dir = golden_dir

    def grid(self, rc):
        from elemental_tpu_torch.core.grid import Grid
        return Grid(rc[0], rc[1], device=self.device)

    def trace(self, driver, rc):
        from elemental_tpu_torch import analysis as an
        return an.trace_driver(driver, self.grid(rc), **self.kw)

    def trace_mem(self, driver, rc):
        from elemental_tpu_torch import analysis as an
        return an.trace_memory(driver, self.grid(rc), **self.kw)

    def path(self, kind, driver, rc) -> Path:
        root = Path(self.golden_dir) if self.golden_dir else GOLDEN_ROOT
        return root / kind / f"{driver}__{rc[0]}x{rc[1]}.json"


def _tag(driver, rc) -> str:
    return f"{driver} {rc[0]}x{rc[1]}"


def _write(path: Path, doc: dict, tag: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    print(f"updated {tag}: {path}")


def _check(ctx, kind, drivers, grids, update, make_doc, diff) -> int:
    bad = 0
    for driver in drivers:
        for rc in grids:
            doc = make_doc(driver, rc)
            path = ctx.path(kind, driver, rc)
            tag = _tag(driver, rc)
            if update:
                _write(path, doc, tag)
                continue
            if not path.exists():
                what = "memory golden" if kind == "memory_plans" else "golden"
                print(f"MISSING {what} for {tag} ({path}); "
                      f"run with --update-golden")
                bad += 1
                continue
            with open(path) as f:
                lines = diff(json.load(f), doc)
            if lines:
                bad += 1
                print(f"DIFF {tag}:")
                for ln in lines:
                    print(f"  {ln}")
            else:
                print(f"ok {tag}")
    return 1 if bad else 0


def cmd_audit(ctx, drivers, grids, events: bool) -> int:
    for driver in drivers:
        for rc in grids:
            print(ctx.trace(driver, rc)[0].to_json(events=events))
    return 0


def cmd_diff(ctx, drivers, grids, update: bool) -> int:
    from elemental_tpu_torch.analysis import golden_doc, diff_docs
    return _check(ctx, "comm_plans", drivers, grids, update,
                  lambda d, rc: golden_doc(ctx.trace(d, rc)[0]), diff_docs)


def cmd_lint(ctx, drivers, grids, fix_hint: bool) -> int:
    from elemental_tpu_torch.analysis import lint_plan
    total = 0
    for driver in drivers:
        for rc in grids:
            plan, records, _ = ctx.trace(driver, rc)
            findings = lint_plan(plan, records)
            for f in findings:
                print(f"{_tag(driver, rc)}: {f}")
                if fix_hint and f.fix_hint:
                    print(f"  fix: {f.fix_hint}")
            total += len(findings)
    print(f"{total} finding(s)")
    return 1 if total else 0


def cmd_mem(ctx, drivers, grids) -> int:
    for driver in drivers:
        for rc in grids:
            print(ctx.trace_mem(driver, rc)[0].to_json())
    return 0


def cmd_mem_diff(ctx, drivers, grids, update: bool) -> int:
    from elemental_tpu_torch.analysis import golden_mem_doc, diff_mem_docs
    measured = ctx.golden_dir is not None

    def diff(golden, doc):
        return diff_mem_docs(golden, doc, measured=measured)
    return _check(ctx, "memory_plans", drivers, grids, update,
                  lambda d, rc: golden_mem_doc(ctx.trace_mem(d, rc)[0]),
                  diff)


def cmd_mem_lint(ctx, drivers, grids, fix_hint: bool) -> int:
    from elemental_tpu_torch.analysis import lint_memory, peak_ratio
    total = 0
    for driver in drivers:
        for rc in grids:
            mplan = ctx.trace_mem(driver, rc)[0]
            records = ctx.trace(driver, rc)[1]     # ids stay unique here
            findings = lint_memory(mplan, records)
            for f in findings:
                print(f"{_tag(driver, rc)}: {f} "
                      f"(peak ratio {peak_ratio(mplan):.3f})")
                if fix_hint and f.fix_hint:
                    print(f"  fix: {f.fix_hint}")
            total += len(findings)
    print(f"{total} finding(s)")
    return 1 if total else 0


def _inside(path: Path, root: Path) -> bool:
    path, root = path.resolve(), root.resolve()
    return path == root or root in path.parents


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd = argv.pop(0)
    if cmd not in ("audit", "diff", "lint", "mem", "mem-diff", "mem-lint"):
        print(__doc__)
        raise SystemExit(f"unknown command {cmd!r}")
    name = golden_dir = None
    grids = list(GRIDS)
    n = nb = None
    device = "cuda"
    events = update = fix_hint = False
    it = iter(argv)
    for arg in it:
        if arg == "--grid":
            r, c = next(it).split("x")
            grids = [(int(r), int(c))]
        elif arg == "--n":
            n = int(next(it))
        elif arg == "--nb":
            nb = int(next(it))
        elif arg == "--device":
            device = next(it)
        elif arg == "--golden-dir":
            golden_dir = next(it)
        elif arg == "--events":
            events = True
        elif arg == "--update-golden":
            update = True
        elif arg == "--fix-hint":
            fix_hint = True
        elif arg == "--all":
            name = None
        elif arg.startswith("--"):
            raise SystemExit(f"unknown flag {arg!r}")
        else:
            name = arg
    if update and (golden_dir is None
                   or _inside(Path(golden_dir), GOLDEN_ROOT)):
        print("--update-golden writes only to a --golden-dir outside "
              f"{GOLDEN_ROOT}: those goldens are the JAX package's",
              file=sys.stderr)
        return 2
    import torch
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        print("analysis: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    drivers = _select(name)
    ctx = _Ctx(device, n, nb, golden_dir)
    if cmd == "audit":
        return cmd_audit(ctx, drivers, grids, events)
    if cmd == "diff":
        return cmd_diff(ctx, drivers, grids, update)
    if cmd == "mem":
        return cmd_mem(ctx, drivers, grids)
    if cmd == "mem-diff":
        return cmd_mem_diff(ctx, drivers, grids, update)
    if cmd == "mem-lint":
        return cmd_mem_lint(ctx, drivers, grids, fix_hint)
    return cmd_lint(ctx, drivers, grids, fix_hint)


if __name__ == "__main__":
    try:
        import signal
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)   # `| head` etc.
    except (ImportError, AttributeError, ValueError):
        pass
    raise SystemExit(main())
