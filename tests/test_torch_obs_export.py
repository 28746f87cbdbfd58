"""Chrome-trace / Perfetto export of the port (mirroring
``tests/obs/test_export.py``) and its command line,
``python -m elemental_tpu_torch.obs``.

The same records (a step clock, the same ticks, spans, collective and
instant events) render to the JAX package's document exactly.  Threads:
the JAX exporter keys tracks by ``threading.get_ident()``, which Python
hands to a thread started after an earlier one was joined; the port keys
them by a per-thread token, so two serial workers always get two tracks
(the repair), while a single-thread trace stays equal to the JAX one."""
import json
import subprocess
import sys
import threading
import time

import pytest

from elemental_tpu import obs as jobs
from elemental_tpu_torch import obs
from elemental_tpu_torch.obs import __main__ as cli


class StepClock:
    def __init__(self, dt=1.0):
        self.t = 0.0
        self.dt = dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _record(pkg):
    """A fake engine record of package ``pkg`` ("jax" or "torch")."""
    if pkg == "jax":
        from elemental_tpu.core.dist import MC, MR, STAR
        from elemental_tpu.redist.engine import RedistRecord
    else:
        from elemental_tpu_torch.core.dist import MC, MR, STAR
        from elemental_tpu_torch.redist.engine import RedistRecord
    return RedistRecord(kind="redistribute", src=(MC, MR), dst=(STAR, STAR),
                        gshape=(64, 64), dtype="float32", in_id=1,
                        out_ids=(2,), grid_shape=(2, 2))


def _traced_run(pkg_obs, pkg, instants=False):
    tr = pkg_obs.Tracer(metrics=False, clock=StepClock())
    with tr.span("run", driver="lu", n=64):
        ch = tr.channel("lu")
        ch.start()
        ch.tick("panel", 0)
        ch.tick("swap", 0)
        ch.tick("update", 0)
        ch.tick("panel", 1)
        tr._on_redist(_record(pkg))
        if instants:
            tr.instant("health:growth", driver="lu", phase="update", step=0)
            tr.instant("lifecycle:submitted", flow="r1")
            tr.instant("lifecycle:done", flow="r1")
    return tr


def test_chrome_trace_schema_pin():
    doc = obs.chrome_trace_doc(_traced_run(obs, "torch"), driver="lu", n=64)
    json.loads(json.dumps(doc))
    assert set(doc) == {"schema", "traceEvents", "displayTimeUnit",
                        "otherData"}
    assert doc["schema"] == obs.CHROME_SCHEMA == "obs_chrome_trace/v1"
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"] == {"driver": "lu", "n": 64}
    assert {ev["ph"] for ev in doc["traceEvents"]} == {"M", "X", "i"}
    for ev in doc["traceEvents"]:
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        if ev["ph"] == "X":
            assert ev["ts"] >= 0 and ev["dur"] >= 0
        if ev["ph"] == "i":
            assert ev["s"] == "t"
            assert {"kind", "gshape", "dtype", "bytes"} <= set(ev["args"])


@pytest.mark.parametrize("instants", [False, True])
def test_chrome_trace_equals_jax(instants):
    doc = obs.chrome_trace_doc(_traced_run(obs, "torch", instants), n=64)
    jdoc = jobs.chrome_trace_doc(_traced_run(jobs, "jax", instants), n=64)
    assert doc == jdoc


def test_chrome_trace_one_track_per_phase_lane():
    doc = obs.chrome_trace_doc(_traced_run(obs, "torch"))
    names = {ev["tid"]: ev["args"]["name"] for ev in doc["traceEvents"]
             if ev["ph"] == "M" and ev["name"] == "thread_name"}
    assert set(names.values()) == {"drivers", "steps", "phase:panel",
                                   "phase:swap", "phase:update",
                                   "collectives"}
    by_name = {v: k for k, v in names.items()}
    assert by_name["phase:panel"] < by_name["phase:swap"] \
        < by_name["phase:update"]
    for ev in doc["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] in ("panel", "swap", "update"):
            assert names[ev["tid"]] == f"phase:{ev['name']}"
    steps = [ev for ev in doc["traceEvents"]
             if ev["ph"] == "X" and names[ev["tid"]] == "steps"]
    assert {ev["name"] for ev in steps} == {"lu[0]", "lu[1]"}


def _phase_doc():
    return {"schema": "phase_timings/v1",
            "steps": [{"step": 0, "panel": 0.25, "update": 0.75},
                      {"step": 1, "panel": 0.5, "tournament": 0.1}],
            "totals": {"panel": 0.75, "update": 0.75, "tournament": 0.1},
            "total_seconds": 1.6, "driver": "cholesky", "n": 64, "nb": 16}


def test_phase_timings_to_chrome_equals_jax():
    doc = obs.phase_timings_to_chrome(_phase_doc(), tag="x")
    assert doc == jobs.phase_timings_to_chrome(_phase_doc(), tag="x")
    assert doc["otherData"]["synthesized"] is True
    xs = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"
          and ev["name"] in ("panel", "update")]
    assert [(ev["ts"], ev["dur"]) for ev in xs] == \
        [(0.0, 0.25e6), (0.25e6, 0.75e6), (1e6, 0.5e6)]
    with pytest.raises(ValueError):
        obs.phase_timings_to_chrome({"schema": "comm_plan/v1"})


# ---------------------------------------------------------------------
# per-thread tracks: the repair of the ident-keyed exporter
# ---------------------------------------------------------------------

def _serial_workers(pkg_obs):
    """Two named workers run one after the other; returns the tracer,
    the document and the workers' idents."""
    tracer = pkg_obs.Tracer(metrics=False, clock=StepClock(dt=0.001))
    idents = []

    def worker(tag):
        idents.append(threading.get_ident())
        with tracer.span(f"serve:{tag}"):
            tracer.instant("lifecycle:admitted", flow="f0", grid=tag)

    with tracer.span("serve:fleet"):
        tracer.instant("lifecycle:submitted", flow="f0")
        for tag in ("w0", "w1"):
            t = threading.Thread(target=worker, args=(tag,),
                                 name=f"elemental-serve-worker:{tag}")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            time.sleep(0.02)        # let the OS thread exit: its stack
                                    # (and ident) becomes reusable
        tracer.instant("lifecycle:done", flow="f0")
    return tracer, pkg_obs.chrome_trace_doc(tracer, mode="test"), idents


def test_serial_threads_with_a_reused_ident_get_two_tracks():
    """Python hands the joined first worker's ident to the second: the
    JAX exporter would merge the two tracks, the port keeps both."""
    for _ in range(20):                 # ident reuse is near-certain
        tracer, doc, idents = _serial_workers(obs)
        if idents[0] == idents[1]:
            break
    assert idents[0] == idents[1], "no ident reuse observed"
    evs = doc["traceEvents"]
    tracks = {e["args"]["name"]: e["tid"] for e in evs
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tracks["elemental-serve-worker:w0"] \
        != tracks["elemental-serve-worker:w1"]
    spans = {e["name"]: e["tid"] for e in evs if e["ph"] == "X"}
    assert spans["serve:w0"] == tracks["elemental-serve-worker:w0"]
    assert spans["serve:w1"] == tracks["elemental-serve-worker:w1"]
    flow = [e for e in evs if e["ph"] in ("s", "t", "f")]
    assert [e["ph"] for e in flow] == ["s", "t", "t", "f"]
    assert {flow[1]["tid"], flow[2]["tid"]} \
        == {tracks["elemental-serve-worker:w0 events"],
            tracks["elemental-serve-worker:w1 events"]}
    assert len({s.thread for s in tracer.spans}) == 3


def test_jax_exporter_merges_serial_threads_that_share_an_ident():
    """The cause of the red JAX telemetry test, pinned: under ident reuse
    the JAX document has ONE worker track where the port has two."""
    for _ in range(20):
        _, jdoc, idents = _serial_workers(jobs)
        if idents[0] == idents[1]:
            break
    assert idents[0] == idents[1], "no ident reuse observed"
    names = [e["args"]["name"] for e in jdoc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"
             and e["args"]["name"].startswith("elemental-serve-worker:")
             and not e["args"]["name"].endswith(" events")]
    assert names == ["elemental-serve-worker:w0"]


def test_single_thread_document_equals_jax():
    def run(pkg_obs):
        tr = pkg_obs.Tracer(metrics=False, clock=StepClock())
        with tr.span("outer"):
            ch = tr.channel("qr")
            ch.start()
            ch.tick("panel", 0)
            ch.tick("update", 0)
            tr.instant("lifecycle:submitted", flow="a")
            tr.instant("lifecycle:done", flow="a")
        return pkg_obs.chrome_trace_doc(tr, k=1)
    assert run(obs) == run(jobs)


def test_single_instant_flow_not_linked():
    tracer = obs.Tracer(metrics=False, clock=StepClock())
    tracer.instant("lifecycle:submitted", flow="lonely")
    evs = obs.chrome_trace_doc(tracer)["traceEvents"]
    assert not [e for e in evs if e["ph"] in ("s", "t", "f")]


def test_write_json(tmp_path):
    p = tmp_path / "t.json"
    obs.write_json(str(p), {"a": 1})
    assert p.read_text() == '{\n "a": 1\n}\n'


# ---------------------------------------------------------------------
# the command line (CPU)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["cholesky", "gemm"])
def test_cli_run_summary_export(driver, tmp_path, capsys):
    out = tmp_path / "trace.json"
    mout = tmp_path / "metrics.json"
    rc = cli.cmd_run(driver, 32, 8, "2x2", "float64", "C", True, None,
                     str(out), str(mout), device="cpu")
    assert rc == 0
    stdout = capsys.readouterr().out
    lines = stdout.strip().splitlines()
    assert any(ln.startswith(f"# phases[{driver}]:") for ln in lines)
    mdoc = json.loads(lines[-1])
    assert mdoc["schema"] == "obs_metrics/v1" and mdoc["device"] == "cpu"
    ops = {c["labels"]["op"]: c["value"] for c in mdoc["counters"]
           if c["name"] == "op_calls"}
    assert ops == {driver: 1}
    tdoc = json.loads(out.read_text())
    assert tdoc["schema"] == obs.CHROME_SCHEMA
    assert any(ev.get("ph") == "i" for ev in tdoc["traceEvents"])
    assert json.loads(mout.read_text())["schema"] == "obs_metrics/v1"
    assert cli.cmd_summary(str(out)) == 0
    summary = capsys.readouterr().out
    assert "phase:" in summary and "drivers" in summary
    ph = tmp_path / "phases.json"
    ph.write_text(json.dumps(_phase_doc()))
    out2 = tmp_path / "trace2.json"
    assert cli.cmd_export(str(ph), str(out2)) == 0
    assert json.loads(out2.read_text()) == \
        jobs.phase_timings_to_chrome(_phase_doc())


def test_cli_refuses_serve_and_unknown_drivers(capsys):
    """``serve`` runs since the serving slice (a traced 2-grid fleet on
    the CPU, self-checked); an unknown driver or command is refused."""
    assert cli.main(["serve", "--device", "cpu", "--requests", "4",
                     "--smoke"]) == 0
    assert "# smoke: timelines complete" in capsys.readouterr().out
    assert cli.main(["run", "svd"]) == 1
    with pytest.raises(SystemExit):
        cli.main(["frobnicate"])


def test_cli_module_runs_in_a_fresh_interpreter(tmp_path):
    """``python -m elemental_tpu_torch.obs`` end to end, and the port
    imports no JAX."""
    out = tmp_path / "t.json"
    code = ("import sys, runpy; sys.argv = ['obs', 'run', 'lu', '--n', "
            f"'32', '--nb', '8', '--device', 'cpu', '--out', {str(out)!r}];"
            "\ntry:\n    runpy.run_module('elemental_tpu_torch.obs', "
            "run_name='__main__')\nexcept SystemExit as e:\n    rc = e.code"
            "\nbad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'elemental_tpu.'))]\n"
            "print('LEAK', bad) if bad else print('RC', rc)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "RC 0", res.stdout + res.stderr
    assert json.loads(lines[-2])["schema"] == "obs_metrics/v1"
    assert json.loads(out.read_text())["schema"] == obs.CHROME_SCHEMA
