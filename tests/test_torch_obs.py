"""The port's telemetry (``repro_torch.obs``: trace, export, report,
rss) against the reference package's.

Mirrors tests/test_obs.py test for test on the port's modules; the
reference's ``jax_profile`` is the port's ``torch_profile``.  The last
tests read the same logs with both packages: the merged Chrome trace,
the report and ``timing.json`` are equal.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import pytest

from repro_torch.obs import export, report, rss
from repro_torch.obs import trace as obs


@pytest.fixture(autouse=True)
def _no_global_tracer():
    """Each test starts and ends with module-level tracing disabled."""
    obs.disable()
    yield
    obs.disable()


# ---------------------------------------------------------------------------
# trace: spans, counters, disabled mode
# ---------------------------------------------------------------------------

def test_span_nesting_and_order(tmp_path):
    tr = obs.Tracer(path=tmp_path / obs.log_name(0), process=0,
                    meta={"run": "t"})
    with tr.span("outer", cat="test"):
        with tr.span("inner", cat="test"):
            pass
    tr.close()
    spans = [e for e in tr.events if e["ev"] == "span"]
    # inner closes first, so it is recorded first
    assert [s["name"] for s in spans] == ["inner", "outer"]
    inner, outer = spans
    # containment: inner lies inside outer on the same thread's track
    assert inner["tid"] == outer["tid"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 0.1


def test_span_exception_safety():
    tr = obs.Tracer()
    with pytest.raises(ValueError):
        with tr.span("boom", cat="test"):
            raise ValueError("x")
    spans = [e for e in tr.events if e["ev"] == "span"]
    assert len(spans) == 1
    assert spans[0]["name"] == "boom"
    assert spans[0]["args"]["err"] == "ValueError"


def test_span_set_args():
    tr = obs.Tracer()
    with tr.span("round", cat="test", k=1) as sp:
        sp.set(remaining=42)
    (span,) = (e for e in tr.events if e["ev"] == "span")
    assert span["args"] == {"k": 1, "remaining": 42}


def test_disabled_module_api_is_noop():
    assert obs.get_tracer() is None
    assert not obs.enabled()
    # the disabled fast path returns the shared singleton — no allocation
    assert obs.span("x") is obs.NULL_SPAN
    assert obs.span("y", cat="z", a=1) is obs.NULL_SPAN
    with obs.span("x") as sp:
        sp.set(a=1)
    obs.counter("c", 1)
    obs.add("c", 1)
    obs.flush()

    @obs.traced("f")
    def f(x):
        return x + 1

    assert f(1) == 2


def test_configure_and_counters(tmp_path):
    tr = obs.configure(path=tmp_path / obs.log_name(3), process=3)
    assert obs.get_tracer() is tr and obs.enabled()
    obs.counter("gauge", 7)
    obs.add("total", 5)  # module front door
    tr.add("total", 5)   # direct handle — same accumulator
    obs.disable()
    counters = [e for e in tr.events if e["ev"] == "counter"]
    by_name = {}
    for c in counters:
        by_name.setdefault(c["name"], []).append(c["value"])
    assert by_name["gauge"] == [7]
    assert by_name["total"] == [5, 10]  # running totals, in order


def test_tracer_thread_safety(tmp_path):
    tr = obs.Tracer(path=tmp_path / obs.log_name(0), flush_every=7)

    def work(i):
        for k in range(50):
            with tr.span(f"t{i}", cat="thread"):
                tr.add("n", 1)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tr.close()
    events = export.load_events(tr.path)
    spans = [e for e in events if e["ev"] == "span"]
    assert len(spans) == 200
    assert tr._counters["n"] == 200


# ---------------------------------------------------------------------------
# JSONL schema round-trip + merge
# ---------------------------------------------------------------------------

def test_jsonl_schema_roundtrip(tmp_path):
    path = tmp_path / obs.log_name(0)
    tr = obs.Tracer(path=path, process=0, meta={"devices": 4})
    with tr.span("ingest", cat="runtime", mode="single"):
        pass
    tr.counter("edges_remaining", 100)
    tr.close()
    events = export.load_events(path)
    assert events[0]["ev"] == "meta"
    assert events[0]["v"] == obs.SCHEMA_VERSION
    assert events[0]["args"] == {"devices": 4}
    assert isinstance(events[0]["start_unix"], float)
    kinds = {e["ev"] for e in events}
    assert kinds == {"meta", "span", "counter"}
    span = next(e for e in events if e["ev"] == "span")
    assert span["name"] == "ingest" and span["cat"] == "runtime"
    assert span["args"] == {"mode": "single"}
    assert span["dur"] >= 0
    # in-memory events and the file agree line for line
    assert events == json.loads(
        "[" + ",".join(json.dumps(e, default=float)
                       for e in tr.events) + "]")


def test_load_events_skips_torn_tail(tmp_path):
    path = tmp_path / "trace_h000.jsonl"
    good = {"ev": "meta", "v": 1, "pid": 0, "start_unix": 1.0, "args": {}}
    path.write_text(json.dumps(good) + "\n" + '{"ev": "span", "na')
    events = export.load_events(path)
    assert events == [good]


def test_merge_orders_across_hosts(tmp_path):
    # host 1 started 2 seconds after host 0; its local ts=0 events must
    # land at +2s on the merged axis
    h0 = tmp_path / obs.log_name(0)
    h1 = tmp_path / obs.log_name(1)
    h0.write_text("\n".join(json.dumps(e) for e in [
        {"ev": "meta", "v": 1, "pid": 0, "start_unix": 1000.0, "args": {}},
        {"ev": "span", "pid": 0, "tid": 1, "name": "a", "cat": "t",
         "ts": 0.0, "dur": 5.0},
        {"ev": "span", "pid": 0, "tid": 1, "name": "c", "cat": "t",
         "ts": 3.0e6, "dur": 5.0},
    ]) + "\n")
    h1.write_text("\n".join(json.dumps(e) for e in [
        {"ev": "meta", "v": 1, "pid": 1, "start_unix": 1002.0, "args": {}},
        {"ev": "span", "pid": 1, "tid": 1, "name": "b", "cat": "t",
         "ts": 0.0, "dur": 5.0},
    ]) + "\n")
    metas, events = export.merge_events([h0, h1])
    assert [m["pid"] for m in metas] == [0, 1]
    assert [e["name"] for e in events] == ["a", "b", "c"]
    assert events[1]["ts_abs"] == pytest.approx(2.0e6)


def test_chrome_trace_structure(tmp_path):
    tr = obs.Tracer(path=tmp_path / obs.log_name(0), process=0,
                    meta={"devices": 1})
    with tr.span("round", cat="runtime"):
        pass
    tr.counter("edges_remaining", 9)
    tr.close()
    trace = export.chrome_trace([tr.path])
    evs = trace["traceEvents"]
    assert {e["ph"] for e in evs} >= {"M", "X", "C"}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["name"] == "round" and x["dur"] >= 0
    names = [e for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert names[0]["args"]["name"] == "host0"
    # Perfetto requires valid JSON — the dict must serialize cleanly
    json.dumps(trace)


def test_write_chrome_trace_accepts_run_dir(tmp_path):
    tr = obs.Tracer(path=tmp_path / "trace" / obs.log_name(0))
    with tr.span("x"):
        pass
    tr.close()
    out = tmp_path / "merged.json"
    trace = export.write_chrome_trace(out, tmp_path)
    assert out.exists()
    assert json.loads(out.read_text()) == json.loads(json.dumps(trace))


def test_torch_profile_noop():
    with export.torch_profile(None) as on:
        assert on is False
    with export.torch_profile("/tmp/x", enabled=False) as on:
        assert on is False


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    """Enabled, the window profiles its block with torch.profiler and
    writes the profile's Chrome trace into ``logdir``."""
    import torch

    with export.torch_profile(tmp_path / "prof") as on:
        assert on is True
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = (tmp_path / "prof").glob("torch_trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# report + legacy timing
# ---------------------------------------------------------------------------

def _fake_run(tmp_path, hosts=2, rounds=4):
    for h in range(hosts):
        tr = obs.Tracer(path=tmp_path / obs.log_name(h), process=h,
                        meta={"process_id": h, "num_processes": hosts})
        with tr.span("ingest", cat="runtime"):
            pass
        for _ in range(rounds):
            with tr.span("round", cat="runtime"):
                tr.add("sync_payload_bytes", 1024)
        tr.close()


def test_summarize_run(tmp_path):
    _fake_run(tmp_path, hosts=2, rounds=4)
    rep = report.summarize_run(tmp_path)
    assert sorted(rep["hosts"]) == [0, 1]
    for h in rep["hosts"].values():
        assert h["peak_rss_kb"] and h["peak_rss_kb"] > 0
    assert rep["rounds"]["count"] == 8  # 4 rounds x 2 hosts
    for k in ("p50_s", "p90_s", "p99_s", "max_s"):
        assert rep["rounds"][k] >= 0
    assert "ingest" in rep["phases"]
    assert rep["counters"]["sync_payload_bytes"]["max"] == 4 * 1024
    text = report.render(rep)
    assert "rounds: 8" in text and "sync_payload_bytes" in text


def test_summarize_run_requires_logs(tmp_path):
    with pytest.raises(FileNotFoundError):
        report.summarize_run(tmp_path)


def test_summarize_run_zero_completed_rounds(tmp_path):
    """A run killed before its first round completes must still report:
    null round percentiles, count 0 — never a numpy empty-reduction
    crash."""
    tr = obs.Tracer(path=tmp_path / obs.log_name(0), process=0,
                    meta={"process_id": 0})
    with tr.span("ingest", cat="runtime"):
        pass
    tr.close()   # no "round" spans at all
    rep = report.summarize_run(tmp_path)
    assert rep["rounds"]["count"] == 0
    for k in ("mean_s", "p50_s", "p90_s", "p99_s", "max_s"):
        assert rep["rounds"][k] is None
    text = report.render(rep)           # must not raise either
    assert "rounds:" not in text        # the empty row is omitted
    json.dumps(rep)


def test_report_cli_zero_rounds_exits_zero(tmp_path):
    tr = obs.Tracer(path=tmp_path / obs.log_name(0), process=0)
    tr.close()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.report_run",
         str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "run summary" in proc.stdout


def test_merge_skips_metaless_log_with_warning(tmp_path):
    """A host killed before its first flush leaves a log with no meta
    anchor — the merge must keep the other hosts and warn, not fail
   ."""
    good = tmp_path / obs.log_name(0)
    good.write_text("\n".join(json.dumps(e) for e in [
        {"ev": "meta", "v": 1, "pid": 0, "start_unix": 1000.0, "args": {}},
        {"ev": "span", "pid": 0, "tid": 1, "name": "a", "cat": "t",
         "ts": 0.0, "dur": 5.0},
    ]) + "\n")
    orphan = tmp_path / obs.log_name(1)
    orphan.write_text(json.dumps(
        {"ev": "span", "pid": 1, "tid": 1, "name": "b", "cat": "t",
         "ts": 0.0, "dur": 5.0}) + "\n")
    with pytest.warns(UserWarning, match="no meta anchor"):
        metas, events = export.merge_events([good, orphan])
    assert [m["pid"] for m in metas] == [0]
    assert [e["name"] for e in events] == ["a"]   # orphan's span skipped


def test_summarize_run_includes_live_section(tmp_path):
    """A run that also published live metrics gets them summarized in
    the same report (shared schema conventions)."""
    from repro_torch.obs import live

    _fake_run(tmp_path, hosts=1, rounds=2)
    bus = live.LiveBus(tmp_path / "live", process=0)
    bus.publish(phase="round", round=1, edges_remaining=5, rf=1.2)
    bus.publish(phase="done", round=1, edges_remaining=0, rf=1.3,
                done=True)
    bus.close()
    rep = report.summarize_run(tmp_path)
    assert rep["live"]["hosts"][0]["done"] is True
    assert rep["live"]["hosts"][0]["rf"] == 1.3
    assert rep["live"]["hosts"][0]["snapshots"] == 2
    assert "live bus" in report.render(rep)


def test_legacy_timing_schema():
    tr = obs.Tracer(meta={"process_id": 0, "num_processes": 2,
                          "devices": 8})
    with tr.span("ingest", cat="runtime"):
        pass
    durs = []
    for _ in range(3):
        with tr.span("round", cat="runtime"):
            tr.add("sync_payload_bytes", 10)
    timing = report.legacy_timing(tr, {"rounds": 3, "resume_round": 1})
    assert timing["process_id"] == 0
    assert timing["num_processes"] == 2 and timing["devices"] == 8
    assert timing["ingest_secs"] >= 0
    assert len(timing["round_secs"]) == 3
    assert all(s >= 0 for s in timing["round_secs"])
    assert timing["sync_payload_bytes"] == 30
    assert timing["rounds"] == 3 and timing["resume_round"] == 1
    assert isinstance(timing["start_unix"], float)
    json.dumps(timing)  # must be directly serializable (timing.json)


def test_report_script_cli(tmp_path):
    _fake_run(tmp_path, hosts=1, rounds=2)
    out_json = tmp_path / "rep.json"
    out_trace = tmp_path / "chrome.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.report_run",
         str(tmp_path), "--json", str(out_json),
         "--trace", str(out_trace)],
        capture_output=True, text=True, timeout=120, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "run summary" in proc.stdout
    rep = json.loads(out_json.read_text())
    assert rep["rounds"]["count"] == 2
    assert json.loads(out_trace.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# rss + jax-free import
# ---------------------------------------------------------------------------

def test_rss_helpers():
    hwm, cur = rss.vm_hwm_kb(), rss.vm_rss_kb()
    assert hwm >= 0 and cur >= 0
    peak = rss.peak_rss_kb()
    assert peak > 0
    assert peak >= max(hwm, 0)


def test_obs_importable_without_torch():
    """The obs package — trace, rss, export, report, live, monitor — and
    the sharded finalize import without torch (and without jax or the
    reference package): the report and monitor CLIs run on machines with
    no accelerator stack."""
    code = ("import sys; "
            "import repro_torch.obs, repro_torch.obs.trace, "
            "repro_torch.obs.rss, repro_torch.obs.export, "
            "repro_torch.obs.report, repro_torch.obs.live, "
            "repro_torch.obs.monitor; "
            "import repro_torch.runtime.finalize; "
            "import repro_torch.runtime.multihost; "
            "import repro_torch.tools.report_run, "
            "repro_torch.tools.monitor_run; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_rss_numpy_free():
    """repro_torch.obs.rss must not even pull numpy."""
    code = ("import sys; import repro_torch.obs.rss; "
            "assert 'numpy' not in sys.modules, 'rss import pulled numpy'; "
            "assert 'torch' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the same logs through both packages
# ---------------------------------------------------------------------------

def test_export_reads_logs_as_the_reference_does(tmp_path):
    """One run's logs merge to the same events and Chrome trace in both
    packages, the port's logs and the reference's alike."""
    from repro.obs import export as jexport
    from repro.obs import trace as jobs

    _fake_run(tmp_path / "port", hosts=3, rounds=4)
    for h in range(2):
        tr = jobs.Tracer(path=tmp_path / "ref" / jobs.log_name(h),
                         process=h, meta={"process_id": h})
        with tr.span("round", cat="runtime", round=1):
            tr.counter("edges_remaining", 9)
        tr.close()
    for run in ("port", "ref"):
        logs = export.host_logs(tmp_path / run)
        assert logs == jexport.host_logs(tmp_path / run) and logs
        assert export.merge_events(logs) == jexport.merge_events(logs)
        assert export.chrome_trace(logs) == jexport.chrome_trace(logs)


def test_report_reads_logs_as_the_reference_does(tmp_path):
    """summarize_run, render and legacy_timing give the reference's
    dicts and text on the same run directory and tracer."""
    from repro.obs import live as jlive
    from repro.obs import report as jreport

    _fake_run(tmp_path, hosts=2, rounds=5)
    bus = jlive.LiveBus(tmp_path / "live", process=0)
    bus.publish(phase="done", round=5, edges_remaining=0, rf=1.25,
                done=True)
    bus.close()
    got, want = report.summarize_run(tmp_path), jreport.summarize_run(
        tmp_path)
    assert got == want
    assert report.render(got) == jreport.render(want)
    tr = obs.Tracer(meta={"process_id": 1})
    with tr.span("ingest", cat="runtime"):
        with tr.span("round", cat="runtime"):
            tr.add("sync_payload_bytes", 7)
    extra = {"rounds": 1}
    assert report.legacy_timing(tr, extra) == jreport.legacy_timing(tr,
                                                                    extra)


def _env() -> dict:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env
