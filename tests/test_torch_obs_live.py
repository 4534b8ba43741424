"""The port's live metrics bus and monitor (``repro_torch.obs.live`` /
``.monitor``) against the reference package's.

Mirrors tests/test_obs_live.py test for test on the port's modules: the
append-only per-rank streams with torn-tail-tolerant tailing, the fixed
snapshot schema, the stall/straggler/dead thresholds and the monitor
CLI's exit codes (``python -m repro_torch.tools.monitor_run``).  The
last tests hold the port's monitor to the reference's on the same
streams.  A monitor attached to a live gang, and killed gangs, are in
tests/test_torch_multihost_{2,4}.py.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.obs import live
from repro_torch.obs import monitor as mon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_global_bus():
    """Each test starts and ends with the module-level bus disabled."""
    live.disable()
    yield
    live.disable()


def _bus(tmp_path, pid=0, **kw):
    return live.LiveBus(tmp_path, process=pid, **kw)


# ---------------------------------------------------------------------------
# bus: schema, front door, manifest
# ---------------------------------------------------------------------------

def test_publish_schema_fixed(tmp_path):
    b = _bus(tmp_path)
    ev = b.publish(phase="round", round=1, edges_remaining=10, rf=1.25)
    b.close()
    # every schema field present, even unreported ones (as null)
    for k in live.SNAPSHOT_FIELDS:
        assert k in ev
    assert ev["seq"] == 1 and ev["pid"] == 0
    assert ev["v"] == live.SCHEMA_VERSION
    assert ev["rss_kb"] > 0          # auto-filled from obs.rss
    assert ev["done"] is False
    snaps = live.load_snapshots(b.path)
    assert snaps[0]["ev"] == "meta"
    assert snaps[1] == json.loads(json.dumps(ev))


def test_publish_rejects_unknown_fields(tmp_path):
    b = _bus(tmp_path)
    with pytest.raises(TypeError, match="unknown snapshot fields"):
        b.publish(phase="round", bogus=1)
    b.close()


def test_seq_increments_per_snapshot(tmp_path):
    b = _bus(tmp_path)
    seqs = [b.publish(phase="round", round=i)["seq"] for i in range(1, 5)]
    b.close()
    assert seqs == [1, 2, 3, 4]


def test_disabled_module_api_is_noop(tmp_path):
    assert live.get_bus() is None and not live.live_enabled()
    live.publish(phase="round", round=1)  # must not raise or write
    assert live.host_metrics(tmp_path) == []


def test_configure_disable_roundtrip(tmp_path):
    b = live.configure(tmp_path, process=2)
    assert live.get_bus() is b and live.live_enabled()
    live.publish(phase="round", round=1)
    live.disable()
    assert not live.live_enabled()
    path = tmp_path / live.metrics_name(2)
    assert path.exists()
    assert len(live.load_snapshots(path)) == 2  # meta + 1 hb


def test_from_env_semantics(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_LIVE_METRICS", raising=False)
    assert live.from_env(tmp_path) is None
    monkeypatch.setenv("REPRO_LIVE_METRICS", "0")
    assert live.from_env(tmp_path) is None
    monkeypatch.setenv("REPRO_LIVE_METRICS", "1")
    assert live.from_env(None) is None            # no default dir known
    b = live.from_env(tmp_path / "a")
    assert b is not None and b.dir == tmp_path / "a"
    monkeypatch.setenv("REPRO_LIVE_METRICS", str(tmp_path / "b"))
    b2 = live.from_env(tmp_path / "a")
    assert b2.dir == tmp_path / "b"               # explicit dir wins


def test_manifest_published_atomically(tmp_path):
    b = _bus(tmp_path, manifest={"partitions": 8})
    b.close()
    mf = live.read_manifest(tmp_path)
    assert mf["partitions"] == 8 and mf["v"] == live.SCHEMA_VERSION
    # no stray staging files left behind
    assert not list(tmp_path.glob(".tmp_*"))


def test_host_metrics_searches_subdir(tmp_path):
    sub = tmp_path / "live"
    b = live.LiveBus(sub, process=1)
    b.close()
    assert live.host_metrics(tmp_path) == [sub / live.metrics_name(1)]


# ---------------------------------------------------------------------------
# tailing: torn lines, kill mid-append, attach-before-first-snapshot
# ---------------------------------------------------------------------------

def test_tail_ignores_torn_last_line(tmp_path):
    b = _bus(tmp_path)
    b.publish(phase="round", round=1)
    b.close()
    with open(b.path, "a") as f:
        f.write('{"ev": "hb", "pid": 0, "ro')   # torn: no newline
    events, off = live.tail_snapshots(b.path, 0)
    assert [e["ev"] for e in events] == ["meta", "hb"]
    # the offset stops at the last complete line; the torn tail stays
    # pending and is re-read if the publisher ever completes it
    with open(b.path, "a") as f:
        f.write('und": 2}\n')
    more, off2 = live.tail_snapshots(b.path, off)
    assert len(more) == 1 and more[0]["round"] == 2
    assert off2 > off


def test_tail_publisher_killed_mid_append(tmp_path):
    """A publisher SIGKILLed mid-write leaves a forever-torn tail; the
    reader must keep serving every complete snapshot and never advance
    past the tear."""
    b = _bus(tmp_path)
    b.publish(phase="round", round=1, edges_remaining=50)
    b.close()
    with open(b.path, "a") as f:
        f.write('{"ev": "hb", "pid": 0, "seq": 99, "t_unix"')  # killed here
    t = mon.HostTail(b.path, 0)
    t.poll()
    assert t.round == 1 and t.last["edges_remaining"] == 50
    # repeated polls are stable: no progress, no crash, no re-reads
    off = t.offset
    assert t.poll() == 0 and t.offset == off


def test_tail_skips_complete_but_corrupt_line(tmp_path):
    b = _bus(tmp_path)
    b.publish(phase="round", round=1)
    b.close()
    with open(b.path, "a") as f:
        f.write("not json at all\n")
    b2 = live.LiveBus(tmp_path, process=0)  # fresh stream overwrites
    b2.close()
    events, _ = live.tail_snapshots(b.path, 0)
    assert all(isinstance(e, dict) for e in events)


def test_monitor_attach_before_first_snapshot(tmp_path):
    """A monitor pointed at a run dir before any worker published must
    report dead (nothing there), then pick the hosts up on later polls
    without restarting."""
    bm = mon.BusMonitor(tmp_path)
    bm.poll()
    st = bm.assess()
    assert st["overall"] == "dead" and st["hosts"] == {}
    assert mon.BusMonitor.exit_code(st) == mon.EXIT_DEAD
    # worker appears: meta line only, no snapshot yet → ok (fresh beat)
    b = _bus(tmp_path)
    bm.poll()
    st = bm.assess()
    assert st["overall"] == "healthy"
    assert st["hosts"][0]["round"] == 0
    # snapshots start flowing through the same monitor instance
    b.publish(phase="round", round=1)
    b.close()
    bm.poll()
    assert bm.assess()["hosts"][0]["round"] == 1


# ---------------------------------------------------------------------------
# stall / dead / straggler semantics
# ---------------------------------------------------------------------------

def _publish_rounds(tmp_path, pid, rounds, t0=1000.0, dt=1.0, rem0=100,
                    done=False):
    """Hand-written stream with controlled timestamps (no sleeps)."""
    path = tmp_path / live.metrics_name(pid)
    lines = [{"ev": "meta", "v": 1, "pid": pid, "t_unix": t0, "args": {}}]
    for i in range(1, rounds + 1):
        lines.append({"ev": "hb", "v": 1, "pid": pid, "seq": i,
                      "t_unix": t0 + i * dt, "phase": "round", "round": i,
                      "edges_remaining": max(rem0 - 10 * i, 0),
                      "sync_payload_bytes": 100 * i, "rss_kb": 1000,
                      "rss_peak_kb": 1000, "rf": 1.0 + 0.01 * i, "eb": 1.1,
                      "vb": 1.2, "boundary": 5, "done": False})
    if done:
        lines.append({"ev": "hb", "v": 1, "pid": pid, "seq": rounds + 1,
                      "t_unix": t0 + (rounds + 1) * dt, "phase": "done",
                      "round": rounds, "edges_remaining": 0,
                      "sync_payload_bytes": 0, "rss_kb": 1000,
                      "rss_peak_kb": 1000, "rf": 1.5, "eb": 1.1, "vb": 1.2,
                      "boundary": 0, "done": True})
    path.write_text("".join(json.dumps(e) + "\n" for e in lines))
    return t0 + (rounds + (1 if done else 0)) * dt


def test_stall_threshold_edges(tmp_path):
    end = _publish_rounds(tmp_path, 0, rounds=3, dt=1.0)
    cfg = mon.MonitorConfig(stall_after=5.0, dead_after=1000.0)
    bm = mon.BusMonitor(tmp_path, cfg)
    bm.poll()
    # age exactly at the threshold is NOT stalled (strict >)
    st = bm.assess(now=end + 5.0)
    assert st["hosts"][0]["status"] == "ok" and st["overall"] == "healthy"
    st = bm.assess(now=end + 5.01)
    assert st["hosts"][0]["status"] == "stalled"
    assert st["overall"] == "stalled"
    assert mon.BusMonitor.exit_code(st) == mon.EXIT_STALLED


def test_dead_when_all_hosts_silent(tmp_path):
    end0 = _publish_rounds(tmp_path, 0, rounds=3)
    end1 = _publish_rounds(tmp_path, 1, rounds=3)
    cfg = mon.MonitorConfig(stall_after=5.0, dead_after=60.0)
    bm = mon.BusMonitor(tmp_path, cfg)
    bm.poll()
    end = max(end0, end1)
    # both stalled but within dead_after → stalled, not dead
    st = bm.assess(now=end + 30.0)
    assert st["overall"] == "stalled"
    st = bm.assess(now=end + 61.0)
    assert st["overall"] == "dead"
    assert mon.BusMonitor.exit_code(st) == mon.EXIT_DEAD


def test_one_stalled_host_flags_run_stalled(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=8)       # silent after t0+8
    end1 = _publish_rounds(tmp_path, 1, rounds=38)  # beats until t0+38
    bm = mon.BusMonitor(tmp_path,
                        mon.MonitorConfig(stall_after=5.0, dead_after=500.0))
    bm.poll()
    st = bm.assess(now=end1 + 1.0)
    assert st["hosts"][0]["status"] == "stalled"
    assert st["hosts"][1]["status"] == "ok"
    assert st["overall"] == "stalled"


def test_done_run_is_done_regardless_of_age(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=3, done=True)
    bm = mon.BusMonitor(tmp_path, mon.MonitorConfig(stall_after=1.0))
    bm.poll()
    st = bm.assess(now=99999.0)   # hours later
    assert st["overall"] == "done"
    assert mon.BusMonitor.exit_code(st) == mon.EXIT_HEALTHY


def test_straggler_round_lag(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=10, dt=0.1)
    _publish_rounds(tmp_path, 1, rounds=7, dt=0.1)   # 3 behind
    cfg = mon.MonitorConfig(stall_after=1e9, straggler_rounds=2)
    bm = mon.BusMonitor(tmp_path, cfg)
    bm.poll()
    st = bm.assess(now=1002.0)
    assert st["stragglers"] == [1]
    assert not st["hosts"][0]["straggler"]
    # exactly at the lag threshold is NOT a straggler (strict >)
    bm2 = mon.BusMonitor(tmp_path,
                         mon.MonitorConfig(stall_after=1e9,
                                           straggler_rounds=3))
    bm2.poll()
    assert bm2.assess(now=1002.0)["stragglers"] == []


def test_straggler_latency_outlier(tmp_path):
    # same round index, but host 1's rounds take 10× longer
    _publish_rounds(tmp_path, 0, rounds=6, dt=0.1)
    _publish_rounds(tmp_path, 1, rounds=6, dt=1.0)
    cfg = mon.MonitorConfig(stall_after=1e9, straggler_rounds=99,
                            latency_outlier=3.0)
    bm = mon.BusMonitor(tmp_path, cfg)
    bm.poll()
    st = bm.assess(now=1010.0)
    assert st["stragglers"] == [1]
    assert st["hosts"][1]["round_latency_s"] == pytest.approx(1.0)


def test_rounds_monotone_detection(tmp_path):
    path = tmp_path / live.metrics_name(0)
    evs = [{"ev": "meta", "v": 1, "pid": 0, "t_unix": 0.0, "args": {}}]
    for i, r in enumerate([1, 2, 2, 3]):   # repeated round 2
        evs.append({"ev": "hb", "v": 1, "pid": 0, "seq": i + 1,
                    "t_unix": float(i), "phase": "round", "round": r,
                    "edges_remaining": 0, "sync_payload_bytes": 0,
                    "rss_kb": 1, "rss_peak_kb": 1, "rf": 1.0, "eb": 1.0,
                    "vb": 1.0, "boundary": 0, "done": False})
    path.write_text("".join(json.dumps(e) + "\n" for e in evs))
    t = mon.HostTail(path, 0)
    t.poll()
    assert not t.rounds_monotone()


def test_eta_from_ewmas(tmp_path):
    # 10 edges drained per round, 1s per round, 70 remaining → ~7s
    _publish_rounds(tmp_path, 0, rounds=3, dt=1.0, rem0=100)
    bm = mon.BusMonitor(tmp_path, mon.MonitorConfig(stall_after=1e9))
    bm.poll()
    st = bm.assess(now=1003.0)
    assert st["eta_s"] == pytest.approx(7.0, rel=0.01)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def test_dashboard_renders_flags_and_trajectory(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=5, done=True)
    _publish_rounds(tmp_path, 1, rounds=2)
    bm = mon.BusMonitor(tmp_path,
                        mon.MonitorConfig(stall_after=5.0, dead_after=1e9,
                                          straggler_rounds=1))
    bm.poll()
    text = mon.render_dashboard(bm.assess(now=1100.0))
    assert "h000" in text and "h001" in text
    assert "STALL" in text and "done" in text
    assert "rf trajectory" in text


def test_prometheus_exposition(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=4)
    bm = mon.BusMonitor(tmp_path, mon.MonitorConfig(stall_after=1e9))
    bm.poll()
    text = mon.render_prometheus(bm.assess(now=1005.0))
    assert 'repro_host_round{host="0"} 4' in text
    assert "repro_run_status 0" in text
    assert "repro_replication_factor" in text
    assert "repro_edges_remaining 60" in text
    assert "# TYPE repro_host_round gauge" in text
    # every sample line parses as "name{labels} value" or "name value"
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, _, value = line.rpartition(" ")
        float(value)


# ---------------------------------------------------------------------------
# CLI + import hygiene
# ---------------------------------------------------------------------------

def _run_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.monitor_run", *args],
        capture_output=True, text=True, timeout=120, env=env)


def test_cli_once_done_run(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=3, done=True)
    proc = _run_cli([str(tmp_path), "--once"])
    assert proc.returncode == mon.EXIT_HEALTHY, proc.stderr[-2000:]
    assert "DONE" in proc.stdout


def test_cli_once_stalled_and_dead(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=2)
    proc = _run_cli([str(tmp_path), "--once", "--stall-after", "0.001",
                     "--dead-after", "1e18", "--json"])
    assert proc.returncode == mon.EXIT_STALLED
    assert json.loads(proc.stdout)["overall"] == "stalled"
    proc = _run_cli([str(tmp_path), "--once", "--stall-after", "0.001",
                     "--dead-after", "0.001"])
    assert proc.returncode == mon.EXIT_DEAD


def test_cli_once_empty_dir_is_dead(tmp_path):
    proc = _run_cli([str(tmp_path), "--once"])
    assert proc.returncode == mon.EXIT_DEAD


def test_live_importable_without_torch_or_numpy():
    """The bus publishes from inside the round loop and the monitor runs
    on store-mount-only sidecars: neither may pull torch or numpy (the
    monitor CLI must start fast on a login node)."""
    code = ("import sys; import repro_torch.obs.live, "
            "repro_torch.obs.monitor, repro_torch.tools.monitor_run; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the same streams through both packages
# ---------------------------------------------------------------------------

def _streams(tmp_path):
    _publish_rounds(tmp_path, 0, rounds=9, dt=0.1, done=True)
    _publish_rounds(tmp_path, 1, rounds=6, dt=1.0)
    _publish_rounds(tmp_path, 2, rounds=3, dt=0.5)


@pytest.mark.parametrize("now", [1001.0, 1004.5, 1010.0, 5000.0])
def test_monitor_verdicts_equal_reference(tmp_path, now):
    """assess, the dashboard, the Prometheus text and the exit code are
    the reference's on the same streams, at several ages."""
    from repro.obs import monitor as jmon

    _streams(tmp_path)
    kw = dict(stall_after=5.0, dead_after=100.0, straggler_rounds=2)
    a = mon.BusMonitor(tmp_path, mon.MonitorConfig(**kw))
    b = jmon.BusMonitor(tmp_path, jmon.MonitorConfig(**kw))
    a.poll()
    b.poll()
    sa, sb = a.assess(now=now), b.assess(now=now)
    assert sa == sb
    assert mon.render_dashboard(sa) == jmon.render_dashboard(sb)
    assert mon.render_prometheus(sa) == jmon.render_prometheus(sb)
    assert mon.BusMonitor.exit_code(sa) == jmon.BusMonitor.exit_code(sb)
    assert (mon.EXIT_HEALTHY, mon.EXIT_STALLED, mon.EXIT_DEAD) \
        == (jmon.EXIT_HEALTHY, jmon.EXIT_STALLED, jmon.EXIT_DEAD)


def test_monitor_reads_reference_bus(tmp_path):
    """The port's monitor reads a stream the reference's bus wrote, and
    the reference's monitor one the port's bus wrote, to equal views."""
    from repro.obs import live as jlive
    from repro.obs import monitor as jmon

    for pid, bus_mod in ((0, live), (1, jlive)):
        bus = bus_mod.LiveBus(tmp_path, process=pid)
        bus.publish(phase="round", round=1, edges_remaining=9, rf=1.5)
        bus.publish(phase="done", round=1, edges_remaining=0, rf=1.5,
                    done=True)
        bus.close()
    a, b = mon.BusMonitor(tmp_path), jmon.BusMonitor(tmp_path)
    a.poll()
    b.poll()
    now = max(t.last["t_unix"] for t in a.tails.values()) + 1.0
    assert a.assess(now=now) == b.assess(now=now)
    assert a.assess(now=now)["overall"] == "done"
