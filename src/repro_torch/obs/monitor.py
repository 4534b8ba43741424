"""Stall/straggler monitor over the live metrics bus.

A copy of the reference package's ``obs/monitor.py`` (the same verdicts,
exit codes and Prometheus names).  Reads the per-host
``metrics_h*.jsonl`` streams :mod:`repro_torch.obs.live`
publishes and turns them into an operational verdict: is the run
healthy, done, stalled, or dead — and which hosts are dragging.  Pure
reader: it never writes into the run directory, so attaching a monitor
cannot perturb the run (the bit-identity contract belongs to the
publishing side).

Detection semantics:

* **stalled host** — heartbeat age (now − last snapshot ``t_unix``)
  exceeds ``stall_after``.  The publishers emit one snapshot per round,
  so the threshold should be a few round latencies; the CLI default is
  deliberately generous (rounds compile on first step).
* **dead run** — every host is silent past ``dead_after``, or no host
  ever published.  Distinct from *stalled* (one wedged host while peers
  heartbeat — in a gang-scheduled SPMD run the peers block on the next
  collective, so a single stall flips the run stalled almost at once).
* **straggler host** — round index lags the front-runner by more than
  ``straggler_rounds``, or its round-latency EWMA exceeds
  ``latency_outlier`` × the across-host median.  Stragglers are
  advisory (the run is still making progress); stalls gate exit codes.
* **done** — every host's last snapshot carries ``done: true`` (the
  driver's finalize epilogue publishes it).

ETA comes from per-host EWMAs: edges_remaining drain rate per round ×
round-latency EWMA, reported for the slowest host.  Everything here is
standard library (no torch, no numpy): the monitor must run on a login
node or sidecar container with nothing but a Python and the store
mount.
"""
from __future__ import annotations

import dataclasses
import json
import time

from repro_torch.obs import live

EXIT_HEALTHY = 0
EXIT_STALLED = 4
EXIT_DEAD = 5


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    stall_after: float = 15.0       # s of heartbeat silence → host stalled
    dead_after: float = 120.0       # s of *all-host* silence → run dead
    straggler_rounds: int = 2       # rounds behind the front-runner
    latency_outlier: float = 3.0    # × median round-latency EWMA
    ewma_alpha: float = 0.3         # smoothing for latency / drain rates


class HostTail:
    """Incremental reader of one host's metrics stream.

    Holds a byte offset and folds each newly-completed snapshot into the
    host's rolling view (last heartbeat, round-latency EWMA, drain-rate
    EWMA).  Torn/partial trailing lines are left pending by
    :func:`repro_torch.obs.live.tail_snapshots`, so a publisher killed
    mid-append just stops advancing this tail.
    """

    def __init__(self, path, pid: int, alpha: float = 0.3):
        self.path = path
        self.pid = pid
        self.alpha = alpha
        self.offset = 0
        self.meta: dict | None = None
        self.last: dict | None = None   # most recent hb snapshot
        self.start_unix: float | None = None
        self.lat_ewma: float | None = None    # s per round
        self.drain_ewma: float | None = None  # edges allocated per round
        self.rounds_seen: list[int] = []      # round-phase indices, in order
        self.history: list[dict] = []         # (round, rf) quality trajectory

    def poll(self) -> int:
        """Consume newly-appended snapshots; returns how many were new."""
        events, self.offset = live.tail_snapshots(self.path, self.offset)
        for ev in events:
            self._fold(ev)
        return len(events)

    def _fold(self, ev: dict):
        kind = ev.get("ev")
        if kind == "meta":
            self.meta = ev
            self.start_unix = ev.get("t_unix")
            return
        if kind != "hb":
            return
        prev = self.last
        self.last = ev
        if ev.get("phase") != "round":
            return
        self.rounds_seen.append(ev.get("round") or 0)
        if ev.get("rf") is not None:
            self.history.append({"round": ev.get("round"),
                                 "rf": ev.get("rf"),
                                 "eb": ev.get("eb"),
                                 "boundary": ev.get("boundary")})
        if prev is None or prev.get("round") is None \
                or ev.get("round") is None:
            return
        dr = ev["round"] - prev["round"]
        dt = ev["t_unix"] - prev["t_unix"]
        if dr > 0 and dt >= 0:
            lat = dt / dr
            self.lat_ewma = (lat if self.lat_ewma is None else
                             self.alpha * lat
                             + (1 - self.alpha) * self.lat_ewma)
        er, pr = ev.get("edges_remaining"), prev.get("edges_remaining")
        if dr > 0 and er is not None and pr is not None and pr >= er:
            rate = (pr - er) / dr
            self.drain_ewma = (rate if self.drain_ewma is None else
                               self.alpha * rate
                               + (1 - self.alpha) * self.drain_ewma)

    # -- derived views ------------------------------------------------------

    def heartbeat_age(self, now: float) -> float | None:
        if self.last is not None:
            return now - self.last["t_unix"]
        if self.start_unix is not None:
            return now - self.start_unix
        return None

    @property
    def round(self) -> int:
        if self.last is None or self.last.get("round") is None:
            return 0
        return int(self.last["round"])

    @property
    def done(self) -> bool:
        return bool(self.last and self.last.get("done"))

    def rounds_monotone(self) -> bool:
        """Strictly increasing round indices — the progress sanity the
        multihost integration checks assert."""
        return all(b > a for a, b in zip(self.rounds_seen,
                                         self.rounds_seen[1:]))

    def eta_s(self) -> float | None:
        """Seconds to drain edges_remaining at the current EWMA rates."""
        if (self.last is None or self.done or self.lat_ewma is None
                or not self.drain_ewma):
            return None
        rem = self.last.get("edges_remaining")
        if rem is None:
            return None
        return (rem / self.drain_ewma) * self.lat_ewma


class BusMonitor:
    """All-host view over a bus directory: poll, assess, render."""

    def __init__(self, bus_dir, cfg: MonitorConfig | None = None):
        self.dir = bus_dir
        self.cfg = cfg or MonitorConfig()
        self.tails: dict[int, HostTail] = {}
        self.manifest: dict | None = None

    def _discover(self):
        for path in live.host_metrics(self.dir):
            pid = int(str(path.name)[len("metrics_h"):-len(".jsonl")])
            if pid not in self.tails:
                self.tails[pid] = HostTail(path, pid,
                                           alpha=self.cfg.ewma_alpha)
        if self.manifest is None:
            self.manifest = live.read_manifest(self.dir)

    def poll(self) -> int:
        """Discover hosts and consume new snapshots; returns new count."""
        self._discover()
        return sum(t.poll() for t in self.tails.values())

    def assess(self, now: float | None = None) -> dict:
        """One status dict: per-host rows + the overall verdict.

        Does not poll — call :meth:`poll` first (split so tests can
        assess a frozen bus at a chosen ``now``).
        """
        now = time.time() if now is None else now
        cfg = self.cfg
        hosts = {}
        max_round = max((t.round for t in self.tails.values()), default=0)
        lats = sorted(t.lat_ewma for t in self.tails.values()
                      if t.lat_ewma is not None)
        # lower-middle median: with few hosts (CI runs 2) the upper
        # element IS the outlier, which would mask itself
        med_lat = lats[(len(lats) - 1) // 2] if lats else None
        for pid, t in sorted(self.tails.items()):
            age = t.heartbeat_age(now)
            if t.done:
                status = "done"
            elif age is None or age > cfg.stall_after:
                status = "stalled"
            else:
                status = "ok"
            straggler = (not t.done) and (
                t.round < max_round - cfg.straggler_rounds
                or (t.lat_ewma is not None and med_lat
                    and t.lat_ewma > cfg.latency_outlier * med_lat))
            last = t.last or {}
            hosts[pid] = {
                "round": t.round,
                "phase": last.get("phase"),
                "heartbeat_age_s": age,
                "status": status,
                "straggler": bool(straggler),
                "monotone": t.rounds_monotone(),
                "round_latency_s": t.lat_ewma,
                "eta_s": t.eta_s(),
                "edges_remaining": last.get("edges_remaining"),
                "sync_payload_bytes": last.get("sync_payload_bytes"),
                "rss_kb": last.get("rss_kb"),
                "rss_peak_kb": last.get("rss_peak_kb"),
                "rf": last.get("rf"),
                "eb": last.get("eb"),
                "vb": last.get("vb"),
                "boundary": last.get("boundary"),
                "done": t.done,
                # serving gauges (schema v2, phase "serve"); None on
                # partitioning runs and v1 streams
                "qps": last.get("qps"),
                "p99_ms": last.get("p99_ms"),
                "cache_hit": last.get("cache_hit"),
                "fanout": last.get("fanout"),
            }
        if not hosts:
            overall = "dead"
        elif all(h["done"] for h in hosts.values()):
            overall = "done"
        elif all(h["status"] == "stalled"
                 and (h["heartbeat_age_s"] is None
                      or h["heartbeat_age_s"] > cfg.dead_after)
                 for h in hosts.values() if not h["done"]):
            overall = "dead"
        elif any(h["status"] == "stalled" for h in hosts.values()):
            overall = "stalled"
        else:
            overall = "healthy"
        etas = [h["eta_s"] for h in hosts.values() if h["eta_s"]]
        return {
            "overall": overall,
            "now_unix": now,
            "hosts": hosts,
            "max_round": max_round,
            "stragglers": sorted(p for p, h in hosts.items()
                                 if h["straggler"]),
            "eta_s": max(etas) if etas else None,
            "manifest": self.manifest,
            "quality": self._quality_trajectory(),
        }

    def _quality_trajectory(self, keep: int = 12) -> list[dict]:
        """The run-wide quality trajectory: host 0's history (the gauges
        are computed from replicated state, so every host publishes the
        same values), thinned to the last ``keep`` points."""
        t = self.tails.get(min(self.tails, default=0))
        if t is None or not t.history:
            return []
        hist = t.history
        if len(hist) > keep:
            stride = max(1, len(hist) // keep)
            hist = hist[::stride][-keep + 1:] + [hist[-1]]
        return hist

    @staticmethod
    def exit_code(status: dict) -> int:
        if status["overall"] in ("healthy", "done"):
            return EXIT_HEALTHY
        if status["overall"] == "dead":
            return EXIT_DEAD
        return EXIT_STALLED


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_age(age: float | None) -> str:
    if age is None:
        return "—"
    if age < 120:
        return f"{age:5.1f}s"
    return f"{age / 60:5.1f}m"


def _fmt_eta(eta: float | None) -> str:
    if eta is None:
        return "—"
    if eta < 90:
        return f"{eta:.0f}s"
    return f"{eta / 60:.1f}m"


def _spark(values: list[float]) -> str:
    blocks = "▁▂▃▄▅▆▇█"
    if not values:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(blocks[int((v - lo) / span * (len(blocks) - 1))]
                   for v in values)


def render_dashboard(status: dict) -> str:
    """The terminal dashboard: one header, one row per host, one
    quality-trajectory footer.  Plain text so it survives CI logs and
    artifact upload."""
    lines = []
    mf = status.get("manifest") or {}
    head = f"run: {mf.get('edgefile', '?')}  P={mf.get('partitions', '?')}"
    lines.append(head)
    badge = status["overall"].upper()
    eta = _fmt_eta(status.get("eta_s"))
    lines.append(f"status: {badge}   round: {status['max_round']}"
                 f"   eta: {eta}")
    lines.append("")
    lines.append(" host  round  phase    beat   lat/round      rem"
                 "   rss(MB)     rf  flags")
    for pid, h in sorted(status["hosts"].items()):
        lat = (f"{h['round_latency_s']:.2f}s"
               if h["round_latency_s"] is not None else "—")
        rem = (f"{h['edges_remaining']:,}"
               if h["edges_remaining"] is not None else "—")
        rssmb = (f"{h['rss_kb'] / 1024:.0f}"
                 if h["rss_kb"] is not None else "—")
        rf = f"{h['rf']:.3f}" if h["rf"] is not None else "—"
        flags = []
        if h["status"] == "stalled":
            flags.append("STALL")
        if h["straggler"]:
            flags.append("STRAGGLER")
        if h["done"]:
            flags.append("done")
        if not h["monotone"]:
            flags.append("NONMONOTONE")
        lines.append(f" h{pid:03d}  {h['round']:5d}  {h['phase'] or '—':<7}"
                     f"  {_fmt_age(h['heartbeat_age_s'])}  {lat:>9}"
                     f"  {rem:>9}  {rssmb:>7}  {rf:>6}"
                     f"  {' '.join(flags)}")
    traj = status.get("quality") or []
    if traj:
        rfs = [q["rf"] for q in traj if q.get("rf") is not None]
        if rfs:
            lines.append("")
            lines.append(f" rf trajectory  {_spark(rfs)}  "
                         f"{rfs[0]:.3f} → {rfs[-1]:.3f}")
        bnd = [q["boundary"] for q in traj if q.get("boundary") is not None]
        if bnd:
            lines.append(f" boundary set   {_spark([float(b) for b in bnd])}"
                         f"  {bnd[0]:,} → {bnd[-1]:,}")
    if status["stragglers"]:
        lines.append("")
        lines.append(" stragglers: "
                     + ", ".join(f"h{p:03d}" for p in status["stragglers"]))
    return "\n".join(lines) + "\n"


_STATUS_CODE = {"healthy": 0, "done": 1, "stalled": 2, "dead": 3}

# (metric, type, help) — gauge values come from the assess() host rows
_PROM_HOST = (
    ("repro_host_round", "round", "Last completed round"),
    ("repro_host_heartbeat_age_seconds", "heartbeat_age_s",
     "Seconds since the host's last snapshot"),
    ("repro_host_round_latency_seconds", "round_latency_s",
     "EWMA of per-round wall time"),
    ("repro_host_rss_kilobytes", "rss_kb", "Resident set size"),
    ("repro_host_rss_peak_kilobytes", "rss_peak_kb", "Peak RSS (VmHWM)"),
)


def render_prometheus(status: dict) -> str:
    """Prometheus text-format exposition of one assessment.

    Gauges only — the bus is already a time series; scrapes sample it.
    ``repro_run_status`` encodes the verdict
    (0 healthy / 1 done / 2 stalled / 3 dead) so alerts key off one
    number.
    """
    out = []

    def emit(name, help_, samples, kind="gauge"):
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {kind}")
        out.extend(samples)

    hosts = status["hosts"]
    for name, field, help_ in _PROM_HOST:
        emit(name, help_,
             [f'{name}{{host="{p}"}} {h[field]}'
              for p, h in sorted(hosts.items()) if h[field] is not None])
    emit("repro_host_up", "1 when the host heartbeats within stall_after",
         [f'repro_host_up{{host="{p}"}} '
          f'{1 if h["status"] == "ok" or h["done"] else 0}'
          for p, h in sorted(hosts.items())])
    emit("repro_host_done", "1 when the host published its done snapshot",
         [f'repro_host_done{{host="{p}"}} {1 if h["done"] else 0}'
          for p, h in sorted(hosts.items())])
    emit("repro_host_straggler", "1 when flagged as a straggler",
         [f'repro_host_straggler{{host="{p}"}} {1 if h["straggler"] else 0}'
          for p, h in sorted(hosts.items())])

    rem = [h["edges_remaining"] for h in hosts.values()
           if h["edges_remaining"] is not None]
    if rem:
        emit("repro_edges_remaining", "Unallocated edges (global gauge)",
             [f"repro_edges_remaining {min(rem)}"])
    sync = [h["sync_payload_bytes"] for h in hosts.values()
            if h["sync_payload_bytes"] is not None]
    if sync:
        emit("repro_sync_payload_bytes_total",
             "Cumulative per-device SyncVertexAllocations payload",
             [f"repro_sync_payload_bytes_total {max(sync)}"], "counter")
    for name, field, help_ in (
            ("repro_replication_factor", "rf",
             "Live replication factor (paper Eq. 1)"),
            ("repro_edge_balance", "eb", "Live max/mean edge balance"),
            ("repro_vertex_balance", "vb", "Live max/mean vertex balance"),
            ("repro_boundary_vertices", "boundary",
             "Replicated vertices with unallocated degree")):
        vals = [h[field] for _, h in sorted(hosts.items())
                if h[field] is not None]
        if vals:
            emit(name, help_, [f"{name} {vals[0]}"])
    # serving-gang gauges (bus schema v2, phase "serve") — per host,
    # since each gang member serves a different partition group
    for name, field, help_ in (
            ("repro_serve_qps", "qps", "Queries/s served by the host"),
            ("repro_serve_p99_ms", "p99_ms", "p99 query latency"),
            ("repro_serve_cache_hit_ratio", "cache_hit",
             "Decoded-shard LRU hit ratio"),
            ("repro_serve_fanout_mean", "fanout",
             "Mean partitions touched per query (≤ replica count)")):
        samples = [f'{name}{{host="{p}"}} {h[field]}'
                   for p, h in sorted(hosts.items())
                   if h[field] is not None]
        if samples:
            emit(name, help_, samples)
    emit("repro_run_status",
         "0 healthy / 1 done / 2 stalled / 3 dead",
         [f"repro_run_status {_STATUS_CODE[status['overall']]}"])
    emit("repro_max_round", "Front-runner round index",
         [f"repro_max_round {status['max_round']}"])
    return "\n".join(out) + "\n"


def render_json(status: dict) -> str:
    return json.dumps(status, indent=2, sort_keys=True, default=str)


__all__ = ["EXIT_DEAD", "EXIT_HEALTHY", "EXIT_STALLED", "BusMonitor",
           "HostTail", "MonitorConfig", "render_dashboard", "render_json",
           "render_prometheus"]
