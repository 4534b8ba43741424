"""Watch a live (or finished) partitioning run's metrics bus.

Tails the per-host ``metrics_h*.jsonl`` streams the run publishes under
RUN_DIR (searched one subdirectory deep, so either the bus dir itself or
the ``--out`` dir that contains ``live/`` works) and renders a
refreshing terminal dashboard: per-host round / heartbeat age / RSS /
round-latency EWMA, the run-wide quality trajectory (replication
factor, boundary-set size), an ETA from the drain-rate and
round-latency EWMAs, plus stall and straggler flags.

Typical use, against a running multihost job::

  PYTHONPATH=src python -m repro_torch.tools.launch_multihost ... \\
      --out /tmp/run/out --metrics-dir /tmp/run/out/live &
  PYTHONPATH=src python -m repro_torch.tools.monitor_run /tmp/run/out

Exit codes map the verdict so schedulers and CI can gate on them:
0 healthy/done, 4 stalled (some host's heartbeat age exceeded
``--stall-after``), 5 dead (no metrics at all, or every host silent
past ``--dead-after``).  ``--once`` assesses and exits immediately;
watch mode keeps refreshing until the run finishes (exit 0), dies
(exit 5), or ``--timeout`` elapses (exits with the verdict at that
moment).  ``--serve :9464`` additionally exposes Prometheus text
exposition at ``/metrics`` (stdlib http.server) for scraping.

Standard library only on purpose (no torch, no numpy): it must run on
a login node or sidecar with nothing but the store mount.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", help="bus directory holding "
                    "metrics_h*.jsonl (searched one subdirectory deep)")
    ap.add_argument("--once", action="store_true",
                    help="assess once, print, exit with the verdict code")
    ap.add_argument("--json", action="store_true",
                    help="print the raw status dict instead of the "
                    "dashboard")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in watch mode (s)")
    ap.add_argument("--stall-after", type=float, default=15.0,
                    help="heartbeat age that flags a host stalled (s)")
    ap.add_argument("--dead-after", type=float, default=120.0,
                    help="all-host silence that flags the run dead (s)")
    ap.add_argument("--straggler-rounds", type=int, default=2,
                    help="round lag behind the front-runner that flags "
                    "a straggler")
    ap.add_argument("--latency-outlier", type=float, default=3.0,
                    help="round-latency EWMA multiple of the median "
                    "that flags a straggler")
    ap.add_argument("--wait", type=float, default=0.0,
                    help="grace period to wait for the first metrics "
                    "file before declaring the run dead (s)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="watch mode: give up after this long (0: never); "
                    "exits with the verdict at that moment")
    ap.add_argument("--serve", default=None, metavar="[HOST]:PORT",
                    help="serve Prometheus text exposition at /metrics "
                    "(e.g. ':9464'); implies watch mode")
    ap.add_argument("--no-clear", action="store_true",
                    help="append dashboard frames instead of clearing "
                    "the screen (CI logs, artifact capture)")
    return ap


def _serve(addr: str, state: dict):
    """Background /metrics endpoint over the latest assessment."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from repro_torch.obs import monitor as mon

    host, _, port = addr.rpartition(":")

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            status = state.get("status")
            body = (mon.render_prometheus(status) if status
                    else "# no assessment yet\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: the dashboard owns the tty
            pass

    srv = ThreadingHTTPServer((host or "0.0.0.0", int(port)), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def main(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)

    from repro_torch.obs import monitor as mon

    cfg = mon.MonitorConfig(stall_after=ns.stall_after,
                            dead_after=ns.dead_after,
                            straggler_rounds=ns.straggler_rounds,
                            latency_outlier=ns.latency_outlier)
    bm = mon.BusMonitor(ns.run_dir, cfg)

    if ns.wait > 0:
        deadline = time.time() + ns.wait
        while time.time() < deadline:
            bm.poll()
            if bm.tails:
                break
            time.sleep(min(0.2, ns.interval))

    state: dict = {}
    srv = _serve(ns.serve, state) if ns.serve else None

    def frame() -> dict:
        bm.poll()
        status = bm.assess()
        state["status"] = status
        if ns.json:
            print(json.dumps(status, indent=2, sort_keys=True, default=str))
        else:
            if not (ns.once or ns.no_clear):
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            sys.stdout.write(mon.render_dashboard(status))
            sys.stdout.flush()
        return status

    try:
        if ns.once:
            return mon.BusMonitor.exit_code(frame())
        t0 = time.time()
        while True:
            status = frame()
            if status["overall"] == "done":
                return mon.EXIT_HEALTHY
            if status["overall"] == "dead":
                return mon.EXIT_DEAD
            if ns.timeout and time.time() - t0 > ns.timeout:
                return mon.BusMonitor.exit_code(status)
            time.sleep(ns.interval)
    except KeyboardInterrupt:
        return mon.BusMonitor.exit_code(state.get("status")
                                        or {"overall": "dead"})
    finally:
        if srv is not None:
            srv.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
