"""Partition-serving HTTP host: one process, one partition group.

A copy of the reference package's ``serve/server.py``, speaking its
protocol.  ``python -m repro_torch.serve.server --artifact DIR --group G
--num-groups W`` loads the artifact's partitions ``{p : p % W == G}``
into a :class:`~repro_torch.serve.store.ShardStore`, wraps it in a
:class:`~repro_torch.serve.service.PartitionService`, and serves a tiny
JSON protocol over stdlib ``ThreadingHTTPServer``:

* ``POST /query`` — body ``{"op": ..., "v": ...}`` with ops
  ``neighbors`` / ``degree`` / ``khop`` (``k``) / ``feature`` /
  ``ppr`` (``alpha``, ``eps``); replies ``{"ok": true, ...}``.
* ``GET /health``  — ``{"ok": true, "group": G, "partitions": [...]}``
  once the store is loaded (the gang launcher polls this for ready).
* ``GET /stats``   — the service's full stats snapshot as JSON.
* ``GET /metrics`` — Prometheus text
  (:func:`~repro_torch.serve.service.render_serve_prometheus`).

Numpy + stdlib only — a serving host imports neither torch nor jax, so
gang members start in milliseconds and run anywhere the monitor runs.
Heartbeats: when ``REPRO_LIVE_METRICS`` is set, a daemon thread
publishes qps/p99/cache-hit/fan-out to the live bus every
``--heartbeat-s`` so ``python -m repro_torch.tools.monitor_run`` (and
its ``--serve`` Prometheus endpoint) watch the gang like any
partitioning run.

The batcher sits between handler threads and the store: concurrent
requests collect until deadline-or-batch-size and execute grouped
(``repro_torch.serve.batch``).  Single-inflight clients see at most one
deadline of added latency; concurrent Zipf traffic shares decodes.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs import live
from repro_torch.serve.service import PartitionService, render_serve_prometheus
from repro_torch.serve.store import ShardStore


def group_partitions(num_partitions: int, group: int,
                     num_groups: int) -> list[int]:
    """The partition group served by gang member ``group`` — round
    robin, so groups stay balanced for any P/W split."""
    if not 0 <= group < num_groups:
        raise ValueError(f"group {group} out of range [0, {num_groups})")
    return [p for p in range(num_partitions) if p % num_groups == group]


class ServeHandler(BaseHTTPRequestHandler):
    """Request handler bound to a service via the server instance."""

    server: "ServeServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):      # stderr chatter off; the
        pass                                # metrics are the log

    def _reply(self, obj, code: int = 200, raw: bytes | None = None,
               ctype: str = "application/json") -> None:
        body = raw if raw is not None else json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                                       # noqa: N802
        svc = self.server.service
        if self.path == "/health":
            self._reply({"ok": True, "group": self.server.group,
                         "partitions": svc.store.partitions})
        elif self.path == "/stats":
            self._reply({"ok": True, "stats": svc.stats()})
        elif self.path == "/metrics":
            text = render_serve_prometheus(svc.stats(), self.server.group)
            self._reply(None, raw=text.encode(),
                        ctype="text/plain; version=0.0.4")
        else:
            self._reply({"ok": False, "error": "not found"}, code=404)

    def do_POST(self):                                      # noqa: N802
        if self.path != "/query":
            self._reply({"ok": False, "error": "not found"}, code=404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n))
            self._reply(self.server.handle_query(req))
        except Exception as e:  # noqa: BLE001 — protocol boundary
            self._reply({"ok": False, "error": f"{type(e).__name__}: {e}"},
                        code=400)


class ServeServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, service: PartitionService, group: int = 0):
        self.service = service
        self.group = group
        super().__init__(addr, ServeHandler)

    def handle_query(self, req: dict) -> dict:
        svc = self.service
        op = req.get("op")
        v = int(req.get("v", -1))
        if op == "neighbors":
            nb = svc.neighbors_batched(v)
            return {"ok": True, "neighbors": nb.tolist(),
                    "fanout": len(svc.store.owned_partitions_of(v))}
        if op == "degree":
            return {"ok": True, "degree": svc.degree(v)}
        if op == "khop":
            out = svc.k_hop(v, int(req.get("k", 1)))
            return {"ok": True, "vertices": out.tolist()}
        if op == "feature":
            return {"ok": True, "feature": svc.feature(v).tolist()}
        if op == "ppr":
            mass = svc.ppr(v, alpha=float(req.get("alpha", 0.15)),
                           eps=float(req.get("eps", 1e-4)))
            return {"ok": True,
                    "ppr": {str(k): val for k, val in mass.items()}}
        raise ValueError(f"unknown op {op!r}")


def _heartbeat_loop(service: PartitionService, period_s: float,
                    stop: threading.Event) -> None:
    while not stop.wait(period_s):
        service.publish_heartbeat()


def make_server(artifact, partitions=None, port: int = 0,
                group: int = 0, cache_entries=None, batch=None,
                deadline_s=None) -> ServeServer:
    """Build a ready-to-run server (ephemeral port when ``port=0``) —
    the in-process entry the tests and benches use."""
    store = ShardStore(artifact, partitions=partitions,
                       cache_entries=cache_entries)
    service = PartitionService(store, batch=batch, deadline_s=deadline_s)
    return ServeServer(("127.0.0.1", port), service, group=group)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve one partition group of a partition artifact")
    ap.add_argument("--artifact", required=True,
                    help="partition artifact directory (manifest.json)")
    ap.add_argument("--group", type=int, default=0,
                    help="this host's partition group index")
    ap.add_argument("--num-groups", type=int, default=1,
                    help="gang size (partitions are striped round-robin)")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, printed on stdout)")
    ap.add_argument("--cache", type=int, default=None,
                    help="decoded-shard LRU entries "
                         "(default REPRO_SERVE_CACHE or 64; 0 disables)")
    ap.add_argument("--batch", type=int, default=None,
                    help="request batch size (default REPRO_SERVE_BATCH; "
                         "0 disables batching)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="batch flush deadline "
                         "(default REPRO_SERVE_DEADLINE_MS or 2.0)")
    ap.add_argument("--heartbeat-s", type=float, default=2.0,
                    help="live-bus heartbeat period")
    args = ap.parse_args(argv)

    from repro_torch.runtime.artifact import load_artifact
    art = load_artifact(args.artifact)
    parts = group_partitions(art.num_partitions, args.group,
                             args.num_groups)
    srv = make_server(
        art, partitions=parts, port=args.port, group=args.group,
        cache_entries=args.cache, batch=args.batch,
        deadline_s=(None if args.deadline_ms is None
                    else args.deadline_ms / 1000.0))
    live.from_env(process=args.group,
                  meta={"role": "serve", "num_groups": args.num_groups})
    stop = threading.Event()
    hb = threading.Thread(
        target=_heartbeat_loop, args=(srv.service, args.heartbeat_s, stop),
        daemon=True, name="serve-heartbeat")
    hb.start()
    # the gang launcher parses this line to learn the bound port
    print(f"SERVE ready group={args.group} port={srv.server_address[1]} "
          f"partitions={','.join(map(str, parts))}", flush=True)
    try:
        srv.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        srv.service.close()
        st = srv.service.stats()
        live.publish(phase="serve", round=srv.service._hb_seq + 1,
                     qps=st["qps"], p99_ms=st["p99_ms"],
                     cache_hit=st["cache"]["hit_ratio"],
                     fanout=st["fanout_mean"], done=True)
        live.disable()
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["ServeHandler", "ServeServer", "group_partitions",
           "main", "make_server"]
