"""Serving gang: one ``repro_torch.serve.server`` process per group.

A copy of the reference package's ``serve/gang.py``.  The
multi-process deployment of the serving layer, reusing the
``repro_torch.runtime.multihost`` gang rules: every member is a real OS
process launched with the same argv shape, logs go to files (never
PIPE — a chatty worker must not deadlock the babysitter), and the
first member to die takes the whole gang down (terminate, then kill
after a grace period).  Partitions stripe round-robin across members
(``repro_torch.serve.server.group_partitions``), so a gang of W hosts
holds each partition exactly once and the union of groups is the artifact.

:class:`GangClient` is the query side: it routes each vertex query via
the artifact's replica map — fanning out **only** to the gang members
whose groups hold a replica of the vertex — merges the per-partition
adjacency shares, and records the fan-out histogram.  Replication
factor is the fan-out cost made literal: a query for an interior
vertex touches one member; a boundary vertex touches exactly its
replica set, never more (asserted per query).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request
from collections import deque

import numpy as np

from repro_torch.serve.service import FanoutViolation, k_hop, ppr

GRACE_S = 5.0


class ServingGang:
    """Owns the gang's processes; use as a context manager."""

    def __init__(self, procs, ports, log_dir):
        self.procs = procs
        self.ports = ports
        self.log_dir = log_dir

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def poll_dead(self):
        """Indices of members that have exited (first death = gang
        failure, same rule as ``runtime.multihost.launch_local``)."""
        return [i for i, p in enumerate(self.procs)
                if p.poll() is not None]

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + GRACE_S
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for p in self.procs:
            if p.stdout is not None:
                p.stdout.close()


def launch_serving_gang(artifact_dir, num_groups: int, log_dir=None,
                        cache: int | None = None, batch: int | None = None,
                        timeout_s: float = 60.0,
                        extra_env: dict | None = None) -> ServingGang:
    """Spawn ``num_groups`` server processes over one artifact and wait
    until every member prints its ready line (bound port)."""
    artifact_dir = os.fspath(artifact_dir)
    if log_dir is None:
        log_dir = os.path.join(artifact_dir, "serve_logs")
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ)
    env.setdefault("PYTHONUNBUFFERED", "1")
    if extra_env:
        env.update(extra_env)
    procs, ready_paths = [], []
    for g in range(num_groups):
        argv = [sys.executable, "-m", "repro_torch.serve.server",
                "--artifact", artifact_dir, "--group", str(g),
                "--num-groups", str(num_groups)]
        if cache is not None:
            argv += ["--cache", str(cache)]
        if batch is not None:
            argv += ["--batch", str(batch)]
        log_path = os.path.join(log_dir, f"serve_{g}.log")
        ready_paths.append(log_path)
        with open(log_path, "wb") as log:
            procs.append(subprocess.Popen(
                argv, stdout=log, stderr=subprocess.STDOUT, env=env))
    gang = ServingGang(procs, ports=[None] * num_groups, log_dir=log_dir)
    try:
        _wait_ready(gang, ready_paths, timeout_s)
    except BaseException:
        gang.close()
        raise
    return gang


def _wait_ready(gang: ServingGang, log_paths, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        dead = gang.poll_dead()
        if dead:
            g = dead[0]
            with open(log_paths[g], "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            raise RuntimeError(
                f"serving gang member {g} died during startup "
                f"(exit {gang.procs[g].returncode}); log tail:\n{tail}")
        for g, path in enumerate(log_paths):
            if gang.ports[g] is not None:
                continue
            with open(path, "rb") as f:
                for line in f.read().decode(errors="replace").splitlines():
                    if line.startswith("SERVE ready"):
                        for tok in line.split():
                            if tok.startswith("port="):
                                gang.ports[g] = int(tok[5:])
        if all(p is not None for p in gang.ports):
            return
        time.sleep(0.05)
    raise TimeoutError(
        f"serving gang not ready after {timeout_s}s "
        f"(ports seen: {gang.ports})")


class GangClient:
    """Replica-map-routed client over a serving gang's HTTP members.

    Needs the artifact's replica map (pass the loaded
    ``PartitionArtifact``) to route: for vertex ``v`` it contacts only
    the members whose partition groups intersect ``v``'s replica set.
    """

    def __init__(self, artifact, ports, host: str = "127.0.0.1",
                 timeout_s: float = 30.0, latency_window: int = 4096):
        self.artifact = artifact
        self.ports = list(ports)
        self.host = host
        self.timeout_s = timeout_s
        self.num_groups = len(self.ports)
        self.fanout_hist: dict[int, int] = {}
        self._lat = deque(maxlen=latency_window)
        self.served = 0

    # -- transport ----------------------------------------------------------

    def _post(self, group: int, payload: dict) -> dict:
        req = urllib.request.Request(
            f"http://{self.host}:{self.ports[group]}/query",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            out = json.loads(resp.read())
        if not out.get("ok"):
            raise RuntimeError(f"group {group}: {out.get('error')}")
        return out

    def _get(self, group: int, path: str) -> dict:
        url = f"http://{self.host}:{self.ports[group]}{path}"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    # -- routing ------------------------------------------------------------

    def groups_of(self, v: int) -> list[int]:
        """Gang members holding a replica of ``v`` (round-robin group
        of each replica partition), deduplicated and sorted."""
        return sorted({int(p) % self.num_groups
                       for p in self.artifact.partitions_of(v)})

    def _record(self, t0: float, fanout: int, replicas: int) -> None:
        if fanout > replicas:
            raise FanoutViolation(
                f"fan-out {fanout} exceeds replica count {replicas}")
        self._lat.append((time.monotonic(), time.monotonic() - t0))
        self.fanout_hist[fanout] = self.fanout_hist.get(fanout, 0) + 1
        self.served += 1

    # -- queries ------------------------------------------------------------

    def neighbors(self, v: int) -> np.ndarray:
        """Merged adjacency of ``v`` across its replica members —
        bit-identical to a single-process service (vertex-cut
        invariant: the union over replicas is the full adjacency)."""
        t0 = time.monotonic()
        groups = self.groups_of(v)
        parts = [self._post(g, {"op": "neighbors", "v": int(v)})
                 for g in groups]
        merged = (np.unique(np.concatenate(
            [np.asarray(p["neighbors"], np.int64) for p in parts]))
            if parts else np.zeros(0, np.int64))
        self._record(t0, len(groups),
                     int(self.artifact.partitions_of(v).size))
        return merged

    def degree(self, v: int) -> int:
        return sum(self._post(g, {"op": "degree", "v": int(v)})["degree"]
                   for g in self.groups_of(v))

    def feature(self, v: int) -> np.ndarray:
        """Feature from any one replica member (features are
        replica-independent; fall back to member 0 for isolated v)."""
        groups = self.groups_of(v) or [0]
        out = self._post(groups[0], {"op": "feature", "v": int(v)})
        return np.asarray(out["feature"], np.float32)

    def k_hop(self, v: int, k: int) -> np.ndarray:
        return k_hop(self.neighbors, v, k)

    def ppr(self, v: int, alpha: float = 0.15, eps: float = 1e-4) -> dict:
        return ppr(self.neighbors, v, alpha=alpha, eps=eps)

    def health(self) -> list[dict]:
        return [self._get(g, "/health") for g in range(self.num_groups)]

    def gang_stats(self) -> list[dict]:
        return [self._get(g, "/stats")["stats"]
                for g in range(self.num_groups)]

    def stats(self) -> dict:
        lats = np.asarray([lat * 1e3 for _, lat in self._lat])
        fo = np.asarray([k for k, n in self.fanout_hist.items()
                         for _ in range(n)], np.int64)
        return {
            "served": self.served,
            "p50_ms": float(np.percentile(lats, 50)) if lats.size else None,
            "p99_ms": float(np.percentile(lats, 99)) if lats.size else None,
            "fanout_hist": dict(sorted(self.fanout_hist.items())),
            "fanout_mean": float(fo.mean()) if fo.size else 0.0,
        }


__all__ = ["GangClient", "ServingGang", "launch_serving_gang"]
