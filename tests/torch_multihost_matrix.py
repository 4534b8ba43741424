"""The failure matrix of multi-controller runs, for
tests/test_torch_multihost_2.py and tests/test_torch_multihost_4.py.

The port's twin of tests/spmd/run_multihost_checks.py.  Every run goes
through ``python -m repro_torch.tools.launch_multihost --device cpu``
with N gloo ranks (one shard a rank, so N devices) on a scale-10 RMAT
canonical EdgeFile:

  A. a traced run with the live bus, a monitor attached while it runs;
  B. rank 1 killed after round k's snapshot is published (exit 17), the
     monitor's verdict on the dead bus STALLED (4);
  C. B resumed: the same bits, from round k;
  D. rank 1 killed between staging its shard and the publish;
  E. D resumed: the torn round k skipped, from round k - 1;
  F. the single-writer spmd driver at world 1 resumes A's snapshots;
  G. REPRO_FORBID_EDGE_PART_MATERIALIZE set, --artifact-out, no --out;
  H. B's snapshots resumed at the other world size (2 <-> 4) through
     the store-backed reshard (the reference's H and I in one, since a
     rank is a device here).

The reference is the JAX package's ``PartitionDriver`` in spmd mode on N
forced host devices (it equals its ``partition_spmd``), run in a
subprocess: this file run as a script.  A second subprocess resumes the
port's round-k multi-writer snapshot with the reference's driver.  This
module imports nothing of jax or ``repro`` outside that script mode.

    python tests/torch_multihost_matrix.py reference EDGEFILE N OUT
    python tests/torch_multihost_matrix.py resume EDGEFILE N SNAP K OUT
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
GRAPH = (10, 8, 3)                       # RMAT scale, edge factor, seed
KW = dict(num_partitions=8, seed=0, k_sel=64, edge_chunk=1 << 10)
FIELDS = ("edge_part", "vparts", "edges_per_part", "rounds", "leftover")
LAUNCH_TIMEOUT_S = 600                   # the launcher's own deadline
EXIT_FAULT = 17
EXIT_STALLED = 4
KEEP_ALL = "100000"


def _env(extra=None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("REPRO_TRACE", None)
    env.pop("REPRO_LIVE_METRICS", None)
    env.update(extra or {})
    return env


def _launch_args(td: Path, name: str, procs: int, extra: list,
                 with_out: bool) -> list:
    args = [sys.executable, "-m", "repro_torch.tools.launch_multihost",
            "--edgefile", str(td / "c.edges"), "--device", "cpu",
            "--partitions", str(KW["num_partitions"]),
            "--seed", str(KW["seed"]), "--k-sel", str(KW["k_sel"]),
            "--edge-chunk", str(KW["edge_chunk"]),
            "--num-processes", str(procs), "--keep", KEEP_ALL,
            "--log-dir", str(td / f"logs_{name}"),
            "--timeout", str(LAUNCH_TIMEOUT_S), *extra]
    if with_out:
        args += ["--out", str(td / f"out_{name}")]
    return args


def launch(td: Path, name: str, procs: int, extra: list,
           expect_fail: bool = False, env_extra=None) -> int:
    """One launcher run to its end; returns its exit code."""
    proc = subprocess.run(
        _launch_args(td, name, procs, extra, not expect_fail),
        capture_output=True, text=True, env=_env(env_extra),
        timeout=LAUNCH_TIMEOUT_S + 120)
    if not expect_fail and proc.returncode != 0:
        raise RuntimeError(f"run {name} failed rc={proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.returncode


def load(td: Path, name: str):
    out = td / f"out_{name}"
    res = dict(np.load(out / "result.npz"))
    return res, json.loads((out / "timing.json").read_text())


def same(res: dict, ref: dict) -> bool:
    return all(np.array_equal(np.asarray(res[f]), np.asarray(ref[f]))
               for f in FIELDS)


def same_tree(a: Path, b: Path, skip=()) -> bool:
    """Two directories hold the same files with the same bytes."""
    def files(d):
        return sorted(p.relative_to(d) for p in d.rglob("*")
                      if p.is_file() and p.relative_to(d).parts[0]
                      not in skip)
    fa, fb = files(a), files(b)
    return bool(fa) and fa == fb and all(
        (a / f).read_bytes() == (b / f).read_bytes() for f in fa)


def published(snap: Path) -> list:
    return sorted(int(p.name.split("_")[1]) for p in snap.glob("step_*"))


def _monitor_cli(bus: Path, *flags) -> int:
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.tools.monitor_run", str(bus),
         "--once", *flags], capture_output=True, text=True, env=_env(),
        timeout=120).returncode


def _reference(args: list, td: Path, name: str) -> subprocess.Popen:
    """This file as a script, ``args[2]`` (the device count) forced."""
    env = _env({"JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": f"--xla_force_host_platform_device_count="
                             f"{args[2]}"})
    return subprocess.Popen(
        [sys.executable, __file__, *args],
        stdout=subprocess.DEVNULL, stderr=open(td / f"{name}.err", "w"),
        env=env, cwd=str(ROOT))


def _wait(proc: subprocess.Popen, td: Path, name: str) -> None:
    proc.wait(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed rc={proc.returncode}:\n"
                           f"{(td / f'{name}.err').read_text()[-4000:]}")


def run_matrix(td: Path, procs: int) -> dict:
    """Every case of the matrix at ``procs`` ranks in ``td``; returns the
    checks' values by name (and ``ref``, the reference's result)."""
    import torch_spmd_ranks
    from repro_torch import io as tio
    from repro_torch.core import partitioner as tp
    from repro_torch.core.metrics import evaluate
    from repro_torch.dist import compat
    from repro_torch.graphs.rmat import rmat
    from repro_torch.obs import export, monitor, report
    from repro_torch.runtime import PartitionDriver

    alt = 4 if procs == 2 else 2
    edges = rmat(*GRAPH, device="cpu").edges.numpy()
    ef = tio.write_edgefile(td / "c.edges", edges,
                            num_vertices=1 << GRAPH[0], block_size=1 << 10,
                            flags=tio.FLAG_CANONICAL)
    ref_proc = _reference(["reference", str(td / "c.edges"), str(procs),
                           str(td / "ref")], td, "ref")
    out: dict = {}
    cfg = tp.NEConfig(**KW)

    # A: traced, with the live bus, a monitor attached while it runs
    live_a = td / "liveA"
    proc_a = subprocess.Popen(
        _launch_args(td, "A", procs, [
            "--snapshot-dir", str(td / "snapA"), "--snapshot-every", "1",
            "--trace-dir", str(td / "traceA"),
            "--metrics-dir", str(live_a)], True),
        stdout=subprocess.DEVNULL, stderr=open(td / "A.err", "w"),
        env=_env())
    mon = monitor.BusMonitor(live_a, monitor.MonitorConfig(
        stall_after=1e9, dead_after=1e9))
    seen: dict = {}      # rank -> the largest heartbeat seq seen live
    live_rc = None       # monitor_run --once, attached mid-run
    deadline = time.time() + LAUNCH_TIMEOUT_S
    while proc_a.poll() is None:
        if time.time() > deadline:
            proc_a.kill()
            raise RuntimeError("run A timed out")
        mon.poll()
        for pid, t in mon.tails.items():
            if t.last is not None:
                seen[pid] = max(seen.get(pid, 0), int(t.last.get("seq") or 0))
        if live_rc is None and len(seen) == procs:
            live_rc = _monitor_cli(live_a, "--json", "--stall-after", "1e9",
                                   "--dead-after", "1e9")
        time.sleep(0.05)
    if proc_a.returncode != 0:
        raise RuntimeError(f"run A failed rc={proc_a.returncode}:\n"
                           f"{(td / 'A.err').read_text()[-4000:]}")
    mon.poll()
    if live_rc is None:      # the run ended before every rank was seen
        live_rc = _monitor_cli(live_a, "--json", "--stall-after", "1e9",
                               "--dead-after", "1e9")
    final_live = mon.assess()
    res_a, timing_a = load(td, "A")
    out["res_a"] = res_a
    out["timing_a"] = timing_a
    out["monitor_hosts_ok"] = bool(
        len(final_live["hosts"]) == procs
        and all(h["done"] for h in final_live["hosts"].values())
        and len(seen) == procs and all(v >= 1 for v in seen.values()))
    out["monitor_rounds_monotone"] = bool(mon.tails and all(
        t.rounds_monotone() and len(t.rounds_seen) >= 1
        for t in mon.tails.values()))
    last_rfs = [t.history[-1]["rf"] for t in mon.tails.values()
                if t.history]
    out["monitor_rf_matches_final"] = bool(
        len(last_rfs) == procs and all(
            abs(rf - timing_a["replication_factor"]) < 1e-6
            for rf in last_rfs))
    out["monitor_live_exit"] = live_rc == 0
    logs = export.host_logs(td / "traceA")
    out["trace_logs"] = logs
    out["trace_per_host_logs"] = len(logs) == procs
    trace = export.write_chrome_trace(td / "traceA_merged.json",
                                      td / "traceA")
    evs = trace["traceEvents"]
    out["trace_chrome_valid"] = bool(
        len({e["pid"] for e in evs}) == procs
        and any(e["ph"] == "X" and e["name"] == "round" for e in evs)
        and any(e["ph"] == "X" and e["name"] == "ingest" for e in evs)
        and any(e["ph"] == "X" and e["name"] == "exchange_write"
                for e in evs))
    rep = report.summarize_run(td / "traceA")
    out["report"] = rep
    out["report_fields_ok"] = bool(
        rep["rounds"]["count"] == int(res_a["rounds"]) * procs
        and 0 <= rep["rounds"]["p50_s"] <= rep["rounds"]["p99_s"]
        and {"ingest", "finalize", "snapshot"} <= set(rep["phases"])
        and rep["counters"]["sync_payload_bytes"]["last"] > 0
        and all(h.get("peak_rss_kb") for h in rep["hosts"].values()))
    out["live_dir"] = live_a

    # the port's partition_spmd at world N on the same EdgeFile
    out["port_spmd"] = compat.spawn(torch_spmd_ranks.partition_spmd_file,
                                    procs, "gloo", str(td / "c.edges"),
                                    cfg)[0]
    k = max(int(res_a["rounds"]) // 2, 1)
    out["kill_round"] = k

    # B, D, G side by side
    with ThreadPoolExecutor(3) as pool:
        fut_b = pool.submit(launch, td, "B", procs, [
            "--snapshot-dir", str(td / "snapB"), "--snapshot-every", "1",
            "--die-round", str(k), "--die-stage", "after-publish",
            "--die-process", "1", "--metrics-dir", str(td / "liveB")],
            expect_fail=True)
        fut_d = pool.submit(launch, td, "D", procs, [
            "--snapshot-dir", str(td / "snapD"), "--snapshot-every", "1",
            "--die-round", str(k), "--die-stage", "after-shards",
            "--die-process", "1"], expect_fail=True)
        fut_g = pool.submit(launch, td, "G", procs, [
            "--snapshot-dir", str(td / "snapG"),
            "--artifact-out", str(td / "art_mh")], expect_fail=True,
            env_extra={"REPRO_FORBID_EDGE_PART_MATERIALIZE": "1"})
        out["kill_rc"] = fut_b.result()
        out["torn_rc"] = fut_d.result()
        out["forbid_rc"] = fut_g.result()
    out["kill_published"] = published(td / "snapB")
    out["torn_published"] = published(td / "snapD")
    out["monitor_kill_rc"] = _monitor_cli(td / "liveB", "--stall-after",
                                          "0.05", "--dead-after", "1e18")

    # the reference's driver resumes a copy of B's round-k snapshot
    shutil.copytree(td / "snapB" / f"step_{k:010d}",
                    td / "snapB_ref" / f"step_{k:010d}")
    res_proc = _reference(["resume", str(td / "c.edges"), str(procs),
                           str(td / "snapB_ref"), str(k),
                           str(td / "ref_resumed.pkl")], td, "ref_resume")

    # C, E, H side by side; F in this process meanwhile
    with ThreadPoolExecutor(3) as pool:
        fut_c = pool.submit(launch, td, "C", procs, [
            "--snapshot-dir", str(td / "snapB"), "--resume"])
        fut_e = pool.submit(launch, td, "E", procs, [
            "--snapshot-dir", str(td / "snapD"), "--resume"])
        fut_h = pool.submit(launch, td, "H", alt, [
            "--snapshot-dir", str(td / "snapB"), "--resume",
            "--exchange-dir", str(td / "exchangeH")])
        with compat.world1("gloo"):
            drv = PartitionDriver.resume(ef, cfg, td / "snapA",
                                         device="cpu")
            res_f = drv.run()
            out["res_f"] = {f: np.asarray(getattr(res_f, f))
                            for f in FIELDS}
        for fut in (fut_c, fut_e, fut_h):
            fut.result()
    for name in ("C", "E", "H"):
        out[f"res_{name.lower()}"], out[f"timing_{name.lower()}"] = \
            load(td, name)

    _wait(ref_proc, td, "ref")
    _wait(res_proc, td, "ref_resume")
    with open(td / "ref" / "result.pkl", "rb") as f:
        out["ref"] = pickle.load(f)
    with open(td / "ref_resumed.pkl", "rb") as f:
        out["ref_resumed"] = pickle.load(f)
    st = evaluate(edges, out["ref"]["edge_part"], 1 << GRAPH[0],
                  KW["num_partitions"])
    out["ref_stats"] = st
    out["artifact_bit_identical"] = same_tree(td / "ref" / "art",
                                              td / "art_mh")
    out["snapshots_bit_identical"] = same_tree(
        td / "ref" / "snap", td / "snapA", skip=("exchange",))
    ef.close()
    return out


# ---------------------------------------------------------------------------
# the reference, in a subprocess with N forced host devices
# ---------------------------------------------------------------------------

def _jax_config():
    from repro.core import partitioner as jp

    return jp.NEConfig(use_pallas=True, **KW)


def _result(res) -> dict:
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def reference(ef_path: str, devices: int, out: str) -> None:
    """The reference driver at ``devices`` devices: snapshots every
    round, the result and the single-writer artifact."""
    from repro.io.edgefile import EdgeFile
    from repro.runtime import PartitionDriver

    drv = PartitionDriver(EdgeFile(ef_path), _jax_config(),
                          num_devices=devices,
                          snapshot_dir=os.path.join(out, "snap"),
                          snapshot_every=1, keep=int(KEEP_ALL))
    res = _result(drv.run())
    drv.save_artifact(os.path.join(out, "art"))
    with open(os.path.join(out, "result.pkl"), "wb") as f:
        pickle.dump(res, f)


def reference_resume(ef_path: str, devices: int, snap: str, k: int,
                     out: str) -> None:
    """The reference driver resumes the port's round-k snapshot."""
    from repro.io.edgefile import EdgeFile
    from repro.runtime import PartitionDriver

    drv = PartitionDriver.resume(EdgeFile(ef_path), _jax_config(), snap,
                                 round_k=k, num_devices=devices)
    assert drv.rounds == k, drv.rounds
    with open(out, "wb") as f:
        pickle.dump(_result(drv.run()), f)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1] == "reference":
        reference(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        reference_resume(sys.argv[2], int(sys.argv[3]), sys.argv[4],
                         int(sys.argv[5]), sys.argv[6])
