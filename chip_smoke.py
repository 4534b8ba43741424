#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Distributed NE on one NVIDIA card.

    python3 chip_smoke.py                 # the full run (RMAT scale 22)
    python3 chip_smoke.py --scale 16      # a quicker rehearsal

Phases, each printing its lines; any failed check exits non-zero:

1. the device (name and power limit from nvidia-smi) and the time to
   build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (RMAT scale-22 graph, P = 64, C = 8, K = 256),
   exactly: the three kernels are integer math, so the tolerance is 0;
3. the main path: ``partition`` of the RMAT graph (edge factor 16,
   P = 64, the NEConfig defaults) on the card, with the kernel launch
   counts set to 0 just before and read just after, and its invariants;
4. ``partition`` at RMAT scale 14 on the card and on the CPU (plain
   versions), which must be bit-identical;
5. one round under torch.profiler (device time by kernel, busy share),
   the device time of the round's layers, and each kernel's time on
   inputs taken from a real round beside its plain version's, a library
   call's and the bound from the bytes it must move, as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.  There is no CPU
fallback: without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

EDGE_FACTOR = 16                   # the main path's graph: RMAT, EF 16
PARTITIONS = 64                    # P = 64; other NEConfig fields default

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
CU_SOURCE = "src/repro_torch/kernels/ne_round/csrc/ne_round.cu"
REPLACES = {
    "one_hop": "src/repro/kernels/ne_round/ne_round.py:80",
    "select": "src/repro/kernels/ne_round/ne_round.py:188",
    "claim_scatter": "src/repro/kernels/ne_round/ne_round.py:245",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0


def select_err(got, want) -> int:
    """Only valid slots feed claim_scatter: compare ``valid`` and
    ``where(valid, idx, -1)``."""
    import torch

    gi, gv = got
    wi, wv = want
    m1 = torch.where(gv, gi, torch.full_like(gi, -1))
    m2 = torch.where(wv, wi, torch.full_like(wi, -1))
    return max(max_abs_err(gv, wv), max_abs_err(m1, m2))


def phase_kernels(torch, ops, ref, g, dev, p_num, c, k_sel):
    """Phase 2: kernels against plain versions at the main path's shapes."""
    n, m = g.num_vertices, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(12)
    i32 = torch.int32
    u = g.edges[:, 0].contiguous()
    v = g.edges[:, 1].contiguous()

    # one_hop: a tenth of the vertices claimed, a third of the edges taken
    vclaim = torch.full((n,), ref.I32_INF, dtype=i32, device=dev)
    cl = torch.randint(0, n, (n // 10,), generator=gen, device=dev)
    vclaim[cl] = torch.randint(0, 1 << 20, (cl.numel(),), generator=gen,
                               device=dev, dtype=i32)
    ep = torch.where(torch.rand(m, generator=gen, device=dev) < 0.3,
                     torch.randint(0, p_num, (m,), generator=gen,
                                   device=dev, dtype=i32),
                     torch.full((m,), -1, dtype=i32, device=dev))
    mask = torch.rand(m, generator=gen, device=dev) < 0.9
    for mk in (None, mask):
        got = ops.one_hop(vclaim, u, v, ep, p_num, mask=mk)
        want = ref.one_hop_ref(vclaim, u, v, ep, p_num, mask=mk)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        check(err == 0, f"one_hop differs (mask={mk is not None}): {err}")
    print(f"phase 2: one_hop == plain at M={m}, N={n}, P={p_num} "
          "(with and without mask)", flush=True)

    # claim_scatter: half the selections crowd onto 1000 vertices
    sel_idx = torch.randint(0, n, (p_num, k_sel), generator=gen, device=dev,
                            dtype=i32)
    sel_idx[:, ::2] = torch.randint(0, 1000, (p_num, k_sel // 2),
                                    generator=gen, device=dev, dtype=i32)
    sel_valid = torch.rand((p_num, k_sel), generator=gen, device=dev) < 0.7
    epp = torch.randint(0, 1 << 20, (p_num,), generator=gen, device=dev,
                        dtype=i32)
    err = max_abs_err(ops.claim_scatter(sel_idx, sel_valid, epp, n, p_num),
                      ref.claim_scatter_ref(sel_idx, sel_valid, epp, n,
                                            p_num))
    check(err == 0, f"claim_scatter differs: {err}")
    print(f"phase 2: claim_scatter == plain at P={p_num}, K={k_sel}, N={n}",
          flush=True)

    # select: the chunk is a strided (C, N) view of an (N, P) map, as on
    # the main path
    deg = g.degree.to(i32)
    cases = {}
    vp = torch.rand((n, p_num), generator=gen, device=dev) < 0.05
    dr = torch.where(torch.rand(n, generator=gen, device=dev) < 0.3,
                     torch.zeros_like(deg), deg)
    cases["random"] = (vp, dr)
    vp = torch.rand((n, p_num), generator=gen, device=dev) < 0.02
    cases["ties"] = (vp, torch.ones_like(deg))          # every score equal
    vp = torch.zeros((n, p_num), dtype=torch.bool, device=dev)
    for col in range(c):                                 # |B| = 0 .. < K
        rows = torch.randint(0, n, (col * 37,), generator=gen, device=dev)
        vp[rows, col] = True
    cases["sparse+restart"] = (vp, deg)
    active = torch.tensor([True] * (c - 2) + [False, True], device=dev)
    remaining = torch.randint(0, 5000, (c,), generator=gen, device=dev,
                              dtype=i32)
    remaining[0] = 1 << 30
    rnd_v = torch.randint(0, n, (c,), generator=gen, device=dev)
    any_ok = torch.tensor(True, device=dev)
    for name, (vp, dr) in cases.items():
        args = (vp[:, :c].T, active, dr, 0.1, k_sel, remaining, rnd_v,
                any_ok)
        err = select_err(ops.select_topk(*args), ref.select_ref(*args))
        check(err == 0, f"select differs on case {name!r}: {err}")
        print(f"phase 2: select == plain, case {name!r}, C={c}, N={n}, "
              f"K={k_sel}", flush=True)


def phase_times(torch, tp, ops, ref, g, cfg, limit, state, reps):
    """Phase 5: kernel, plain and library times on one real round's
    inputs (the state after some rounds of the main path's run)."""
    n, m, p_num = g.num_vertices, g.num_edges, cfg.num_partitions
    from repro_torch import random as trandom

    c = min(cfg.sel_chunk, p_num)
    _, sub = trandom.split(state.key)
    keys = trandom.fold_in(sub, torch.arange(p_num, device=g.device))
    active = state.edges_per_part <= limit
    remaining = (limit - state.edges_per_part).to(torch.int32)
    rnd_v, any_ok = tp.boundary_reseed(state.degree_rest, keys[:c])
    sel_args = (state.vparts[:, :c].T, active[:c], state.degree_rest,
                cfg.lam, cfg.k_sel, remaining[:c], rnd_v, any_ok)
    claims = tp.vertex_claims(cfg, limit, state.vparts, state.degree_rest,
                              state.edges_per_part, sub)
    sel = [ops.select_topk(state.vparts[:, j:j + c].T, active[j:j + c],
                           state.degree_rest, cfg.lam, cfg.k_sel,
                           remaining[j:j + c], rnd_v, any_ok)
           for j in range(0, p_num, c)]
    sel_idx = torch.cat([s[0] for s in sel])
    sel_valid = torch.cat([s[1] for s in sel])
    u = g.edges[:, 0].contiguous()
    v = g.edges[:, 1].contiguous()
    oh_args = (claims, u, v, state.edge_part, p_num)
    cs_args = (sel_idx, sel_valid, state.edges_per_part, n, p_num)

    # the library yardsticks: one PyTorch call each, never used by the port
    bnd = (sel_args[0] & (state.degree_rest > 0)[None, :]
           & active[:c, None])
    comp = ((torch.where(bnd, state.degree_rest[None, :],
                         torch.full_like(state.degree_rest, ref.I32_INF))
             .to(torch.int64) << 32)
            | torch.arange(n, device=g.device)[None, :])
    flat_v = torch.where(sel_valid, sel_idx,
                         torch.full_like(sel_idx, n)).reshape(-1).long()
    enc = ref._enc(state.edges_per_part[:, None],
                   torch.arange(p_num, device=g.device,
                                dtype=torch.int32)[:, None], p_num)
    enc = enc.expand(p_num, cfg.k_sel).reshape(-1)
    buf = torch.full((n + 1,), ref.I32_INF, dtype=torch.int32,
                     device=g.device)

    rows = []
    bsize = int(bnd.sum())
    for name, kern, plain, lib, nbytes in (
        ("one_hop", lambda: ops.one_hop(*oh_args),
         lambda: ref.one_hop_ref(*oh_args), None,
         16 * m + 4 * n + 4 * p_num),
        ("select", lambda: ops.select_topk(*sel_args),
         lambda: ref.select_ref(*sel_args),
         lambda: torch.topk(comp, cfg.k_sel, dim=1, largest=False),
         c * n + 4 * n + 13 * c + 5 * c * cfg.k_sel),
        ("claim_scatter", lambda: ops.claim_scatter(*cs_args),
         lambda: ref.claim_scatter_ref(*cs_args),
         lambda: buf.scatter_reduce_(0, flat_v, enc, reduce="amin"),
         5 * p_num * cfg.k_sel + 4 * p_num + 4 * n),
    ):
        got, want = kern(), plain()
        err = (select_err(got, want) if name == "select"
               else max(max_abs_err(a, b) for a, b in zip(
                   got if isinstance(got, tuple) else (got,),
                   want if isinstance(want, tuple) else (want,))))
        check(err == 0, f"{name} differs on the captured round: {err}")
        rows.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": REPLACES[name],
            "max_abs_err": err,
            "ms": time_ms(kern, reps),
            "plain_ms": time_ms(plain, max(1, reps // 4)),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None if lib is None else time_ms(lib, reps),
        })
    print(f"phase 5: timed on round {int(state.rounds)}'s inputs "
          f"(chunk 0 boundary |B| = {bsize} over {c} rows)", flush=True)

    # the round's layers, each as the round runs it (device time)
    layers = {
        "restart_draws": lambda: [
            tp.boundary_reseed(state.degree_rest, keys[j:j + c])
            for j in range(0, p_num, c)],
        "vertex_claims": lambda: tp.vertex_claims(
            cfg, limit, state.vparts, state.degree_rest,
            state.edges_per_part, sub),
        "two_hop": lambda: tp._two_hop(u, v, state.edge_part, state.vparts,
                                       state.edges_per_part, cfg, limit),
    }
    spent = {k: time_ms(f, 3, warmup=1) for k, f in layers.items()}
    print("phase 5: layer ms per round: " + ", ".join(
        f"{k}={t!r}" for k, t in spent.items()), flush=True)
    return rows


def profile_round(torch, tp, g, cfg, limit, state, top: int = 12):
    """One round under torch.profiler: device time by kernel and the
    device's busy share of the round's wall time.  Runs on a copy of the
    state (the round updates its state in place)."""
    from torch.profiler import ProfilerActivity, profile

    st = tp.NEState(*(t.clone() for t in state))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tp.ne_round_step(g, cfg, limit, st)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    print(f"phase 5: profiled round {int(state.rounds)}: wall {wall_us:.0f}"
          f" us, device busy {busy:.0f} us ({100 * busy / wall_us:.1f}%)",
          flush=True)
    for e in rows[:top]:
        print(f"  {e.self_device_time_total:12.0f} us  {e.count:6d}x  "
              f"{e.key[:90]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the main run (2^scale vertices)")
    ap.add_argument("--check-scale", type=int, default=14,
                    help="RMAT scale of the card-vs-CPU identity run")
    ap.add_argument("--time-round", type=int, default=20,
                    help="round whose inputs the kernel timings use")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")

    from repro_torch.core import partitioner as tp
    from repro_torch.core.epilogue import alpha_limit
    from repro_torch.core.graph import from_edges
    from repro_torch.core.metrics import theorem1_upper_bound
    from repro_torch.graphs.rmat import rmat_edges
    from repro_torch.kernels.ne_round import build, ops, ref

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    build.load("ne_round")
    print(f"phase 1: built ne_round in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for line in build.build_logs.get("ne_round", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", file=sys.stderr)

    # the main path's graph: RMAT, Graph500 (a, b, c, d), seed 1
    t0 = time.perf_counter()
    edges = rmat_edges(args.scale, EDGE_FACTOR, seed=1)
    g = from_edges(edges, num_vertices=1 << args.scale, device=dev)
    del edges
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    n, m = g.num_vertices, g.num_edges
    print(f"phase 1: RMAT scale {args.scale} EF {EDGE_FACTOR}: "
          f"N={n} M={m} (host generation + CSR + copy {gen_s:.2f} s)",
          flush=True)

    cfg = tp.NEConfig(num_partitions=PARTITIONS).clamped(n)
    c = min(cfg.sel_chunk, cfg.num_partitions)
    phase_kernels(torch, ops, ref, g, dev, cfg.num_partitions, c, cfg.k_sel)

    # --- phase 3: the main path --------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = tp.partition(g, cfg)
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    limit = alpha_limit(cfg.alpha, m, cfg.num_partitions)
    ep = res.edge_part
    st = res.stats
    rf_bound = theorem1_upper_bound(n, m, cfg.num_partitions)
    per_round = wall / max(res.rounds, 1)
    print(f"phase 3: partition P={cfg.num_partitions}: rounds={res.rounds} "
          f"leftover={res.leftover} RF={st.replication_factor!r} "
          f"EB={st.edge_balance!r} VB={st.vertex_balance!r} "
          f"wall={wall!r} s per_round={per_round!r} s "
          f"peak_mem={peak} B launches={launches}", flush=True)
    check(bool((ep >= 0).all()), "unassigned edges")
    check(np.array_equal(res.edges_per_part,
                         np.bincount(ep, minlength=cfg.num_partitions)),
          "edges_per_part disagrees with bincount(edge_part)")
    check(int(res.edges_per_part.max()) <= limit + 1,
          f"max |E_p| {int(res.edges_per_part.max())} > limit + 1")
    check(st.replication_factor <= rf_bound,
          f"RF {st.replication_factor} > Theorem 1 bound {rf_bound}")
    check(all(launches[k] > 0 for k in launches), f"a kernel never ran: "
          f"{launches}")
    check(launches["select"] == res.rounds * -(-cfg.num_partitions // c)
          and launches["one_hop"] == res.rounds
          and launches["claim_scatter"] == res.rounds,
          f"launch counts {launches} do not match {res.rounds} rounds")

    # --- phase 4: card == CPU at a small scale ------------------------------
    small = rmat_edges(args.check_scale, EDGE_FACTOR, seed=1)
    n_small = 1 << args.check_scale
    t0 = time.perf_counter()
    r_gpu = tp.partition(from_edges(small, n_small, device=dev), cfg)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_cpu = tp.partition(from_edges(small, n_small, device="cpu"), cfg)
    t_cpu = time.perf_counter() - t0
    for f in ("edge_part", "vparts", "edges_per_part"):
        check(np.array_equal(getattr(r_gpu, f), getattr(r_cpu, f)),
              f"scale-{args.check_scale} card and CPU runs differ in {f}")
    check(r_gpu.rounds == r_cpu.rounds and r_gpu.leftover == r_cpu.leftover
          and r_gpu.stats == r_cpu.stats,
          "card and CPU runs differ in rounds, leftover or stats")
    print(f"phase 4: scale {args.check_scale} card == CPU bit for bit "
          f"(rounds={r_gpu.rounds}, card {t_gpu:.2f} s, CPU {t_cpu:.2f} s)",
          flush=True)

    # --- phase 5: kernel times on a real round's inputs ---------------------
    state = tp.ne_init_state(g, cfg)
    while int(state.rounds) < args.time_round and not tp.ne_done(state, cfg):
        state = tp.ne_round_step(g, cfg, limit, state)
    profile_round(torch, tp, g, cfg, limit, state)
    rows = phase_times(torch, tp, ops, ref, g, cfg, limit, state, args.reps)
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
