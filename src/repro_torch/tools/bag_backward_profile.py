"""Profile ``embedding_bag_backward`` at DeepFM's two train calls.

    PYTHONPATH=src python src/repro_torch/tools/bag_backward_profile.py
        [--reps N]

draws DeepFM's train_batch ids (B 65,536 bags, one id a field in each of
the 39 fields' 2^20 rows, seed 0) and a float32 ``grad_out``, and for the
table gradient (V = 39 · 2^20, D 10) and w1's (D 1) times one call with
CUDA events (the mean of ``--reps`` calls after a warm-up) and profiles
``--reps`` calls with torch.profiler: each kernel's device time a call,
by name (the sort's, its index fill and cast, the backward's own).  It
prints one JSON line a shape, with the card's name.  The script needs
only the package on ``PYTHONPATH``, so that two checkouts can be
profiled in one call, each with its own ``src``:

    PYTHONPATH=other/src python src/repro_torch/tools/bag_backward_profile.py
"""
from __future__ import annotations

import argparse
import json

import torch

B, FIELDS, ROWS = 65_536, 39, 1 << 20       # configs/deepfm.py, train_batch


def short(name: str) -> str:
    """A kernel's demangled name without its result type, its anonymous
    namespace and its argument list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name.endswith(")"):
            name = name[:i]
            break
    return name.removeprefix("void ").replace("(anonymous namespace)::",
                                              "").strip()


def kernels(fn, reps: int) -> dict:
    """{kernel: [ms a call, instances a call]} over ``reps`` profiled calls
    after a warm-up call (the count rounded: the profiler can drop an
    instance)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.count:
            k = max(1, round(e.count / reps))
            out[e.key] = [k * e.self_device_time_total / e.count / 1e3, k]
    return out


def event_ms(fn, reps: int) -> float:
    """Mean ms a call by CUDA events, after a warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    from repro_torch.kernels.embedding_bag import ops as eb

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bag_backward_profile: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, ROWS, (B, FIELDS), generator=gen, device=dev,
                      dtype=torch.int32)
    ids = x + torch.arange(FIELDS, dtype=torch.int32, device=dev) * ROWS
    for name, d in (("table", 10), ("w1", 1)):
        table = torch.empty((FIELDS * ROWS, d), device=dev)
        g = torch.randn((B, d), generator=gen, device=dev)

        def call():
            return eb.embedding_bag_backward(table, ids, None, g)

        per = kernels(call, args.reps)
        print(json.dumps({
            "shape": name, "v": FIELDS * ROWS, "d": d, "b": B, "k": FIELDS,
            "device": torch.cuda.get_device_name(0),
            "ms": event_ms(call, args.reps),
            "device_ms": sum(t for t, _ in per.values()),
            "kernels": {short(k): v for k, v in per.items()}}),
            flush=True)
        del table, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
