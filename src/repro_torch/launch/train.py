"""Training launcher for the LM archs, dense and MoE.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --steps 20 [--ckpt-dir ckpts] [--ckpt-every 50] [--no-resume] \
      [--full [--one-card | --rank R --world-size 256 --store-dir D]] \
      [--device cpu]

Without ``--full`` it trains the arch's smoke config at the smoke train
shape.  With ``--full`` the full config at ``train_4k``: as the
reference, on the production mesh (``launch.mesh.make_production_mesh``,
16 x 16 over a 256-rank group that each process joins as ``--rank`` of
``--world-size`` through the ``file://`` store in ``--store-dir``; it
raises off a 256-rank world), the global batch 256; with ``--one-card``
on one card, mesh-free, the batch cut to :data:`FULL_BATCH`.  The path
is the production one: ``launch.steps.make_step`` → the trainer loop
(``train.trainer.run_training``: checkpoints every ``--ckpt-every`` steps,
resume from the newest unless ``--no-resume``; on a mesh each rank keeps
its shards under ``<ckpt-dir>/rank<R>``).  Batches are synthetic tokens
drawn for each step from :data:`SEED` and the step's index (on a mesh
each rank takes its rows), so a resumed run reads the batches the killed
run would have read.  :func:`train` is the loop as a function
(``chip_smoke.py`` calls it in process).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.configs.shapes import LM_SHAPES, SMOKE_SHAPES
from repro_torch.core.graph import resolve_device
from repro_torch.launch.steps import lm_opt_config, make_lm_step
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainLoopConfig, run_training
from repro_torch.tree import tree_map

# train_4k's global batch on one card: the reference's 256 is a pod's (at
# 256 smollm-135m's bf16 logits alone are 256 · 4096 · 49,152 · 2 B =
# 103 GB; at 8 they are 3.2 GB)
FULL_BATCH = 8
# the parameters' and the batches' seed (the reference's launcher draws
# from 0 too)
SEED = 0


def synthetic_batch(cfg, shape: dict, step: int, seed: int, device):
    """(B, S + 1) int32 tokens of step ``step``, uniform over the vocab."""
    rng = np.random.default_rng([seed, step])
    tok = rng.integers(0, cfg.vocab, (shape["global_batch"],
                                      shape["seq_len"] + 1))
    return torch.from_numpy(tok.astype(np.int32)).to(device)


def train(arch: str, steps: int, ckpt_dir: str = "checkpoints",
          ckpt_every: int = 50, resume: bool = True, full: bool = False,
          device=None, log=print, log_every: int = 10, mesh=None):
    """Train ``arch`` (an LM) for ``steps`` steps through the trainer
    loop; returns (params, optimizer state, history, the step bundle).
    ``device=None`` is the card.  With a ``mesh`` (``full``: train_4k's
    whole global batch) the step is sharded and this rank trains its
    shards (``bundle.layout``)."""
    from repro_torch.dist import compat
    from repro_torch.models.lm.transformer import Transformer

    spec = get_arch(arch)
    if spec.family != "lm":
        raise SystemExit("this launcher drives the LM train path; DeepFM "
                         "and the GNNs train through "
                         "repro_torch.launch.steps.make_step")
    dev = resolve_device(device)
    if full:
        cfg = spec.config
        shape = dict(LM_SHAPES["train_4k"])
        if mesh is None:
            shape["global_batch"] = FULL_BATCH
    else:
        cfg = spec.smoke_config
        shape = dict(SMOKE_SHAPES["lm"]["train"])
    bundle = make_lm_step(cfg, shape, mesh)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tree_map(lambda p: p.detach(),
                      Transformer(cfg, gen, device=dev).param_tree())
    if mesh is not None:
        params = compat.shard_tree(params, bundle.layout[0], mesh)
        ckpt_dir = os.path.join(ckpt_dir, f"rank{compat.process_env()[0]}")
    state = opt.init(params, lm_opt_config(cfg))

    def batches(start: int):
        step = start
        while True:
            tok = synthetic_batch(cfg, shape, step, SEED, dev)
            if mesh is not None:
                tok = compat.shard_tree(tok, bundle.layout[2], mesh)
            yield tok
            step += 1

    tcfg = TrainLoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                           ckpt_dir=ckpt_dir, log_every=log_every)
    params, state, hist = run_training(bundle.fn, params, state, batches,
                                       tcfg, resume=resume, log=log)
    return params, state, hist, bundle


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="full config at train_4k on the production mesh")
    ap.add_argument("--one-card", action="store_true",
                    help=f"with --full: one card, batch {FULL_BATCH}")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--store-dir",
                    help="the group's file:// store directory (--full)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    mesh = None
    if args.full and not args.one_card:
        from repro_torch.dist import compat
        from repro_torch.launch.mesh import make_production_mesh

        if args.store_dir is None:
            raise SystemExit("--full trains on the production mesh: give "
                             "--store-dir, --rank and --world-size 256, or "
                             "--one-card")
        backend = "gloo" if args.device == "cpu" else "nccl"
        compat.init_group(backend, args.rank, args.world_size,
                          args.store_dir)
        mesh = make_production_mesh()
    _, _, hist, _ = train(args.arch, args.steps, args.ckpt_dir,
                          args.ckpt_every, not args.no_resume, args.full,
                          args.device, mesh=mesh)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f} "
              f"over {args.steps} steps")


if __name__ == "__main__":
    main()
