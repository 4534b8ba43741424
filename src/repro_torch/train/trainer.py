"""Training loop with fault tolerance (the reference's ``train/trainer.py``
on tensors).

One step function, checkpoint-every-N with atomic publish and
auto-resume through ``train.checkpoint.CheckpointManager``.  Fault model:

  job failure    → the job restarts and ``restore()`` brings back the
                   newest intact step (on any device: checkpoints hold
                   host arrays).
  mid-write kill → the tmp-dir rename is atomic; ``restore()`` falls back
                   past a corrupt step (checksums).
  stragglers     → the loop tracks a rolling step-time EWMA and logs
                   steps over 3× it for an operator.

A step's time ends in ``torch.cuda.synchronize()`` where its loss lies on
the card (the reference's ``block_until_ready``).  ``batch_iter`` may be a
function of the first step that returns the batch iterator, so that a
resumed run reads the batches from where the killed run stopped.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10


def run_training(step_fn: Callable, params, opt_state, batch_iter,
                 cfg: TrainLoopConfig, resume: bool = True,
                 log: Callable = print) -> tuple[Any, Any, list[dict]]:
    """step_fn(params, opt_state, batch) -> (params, opt_state, loss, gnorm).

    ``batch_iter``: an iterator of batches, or ``batch_iter(start)``
    returning one that begins at step ``start``.  Returns (params,
    opt_state, history).
    """
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
    start = 0
    if resume and mgr.latest_step() is not None:
        (params, opt_state), start = mgr.restore((params, opt_state))
        log(f"[trainer] resumed from step {start}")
    if callable(batch_iter):
        batch_iter = batch_iter(start)
    history = []
    ewma = None
    for step in range(start, cfg.total_steps):
        batch = next(batch_iter)
        t0 = time.time()
        params, opt_state, loss, gnorm = step_fn(params, opt_state, batch)
        if torch.is_tensor(loss) and loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > 3.0 * ewma and step > start + 5:
            log(f"[trainer] straggler step {step}: {dt:.3f}s vs "
                f"EWMA {ewma:.3f}s")
        if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
            rec = {"step": step, "loss": float(loss),
                   "grad_norm": float(gnorm), "step_time_s": dt}
            history.append(rec)
            log(f"[trainer] step {step}: loss={rec['loss']:.4f} "
                f"gnorm={rec['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if (step + 1) % cfg.ckpt_every == 0 or step == cfg.total_steps - 1:
            mgr.save(step + 1, (params, opt_state))
    return params, opt_state, history
