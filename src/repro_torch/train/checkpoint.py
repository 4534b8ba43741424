"""Fault-tolerant checkpointing: atomic, resumable, device-elastic.

A twin of the reference package's ``train/checkpoint.py`` that keeps its
on-disk layout byte for byte: one ``data.bin`` of the tree's arrays in
flattened-key order, a ``manifest.json`` with each array's dtype, shape,
offset, length and sha1, staged in a dot-prefixed tmp dir, fsynced and
published by one atomic rename, the newest ``keep`` steps kept.
Checkpoints store *logical* (unsharded) host arrays, never device
buffers: torch tensors are copied to the host on save, and restore puts
the arrays on whatever device the caller names, so a job can come back
on another device (or device count) after a failure.  A corrupt or
partial final write is detected by the checksums and the previous step
is used.  The module imports numpy only; tensors are duck-typed.  A
bfloat16 leaf, which numpy has no type for, is stored as its 2-byte words
under the dtype name ``bfloat16``, as the reference (through ml_dtypes)
stores it, and read back into a bfloat16 tensor.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from repro_torch.io.atomicdir import publish_dir
from repro_torch.io.csr import to_numpy


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict, template, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(flat, template[k], f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(flat, t, f"{prefix}{i}/")
                 for i, t in enumerate(template)]
        if hasattr(template, "_fields"):           # a NamedTuple
            return type(template)(*items)
        return type(template)(items)
    return flat[prefix[:-1]]


class Bf16Words:
    """A bfloat16 array on the host as its 16-bit words (``bits``, uint16),
    for numpy, which has no bfloat16."""

    dtype = "bfloat16"

    def __init__(self, bits: np.ndarray):
        self.bits = bits
        self.shape = bits.shape

    def tobytes(self) -> bytes:
        return self.bits.tobytes()


def _host(x):
    if hasattr(x, "detach") and str(x.dtype) == "torch.bfloat16":
        import torch

        return Bf16Words(x.detach().cpu().view(torch.int16).numpy()
                         .view(np.uint16).copy())
    return to_numpy(x)


def host_flat(tree) -> dict:
    """The tree's leaves as host numpy arrays (bfloat16 ones as
    :class:`Bf16Words`), by flattened key."""
    return {k: _host(v) for k, v in _flatten(tree).items()}


def _put(x, like, device):
    """``x`` with the dtype of template leaf ``like``: a torch tensor when
    ``like`` is one (on ``device``, else on ``like``'s device), a numpy
    array otherwise (on ``device`` when one is given)."""
    if isinstance(x, Bf16Words):
        import torch

        t = torch.from_numpy(x.bits.view(np.int16).copy()).view(
            torch.bfloat16)
        if hasattr(like, "detach"):
            return t.to(like.dtype).to(
                like.device if device is None else device)
        x = t.float().numpy()
    if hasattr(like, "detach"):
        import torch

        t = torch.from_numpy(np.array(x)).to(like.dtype)
        return t.to(like.device if device is None else device)
    a = np.asarray(x, dtype=getattr(like, "dtype", None))
    if device is None:
        return a
    import torch

    return torch.from_numpy(np.array(a)).to(device)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:010d}"

    def save(self, step: int, tree, extra_meta: dict | None = None) -> Path:
        """Crash-safe save: everything is staged in a dot-prefixed tmp dir
        (invisible to :meth:`steps`), each file is flushed + fsynced, and
        the step is published by one atomic rename followed by a parent-dir
        fsync — a crash at ANY point leaves either the previous step intact
        or the new one complete, never a half-readable step dir.
        """
        tmp, manifest = self._begin(step, extra_meta)
        self._write_data(tmp, host_flat(tree), manifest)
        return self._publish(step, tmp, manifest)

    # -- staged save internals (subclassed by the sharded runtime manager) --
    def _begin(self, step: int, extra_meta: dict | None):
        tmp = self.dir / f".tmp_step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)             # leftover of a killed save
        tmp.mkdir(parents=True)
        manifest = {"step": step, "arrays": {}}
        if extra_meta:
            manifest["meta"] = extra_meta
        return tmp, manifest

    def _write_data(self, tmp: Path, flat: dict, manifest: dict) -> None:
        with open(tmp / "data.bin", "wb") as f:
            off = 0
            for name, arr in flat.items():
                a = arr if isinstance(arr, Bf16Words) else np.asarray(arr)
                raw = a.tobytes()
                f.write(raw)
                manifest["arrays"][name] = {
                    "dtype": str(a.dtype), "shape": list(a.shape),
                    "offset": off, "nbytes": len(raw),
                    "sha1": hashlib.sha1(raw).hexdigest()[:16],
                }
                off += len(raw)
            f.flush()
            os.fsync(f.fileno())

    def _publish(self, step: int, tmp: Path, manifest: dict) -> Path:
        with open(tmp / "manifest.json", "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        publish_dir(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for p in self.dir.glob(".trash_step_*"):
            shutil.rmtree(p, ignore_errors=True)   # killed-swap orphans

    def steps(self) -> list[int]:
        """Published steps only: dot-prefixed staging dirs of killed saves
        never match, and a dir missing either file is skipped."""
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists() and (p / "data.bin").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _load_flat(self, step: int, verify: bool = True) -> dict:
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        data = (d / "data.bin").read_bytes()
        flat = {}
        for name, meta in manifest["arrays"].items():
            raw = data[meta["offset"]: meta["offset"] + meta["nbytes"]]
            if verify and hashlib.sha1(raw).hexdigest()[:16] != meta["sha1"]:
                raise IOError(f"checksum mismatch in {name} @ step {step}")
            if meta["dtype"] == Bf16Words.dtype:
                flat[name] = Bf16Words(np.frombuffer(raw, np.uint16).reshape(
                    meta["shape"]))
            else:
                flat[name] = np.frombuffer(raw, meta["dtype"]).reshape(
                    meta["shape"])
        return flat

    def meta(self, step: int) -> dict:
        """The ``extra_meta`` dict stored with a step ({} if none)."""
        d = self._step_dir(step)
        return json.loads((d / "manifest.json").read_text()).get("meta", {})

    def restore(self, template, step: int | None = None, device=None):
        """Restore into the structure of ``template``: each leaf takes its
        template leaf's dtype, and is a torch tensor where the template
        leaf is one.  ``device`` puts every leaf there as a tensor (an
        elastic restore onto another device); without it a tensor leaf
        goes to its template leaf's device.  Falls back to earlier steps
        on corruption."""
        steps = self.steps() if step is None else [step]
        for s in reversed(steps):
            try:
                flat = self._load_flat(s)
            except (IOError, json.JSONDecodeError, ValueError):
                # truncated data.bin (frombuffer/reshape ValueError),
                # checksum mismatch, unreadable manifest — a torn step dir
                # must fall back, not crash the resume
                continue
            like = _flatten(template)
            missing = sorted(set(like) - set(flat))
            if missing:
                # an intact checkpoint that simply lacks a template field is
                # a structural mismatch, not corruption — falling back would
                # misreport it as "no restorable checkpoint"
                raise KeyError(f"checkpoint step {s} does not match the "
                               f"restore template: missing {missing}")
            return _unflatten({k: _put(flat[k], t, device)
                               for k, t in like.items()}, template), s
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None
