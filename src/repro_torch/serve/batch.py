"""Collect-until-deadline-or-batch-size request batcher.

A copy of the reference package's ``serve/batch.py``, reading the same
``REPRO_SERVE_BATCH`` and ``REPRO_SERVE_DEADLINE_MS``.

Graph serving is decode-bound: answering one neighbor query decodes a
whole row shard, so ten queries that land in the same shard cost one
decode *if they execute together*.  The batcher is the piece that makes
"together" happen under concurrent callers: requests accumulate until
either ``max_batch`` of them are pending or the **oldest** pending
request has waited ``max_delay_s`` (the tail-latency budget — a lone
request is never held longer than the deadline), then the whole batch
runs through one ``execute(items) -> results`` call, which groups by
shard (``repro_torch.serve.service``).

Stdlib-only, one worker thread, futures as the hand-back: HTTP handler
threads block on their request's future, so batching is invisible to
the protocol layer.  Failure semantics: an ``execute`` that raises
fails every future in that batch with the same exception (the callers
see it re-raised); later batches are unaffected.  ``close()`` drains
pending requests before returning; ``submit`` after close raises.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future


def _env_num(name: str, default: float) -> float:
    val = os.environ.get(name, "")
    return float(val) if val else default


def default_max_batch() -> int:
    """``REPRO_SERVE_BATCH`` — flush when this many requests pend."""
    return int(_env_num("REPRO_SERVE_BATCH", 32))


def default_max_delay_s() -> float:
    """``REPRO_SERVE_DEADLINE_MS`` — flush when the oldest pending
    request has waited this long (milliseconds in the env var)."""
    return _env_num("REPRO_SERVE_DEADLINE_MS", 2.0) / 1000.0


class RequestBatcher:
    def __init__(self, execute, max_batch: int | None = None,
                 max_delay_s: float | None = None):
        self._execute = execute
        self.max_batch = (default_max_batch() if max_batch is None
                          else int(max_batch))
        self.max_delay_s = (default_max_delay_s() if max_delay_s is None
                            else float(max_delay_s))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._pending: list[tuple[object, Future, float]] = []
        self._cond = threading.Condition()
        self._closed = False
        self.batches = 0
        self.items = 0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-batcher")
        self._worker.start()

    def submit(self, item) -> Future:
        """Enqueue one request; the future resolves to its result."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append((item, fut, time.monotonic()))
            self._cond.notify_all()
        return fut

    def __call__(self, item):
        """Submit and wait — the synchronous convenience callers use."""
        return self.submit(item).result()

    def close(self) -> None:
        """Stop accepting requests, drain what's pending, join."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join()

    def stats(self) -> dict:
        return {"batches": self.batches, "items": self.items,
                "mean_batch": self.items / self.batches
                if self.batches else 0.0}

    # -- worker -------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if not self._pending:
                    return                       # closed and drained
                # the flush clock starts at the OLDEST pending request:
                # a request is never held past max_delay_s, no matter
                # how sparsely traffic trickles in behind it
                deadline = self._pending[0][2] + self.max_delay_s
                while (len(self._pending) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                batch = self._pending[:self.max_batch]
                self._pending = self._pending[self.max_batch:]
            self._run(batch)

    def _run(self, batch) -> None:
        items = [b[0] for b in batch]
        try:
            results = self._execute(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"execute returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:  # noqa: BLE001 — fail the batch, not
            for _, fut, _t in batch:            # the worker thread
                fut.set_exception(e)
            return
        self.batches += 1
        self.items += len(items)
        for (_, fut, _t), res in zip(batch, results):
            fut.set_result(res)


__all__ = ["RequestBatcher", "default_max_batch", "default_max_delay_s"]
