"""Process peak-RSS tracking, a copy of the reference package's
``obs/rss.py``.

The kernel's ``VmHWM`` watermark (``/proc/self/status``) is the ground
truth where ``/proc`` provides it: it is a *lifetime maximum*, so a
one-instant allocation spike between (or after) samples can never be
lost.  Sampled instantaneous ``VmRSS`` under-reports whenever the
process outlives the spike by more than the sample interval, so the
sampler thread here is only the fallback for kernels without ``VmHWM``.
``ru_maxrss`` is deliberately last: it survives ``execve``, so a child
inherits its parent's watermark through it.

This module imports the standard library only; :mod:`repro_torch.obs.trace`
samples it at close for the per-host peak-RSS counters.
"""
from __future__ import annotations

import os
import threading
import time

_page_kb = os.sysconf("SC_PAGE_SIZE") // 1024 if hasattr(os, "sysconf") else 4


def vm_hwm_kb() -> int:
    """The kernel's lifetime peak-RSS watermark (KiB); 0 if unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def vm_rss_kb() -> int:
    """Instantaneous resident set size (KiB); 0 if unavailable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _page_kb
    except OSError:
        return 0


class _Sampler:
    """Daemon thread tracking max sampled VmRSS — the no-VmHWM fallback."""

    def __init__(self, interval: float = 0.002):
        self.peak = 0
        self._interval = interval
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            rss = vm_rss_kb()
            if rss > self.peak:
                self.peak = rss
            time.sleep(self._interval)


_sampler: _Sampler | None = None
_sampler_lock = threading.Lock()


def start_fallback_sampler(interval: float = 0.002) -> bool:
    """Start the VmRSS sampler thread iff this kernel lacks ``VmHWM``.

    Idempotent.  Returns True when the sampler is (now) running — i.e.
    when peak tracking depends on it rather than on the watermark.
    """
    global _sampler
    if vm_hwm_kb() > 0:
        return False
    with _sampler_lock:
        if _sampler is None:
            _sampler = _Sampler(interval)
    return True


def peak_rss_kb() -> int:
    """Best-available peak RSS (KiB): VmHWM, else sampler/VmRSS max,
    else ``ru_maxrss`` (see the module docstring for the ordering)."""
    peak = vm_hwm_kb()
    if peak == 0:
        sampled = _sampler.peak if _sampler is not None else 0
        peak = max(sampled, vm_rss_kb())
    if peak == 0:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return peak


__all__ = ["peak_rss_kb", "start_fallback_sampler", "vm_hwm_kb",
           "vm_rss_kb"]
