"""Profiling hooks: torch.profiler traces and phase counters.

- ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (host activity, and the card's where there is one) that writes a
  Chrome trace under ``logdir`` (set SHREDWORD_TRACE=/path to trace a
  whole CLI run)
- ``annotate(name)``: a named host-side region in the trace
  (``torch.profiler.record_function``)
- ``phase_report()``: wall-clock + bytes/s per named phase collected by
  utils.logging.Timer
"""

from __future__ import annotations

import contextlib
import os
import time

from . import logging as log


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a trace under `logdir` (or $SHREDWORD_TRACE): one Chrome
    trace file, ``trace-<pid>-<ns>.json``.  Yields the profiler, or None
    when no directory is given (nothing is traced)."""
    logdir = logdir or os.environ.get("SHREDWORD_TRACE")
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named host-side region visible in profiler traces."""
    from torch.profiler import record_function
    return record_function(name)


def phase_report() -> dict[str, dict]:
    """Aggregated Timer stats per phase: {'phase': {'seconds', 'bytes',
    'mb_s'}} (Timers record into utils.logging._PHASES)."""
    out = {}
    for name, (secs, nbytes) in log.phase_totals().items():
        out[name] = {
            "seconds": round(secs, 4),
            "bytes": nbytes,
            "mb_s": round(nbytes / 1e6 / secs, 2) if secs and nbytes
            else None,
        }
    return out
