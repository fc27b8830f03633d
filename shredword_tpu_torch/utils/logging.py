"""Structured logging with the reference's severity tags.

The reference logs `[INFO]/[DEBUG]/[MERGE]/[PROGRESS]/[WARNING]/[ERROR]`
via printf (SURVEY.md §5).  We keep the same visible tags for familiarity
but route through `logging` so applications can filter/redirect, and keep
merge-level logging off by default (it is O(vocab) lines).
"""

from __future__ import annotations

import logging
import os
import sys
import time

_logger = logging.getLogger("shredword_tpu_torch")
if not _logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(h)
    _logger.setLevel(os.environ.get("SHRED_LOG_LEVEL", "INFO").upper())
    _logger.propagate = False


def info(msg: str, *args) -> None:
    _logger.info("[INFO]\t " + (msg % args if args else msg))


def debug(msg: str, *args) -> None:
    _logger.debug("[DEBUG]\t " + (msg % args if args else msg))


def warning(msg: str, *args) -> None:
    _logger.warning("[WARNING]\t " + (msg % args if args else msg))


def error(msg: str, *args) -> None:
    _logger.error("[ERROR]\t " + (msg % args if args else msg))


def merge(msg: str, *args) -> None:
    _logger.debug("[MERGE]\t " + (msg % args if args else msg))


def progress(msg: str, *args) -> None:
    _logger.info("[PROGRESS]\t " + (msg % args if args else msg))


_PHASES: dict[str, list] = {}


def phase_totals() -> dict[str, tuple[float, int]]:
    """Aggregated (seconds, bytes) per Timer phase name."""
    return {k: (v[0], v[1]) for k, v in _PHASES.items()}


class Timer:
    """Wall-clock phase timer with bytes/s reporting; totals by phase
    name in :func:`phase_totals`."""

    def __init__(self, name: str, nbytes: int | None = None, log: bool = True):
        self.name = name
        self.nbytes = nbytes
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        acc = _PHASES.setdefault(self.name, [0.0, 0])
        acc[0] += self.elapsed
        acc[1] += self.nbytes or 0
        if self.log:
            if self.nbytes:
                mbps = self.nbytes / 1e6 / max(self.elapsed, 1e-12)
                debug("%s: %.3fs (%.1f MB/s)", self.name, self.elapsed, mbps)
            else:
                debug("%s: %.3fs", self.name, self.elapsed)
        return False

    @property
    def mb_per_s(self) -> float:
        if not self.nbytes or not self.elapsed:
            return 0.0
        return self.nbytes / 1e6 / self.elapsed
