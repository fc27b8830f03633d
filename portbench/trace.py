"""Arithmetic on the profiler's intervals: the union of device intervals
(the port's ``chip_smoke.busy_us``, copied), their part inside host
spans, and the breakdown of a traced run."""

from __future__ import annotations

# device events that are copies or fills, not kernels
COPY_PREFIXES = ("Memcpy", "Memset")
# host spans of a job, innermost first, that name an idle gap
GAP_SPANS = ("call", "load", "train_save", "destroy")
NAME_CHARS = 100    # a device operation's name in the breakdown, cut


def union_us(events) -> float:
    """Microseconds in which at least one of the (name, start, end)
    events ran."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((ev[1], ev[2]) for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def clip(events, lo: float, hi: float) -> list:
    """The events' parts inside [lo, hi]."""
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if e > lo and s < hi]


def inside(events, spans) -> list:
    """The events' parts inside any of the (start, end) spans, which do
    not overlap."""
    out = []
    for lo, hi in spans:
        out.extend(clip(events, lo, hi))
    return out


def kernels(events) -> list:
    return [ev for ev in events if not ev[0].startswith(COPY_PREFIXES)]


def gaps(events, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which no event ran."""
    out, at = [], lo
    for s, e in sorted((ev[1], ev[2]) for ev in clip(events, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def host_at(spans: dict, t: float) -> str:
    """What the host was doing at t: the innermost job span holding it."""
    for name in GAP_SPANS:
        for s, e in spans.get(name, ()):
            if s <= t < e:
                return name
    return "between_jobs"


def gap_name(spans: dict, s: float, e: float) -> str:
    """What the host was doing through an idle gap: the job span at its
    start, and at its end where that differs (``load>train_save``)."""
    first, last = host_at(spans, s), host_at(spans, e - 1e-3)
    return first if first == last else f"{first}>{last}"


def breakdown(run) -> dict:
    """The device operations that took most time in the window and its
    longest idle gaps, named by what the host was doing; 10 of each."""
    lo, hi = run.window_us
    by_name: dict[str, float] = {}
    for n, s, e in clip(run.events, lo, hi):
        n = n[:NAME_CHARS]
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(((gap_name(run.spans, s, e), (e - s) / 1e6)
                   for s, e in gaps(run.events, lo, hi)),
                  key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in idle]}
