"""The share, in %, of the summed train()+save() spans of the jobs in
which no kernel, copy or fill ran on the device (the union of the
profiler's device intervals)."""

from portbench import trace


def read(run):
    spans = run.spans.get("train_save", [])
    total = sum(e - s for s, e in spans)
    if total <= 0 or not run.events:
        return None
    busy = trace.union_us(trace.inside(run.events, spans))
    return 100.0 * (1.0 - busy / total)
