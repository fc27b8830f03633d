"""Device ms a job of every kernel (copies and fills left out) that the
profiler saw inside the jobs' spans."""

from portbench import trace


def read(run):
    jobs = run.spans.get("job", [])
    ev = trace.kernels(trace.inside(run.events, jobs))
    if not jobs or not ev:
        return None
    return sum(e - s for _, s, e in ev) / 1e3 / len(jobs)
