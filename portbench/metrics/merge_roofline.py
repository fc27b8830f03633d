"""The merge loop's share of its roofline, in %: the least time the card
needs for the merge loop's work on this corpus, over the device time of
every kernel a job (kernel_ms_per_job).  The work is counted from the
reference's run (portbench/roofline.py), so it is the same whatever
engine runs."""

from portbench import roofline, trace


def read(run):
    jobs = run.spans.get("job", [])
    ev = trace.kernels(trace.inside(run.events, jobs))
    if not jobs or not ev or run.reference is None:
        return None
    kernel_s = sum(e - s for _, s, e in ev) / 1e6 / len(jobs)
    least_s, _ = roofline.least_time(*roofline.merge_work(run.reference))
    return 100.0 * least_s / kernel_s
