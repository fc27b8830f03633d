"""Kernel launches a job, from the wrappers' own ``.launches`` counters
(every counter of the port's loaded modules, read before and after the
window)."""


def read(run):
    if not run.jobs or not run.launches:
        return None
    return sum(run.launches.values()) / len(run.jobs)
