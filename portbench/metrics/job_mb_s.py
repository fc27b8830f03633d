"""Corpus MB times jobs, over the window's wall time from the first job's
start to the last job's end: the whole user job, the load included."""


def read(run):
    if not run.jobs:
        return None
    wall = run.jobs[-1].end - run.jobs[0].start
    return run.corpus_mb * len(run.jobs) / wall if wall > 0 else None
