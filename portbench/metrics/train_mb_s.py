"""Corpus MB times jobs, over the summed host-clock spans of every job's
train() and save(), each between two synchronises."""


def read(run):
    spent = sum(j.trained - j.loaded for j in run.jobs)
    return run.corpus_mb * len(run.jobs) / spent if spent > 0 else None
