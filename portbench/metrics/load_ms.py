"""Mean host-clock ms a job spends from its start to the end of
load_corpus_bytes and a synchronise (the trainer's construction, the
native loader, coverage)."""


def read(run):
    if not run.jobs:
        return None
    return 1e3 * sum(j.loaded - j.start for j in run.jobs) / len(run.jobs)
