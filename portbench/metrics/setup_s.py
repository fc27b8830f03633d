"""Seconds from the process's start of the harness to the window: the
imports, the card, the libraries, the corpus and the warm-up job.  In a
checkout's first run the libraries are built (nvcc and g++) inside this
span; the result's ``setup`` key names what that run built, beside the
span's parts, so that run's set-up is known apart from the others'."""


def read(run):
    return run.setup_s
