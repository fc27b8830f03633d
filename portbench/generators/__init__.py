"""Corpus generators: one module a generator, found by the name that a
configuration's ``corpus.generator`` gives.  Each has
``make(raw_mb, seed) -> bytes`` and writes no file."""
