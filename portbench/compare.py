"""The comparison that decides ``correct``: a job's outputs against the
plain reference's, exactly.  Every number is a count of differences,
and its limit is 0."""

from __future__ import annotations

import numpy as np

# name -> limit; all exact
LIMITS = {"merges_diff": 0, "freqs_diff": 0, "model_diff": 0,
          "vocab_diff": 0}


def rows_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Rows (or entries) that differ, a missing or extra one counting."""
    got, want = np.asarray(got), np.asarray(want)
    n = min(len(got), len(want))
    diff = (got[:n] != want[:n]).reshape(n, -1).any(axis=1) if n else ()
    return int(np.sum(diff)) + abs(len(got) - len(want))


def job_diffs(ref, merges, freqs, model: bytes, vocab: bytes) -> dict:
    """One job's differences from the reference result ``ref``."""
    return {"merges_diff": rows_differing(
                np.asarray(merges, np.int64).reshape(-1, 2), ref.merges),
            "freqs_diff": rows_differing(np.asarray(freqs, np.int64),
                                         ref.merge_freqs),
            "model_diff": int(model != ref.model),
            "vocab_diff": int(vocab != ref.vocab)}


def combine(per_job: list[dict]) -> list[tuple[str, int, int]]:
    """(name, value, limit) over the jobs: the most merges and counts
    that any job got wrong, and the jobs whose files differ."""
    out = []
    for name, limit in LIMITS.items():
        vals = [d[name] for d in per_job]
        if name in ("model_diff", "vocab_diff"):
            v = sum(vals)
        else:
            v = max(vals, default=0)
        out.append((name, v, limit))
    return out
