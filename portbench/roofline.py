"""The table of peaks and the work of the merge loop.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3
and 67 T operations/s outside the tensor cores, at the full power limit
of 700 W.  A run prints the card's power limit beside its numbers.

The merge loop's work is counted from the reference's run, never from
the program, so it is the same whatever engine runs: the stream's
tokens read and written once (int32), the first count's distinct pairs
written once, and per merge every pair whose count changed (its int64
key and int32 count read, the count written: 16 bytes) and one record
(a, b and the count: 12 bytes).  The operations: an add per changed
count and a compare per occurrence merged.  Both are what any engine
must do at the least; the pick of the best pair is left out."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
OPS_S = 67e12
TOKEN_BYTES = 8          # an int32 token read and written
PAIR_BYTES = 16
RECORD_BYTES = 12


def merge_work(ref) -> tuple[int, int]:
    """(bytes, operations) of the merge loop of the reference result."""
    nbytes = (TOKEN_BYTES * ref.n_tokens + PAIR_BYTES * ref.initial_pairs
              + PAIR_BYTES * sum(ref.changed_pairs)
              + RECORD_BYTES * len(ref.changed_pairs))
    ops = sum(ref.changed_pairs) + sum(ref.occurrences)
    return nbytes, ops


def least_time(nbytes: float, ops: float) -> tuple[float, str]:
    """(seconds, which bound) of the work on the card."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
