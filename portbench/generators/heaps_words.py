"""Heaps-law a-z words: the corpus of BASELINE config 2 (1 GB, the port's
``bench.make_big_corpus``), cut to its first ``raw_mb`` MB.

A frozen copy of ``make_big_corpus`` that returns the bytes instead of
writing them.  The word pool is sized for ``pool_mb`` MB, the whole
corpus's size, so the prefix keeps the 1 GB corpus's words and draws and
only its depth is cut: a pool of ``6 * (pool_mb * 1e6) ** 0.65`` words
(Heaps' law), lognormal(1.75, 0.40) lengths clipped to 2-14 letters, the
shortest first, words of 4 letters and more ending in a letter pair
unique to their rank; words drawn zipf(1.0) over the pool in blocks of
4,000,000, one space between them and a newline after every 16th.  The
prefix ends at the last newline at or before ``raw_mb`` MB.  At
``pool_mb`` 1000 and the seed 99 it is the first bytes of the 1 GB file
that ``make_big_corpus`` writes."""

from __future__ import annotations

import numpy as np

BLOCK = 4_000_000       # words a block
NEWLINE_EVERY = 16      # words a line


def make(raw_mb: float, seed: int, pool_mb: float = 1000) -> bytes:
    target = int(raw_mb * 10 ** 6)
    rng = np.random.RandomState(seed)
    n_vocab = max(1000, int(6.0 * (pool_mb * 10 ** 6) ** 0.65))
    lens = np.rint(rng.lognormal(1.75, 0.40, n_vocab)).astype(np.int64)
    np.clip(lens, 2, 14, out=lens)
    lens.sort()                     # rank 0 = shortest = most frequent
    pool_off = np.zeros(n_vocab + 1, np.int64)
    np.cumsum(lens, out=pool_off[1:])
    pool = rng.randint(97, 123, pool_off[-1]).astype(np.uint8)  # a-z
    li = np.nonzero(lens >= 4)[0]
    pool[pool_off[li + 1] - 2] = 97 + (li % 26).astype(np.uint8)
    pool[pool_off[li + 1] - 1] = 97 + ((li // 26) % 26).astype(np.uint8)
    probs = 1.0 / np.arange(1, n_vocab + 1) ** 1.0
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    out, written = [], 0
    while written < target:
        idx = np.searchsorted(cdf, rng.random_sample(BLOCK))
        np.clip(idx, 0, n_vocab - 1, out=idx)
        off = np.zeros(BLOCK + 1, np.int64)
        np.cumsum(lens[idx] + 1, out=off[1:])   # +1 separator per word
        # the block's words up to the one that reaches the target: the
        # bytes past it are drawn but never cut into the prefix
        m = min(BLOCK, int(np.searchsorted(off, target - written)))
        wl, off = lens[idx[:m]], off[:m + 1]
        block = np.full(off[-1], 32, np.uint8)
        block[off[1:][NEWLINE_EVERY - 1::NEWLINE_EVERY] - 1] = 10
        at = np.arange(int(wl.sum()), dtype=np.int64) \
            - np.repeat(off[:-1] - np.arange(m), wl)
        block[np.repeat(off[:-1], wl) + at] = \
            pool[np.repeat(pool_off[idx[:m]], wl) + at]
        out.append(block.tobytes())
        written += len(out[-1])
    data = b"".join(out)
    return data[: data.rindex(b"\n", 0, target + 1) + 1]
