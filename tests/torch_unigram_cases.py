"""Seeded Unigram lattices shared by tests/test_torch_unigram.py (the
plain versions against the JAX package) and tests/test_torch_cuda.py (the
kernels against the plain versions).  Imports no JAX."""

from __future__ import annotations

import numpy as np

PRUNED = -1e30      # the trainer's logp of a piece pruned to zero counts

# A corpus whose training reaches words split only through pruned pieces
# (16 words, each written `count` times), and its trainer config: the
# JAX package's device E-step overflows there and its model has NaN
# log-probs; the port's gives the float64 "cpu" backend's model.
OVERFLOW_WORDS = {
    "ca中文Ab": 898, "Ab": 234, "x": 128, "tzzer": 98, "AB": 86,
    "23sasqua": 82, "1ABAB中文": 76, "23😀": 75, "1quAbaing": 64,
    "onontont": 64, "t": 54, "😀quing": 52, "ABa": 40, "xABer": 36,
    "quABa": 33, "😀theéABx": 29}
OVERFLOW_TEXT = " ".join(w for w, c in OVERFLOW_WORDS.items()
                         for _ in range(c))
OVERFLOW_CONFIG = dict(target_vocab_size=20, seed_size=5000,
                       max_word_len=32, num_em_rounds=3)

# name: (seed, W, L, K, n_pieces)
LATTICES = {
    "mixed": (0, 300, 16, 15, 400),
    "rows32": (1, 200, 32, 15, 900),
    "short_k": (2, 150, 12, 4, 60),
    "k1": (3, 80, 9, 1, 30),
    "long_l70": (4, 40, 70, 15, 500),
    "ties": (5, 200, 16, 6, 120),
    "pruned_path": (6, 120, 16, 8, 200),
}


def random_lattice(name: str):
    """(table int32 [W, L, K] word-major as ``piece_table`` gives it,
    wlen int32 [W], wcount float32 [W], logp float64 [n_pieces]).

    Cells lie inside their word only.  Single-byte cells are present with
    probability 0.9 (ids of unpruned pieces), longer ones 0.3 (any id).
    Word 0 has length 1 and word 1 length L; word 2 has an all-absent row
    (position 1); word 3 has no cell at all (no piece covers it); a tenth
    of the pieces are pruned to logp -1e30.  "ties" gives every piece the
    same logp (Viterbi ties everywhere); "pruned_path" gives word 4 (length
    2) one path, through a pruned piece."""
    seed, W, L, K, n = LATTICES[name]
    rng = np.random.RandomState(seed)
    wlen = rng.randint(1, L + 1, W).astype(np.int32)
    wlen[0], wlen[1] = 1, L
    pruned = rng.rand(n) < 0.1
    pruned[:2] = False
    good = np.nonzero(~pruned)[0]
    j = np.arange(L)[None, :, None]
    k = np.arange(K)[None, None, :]
    inside = j + k + 1 <= wlen[:, None, None]
    p = np.where(k == 0, 0.9, 0.3)
    ids = np.where(k == 0, good[rng.randint(0, len(good), (W, L, K))],
                   rng.randint(0, n, (W, L, K)))
    table = np.where(inside & (rng.rand(W, L, K) < p), ids, -1)
    table[2, 1] = -1
    table[3] = -1
    logp = np.log(rng.dirichlet(np.ones(n)) + 1e-9)
    if name == "ties":
        logp[:] = -2.0
    logp[pruned] = PRUNED
    if name == "pruned_path":
        wlen[4] = 2
        table[4] = -1
        table[4, 0, 1] = np.nonzero(pruned)[0][0]
    wcount = rng.randint(1, 50, W).astype(np.float32)
    return table.astype(np.int32), wlen, wcount, logp


def overflow_lattice():
    """The "pruned_path" lattice with 16 words appended, of lengths 1..16,
    each with one path: single bytes through the first four pruned pieces
    (logp -1e30) in turn.  Their alphas reach -1.6e31, where one float32
    ulp is near 1e24, so the posteriors ((alpha + lp) + beta) - norm of
    the longer ones are far from 0 and the JAX package's E-step counts
    inf there.  Same tuple as :func:`random_lattice`."""
    table, wlen, wcount, logp = random_lattice("pruned_path")
    W, L, K = table.shape
    pruned = np.nonzero(logp == np.float64(PRUNED))[0][:4]
    extra = np.full((16, L, K), -1, np.int32)
    elen = np.arange(1, 17, dtype=np.int32)
    for w, n in enumerate(elen):
        extra[w, :n, 0] = pruned[np.arange(n) % 4]
    ecount = np.random.RandomState(7).randint(1, 900, 16).astype(np.float32)
    return (np.concatenate([table, extra]), np.concatenate([wlen, elen]),
            np.concatenate([wcount, ecount]), logp)
