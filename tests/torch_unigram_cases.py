"""Seeded Unigram lattices shared by tests/test_torch_unigram.py (the
plain versions against the JAX package) and tests/test_torch_cuda.py (the
kernels against the plain versions).  Imports no JAX."""

from __future__ import annotations

import numpy as np

PRUNED = -1e30      # the trainer's logp of a piece pruned to zero counts

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
