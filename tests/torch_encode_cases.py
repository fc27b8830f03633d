"""Seeded encoder inputs shared by the CPU tests (against the JAX
package) and the card tests (kernel against its plain versions): merge
tables deep enough that long merge chains fire, and byte chunks over a
small alphabet with 'aaaa' runs, stray bytes no merge names, and
optionally chunks longer than 64 bytes."""

import numpy as np

FHUS = np.array([[117, 115],        # 'us'      -> 256
                 [104, 256],        # 'h'+US    -> 257
                 [102, 104]],       # 'fh'      -> 258
                np.int32)


def random_merges(seed: int, n: int, alpha: int = 6) -> np.ndarray:
    """int32 [n, 2]: merge i joins two ids drawn from the alphabet's
    bytes (97...) and the ids of merges before it, the low ids far more
    often (so long merge chains fire at every vocab); one pair repeats a
    later rank, and two name ids outside [0, 256 + n)."""
    rng = np.random.RandomState(seed)
    pool = (alpha + np.arange(n))[:, None]
    pick = (rng.rand(n, 2) ** 3 * pool).astype(np.int64)
    merges = np.where(pick < alpha, 97 + pick, 256 + pick - alpha)
    merges = merges.astype(np.int32)
    if n >= 8:
        merges[n // 2] = merges[n // 3]                 # repeated pair
        merges[n // 4] = (-1, 97)                       # outside [0, v)
        merges[n // 5] = (256 + n + 5, 98)
    return merges


def random_chunks(seed: int, n: int, alpha: int = 6, n_long: int = 0,
                  max_len: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """(flat uint8, lens int64): n chunks of 1..max_len bytes, then
    n_long of 65..300 bytes; 'aaaa' runs, and 2% of the bytes drawn from
    all 256."""
    rng = np.random.RandomState(seed)
    lens = np.concatenate([rng.randint(1, max_len + 1, n),
                           rng.randint(65, 301, n_long)]).astype(np.int64)
    flat = (97 + rng.randint(0, alpha, int(lens.sum()))).astype(np.uint8)
    stray = rng.rand(len(flat)) < 0.02
    flat[stray] = rng.randint(0, 256, int(stray.sum()))
    starts = np.cumsum(lens) - lens
    for s, ln in zip(starts[:20], lens[:20]):
        flat[s:s + ln] = 97                             # 'aaaa...'
    return flat, lens
