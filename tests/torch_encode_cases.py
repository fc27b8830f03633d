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


def high_id_merges(seed: int, n: int, head: int = 400) -> np.ndarray:
    """int32 [n, 2] for a vocab 256 + n past 32768: random_merges(seed,
    head) first, then pairs no letter text holds (a control byte 1-31 and
    an earlier id), but for five ranks that join the letters g and h,
    which the head never names: 'gh' and 'hg' at ranks 32515 and 32516
    (ids 32771 and 32772, past int16), then at the last three ranks
    'ghhg', 'gg' and 'gg' + 'gh' (ids up to 256 + n - 1: past 65535 when
    n > 65280)."""
    m = np.empty((n, 2), np.int32)
    m[:head] = random_merges(seed, head)
    i = np.arange(head, n)
    m[head:, 0] = 1 + i % 31
    m[head:, 1] = 256 + (i - head) // 31
    g, h = ord("g"), ord("h")
    m[32515], m[32516] = (g, h), (h, g)
    m[n - 3] = (32771, 32772)
    m[n - 2] = (g, g)
    m[n - 1] = (256 + n - 2, 32771)
    return m


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


# the edges of csrc/encode.cu's length classes: 0-1 bytes (no merge),
# lane groups of 8 (2-8), 16 (9-16) and 32 (17-32), the warp with two
# tokens a lane (33-64), and the lane in global scratch (65 on)
BOUNDARY_LENS = (1, 2, 8, 9, 16, 17, 32, 33, 64, 65)

# merges over 'a' runs: (a, a) first, then pairs of its results, so a
# run of k bytes merges (a, a) greedily left to right, then again one
# level up, across the edges of the lane groups
A_RUN_MERGES = np.array([[97, 97],        # 256 = aa
                         [256, 256],      # 257 = aaaa
                         [257, 257],      # 258 = a x 8
                         [256, 97],       # 259 = aaa
                         [258, 258],      # 260 = a x 16
                         [257, 256]],     # 261 = a x 6
                        np.int32)


def _with_one_byte(parts: list, rng) -> tuple[np.ndarray, np.ndarray]:
    """(flat, lens) of the parts with a one-byte chunk before every other
    part, so each window of 32 chunks mixes one-byte chunks with longer
    ones."""
    out = []
    for i, part in enumerate(parts):
        if i % 2 == 0:
            out.append(bytes([97 + int(rng.randint(0, 6))]))
        out.append(part)
    lens = np.array([len(p) for p in out], np.int64)
    return np.frombuffer(b"".join(out), np.uint8).copy(), lens


def boundary_chunks(seed: int, alpha: int = 6, reps: int = 4):
    """(flat uint8, lens int64): `reps` chunks of each BOUNDARY_LENS
    length, bytes over the alphabet ('a' runs in the first of each),
    shuffled, with one-byte chunks between them."""
    rng = np.random.RandomState(seed)
    parts = []
    for n in BOUNDARY_LENS:
        for r in range(reps):
            part = 97 + rng.randint(0, 1 if r == 0 else alpha, n)
            parts.append(part.astype(np.uint8).tobytes())
    rng.shuffle(parts)
    return _with_one_byte(parts, rng)


def a_runs(k_max: int = 70) -> tuple[np.ndarray, np.ndarray]:
    """(flat, lens): 'a' * k for k = 2..k_max, one-byte chunks between."""
    rng = np.random.RandomState(k_max)
    return _with_one_byte([b"a" * k for k in range(2, k_max + 1)], rng)


def mixed_windows(seed: int, n: int = 600, alpha: int = 6):
    """(flat, lens): n chunks, half of one byte, the rest of 2-70 bytes,
    in a seeded order; 'aaaa' runs in a tenth of the longer ones."""
    rng = np.random.RandomState(seed)
    lens = np.where(rng.rand(n) < 0.5, 1, rng.randint(2, 71, n))
    flat = (97 + rng.randint(0, alpha, int(lens.sum()))).astype(np.uint8)
    starts = np.cumsum(lens) - lens
    for s, ln in zip(starts[::10], lens[::10]):
        flat[s:s + ln] = 97
    return flat, lens.astype(np.int64)


def boundary_cases() -> dict:
    """name -> (flat, lens, merges) of the length-class edge cases."""
    m = random_merges(21, 500)
    return {"boundary": (*boundary_chunks(22), m),
            "a_runs": (*a_runs(), A_RUN_MERGES),
            "mixed": (*mixed_windows(23), m)}
