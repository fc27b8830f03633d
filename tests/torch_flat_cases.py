"""Seeded flat-engine streams for F1 (``csrc/flat.cu``) against its plain
version, shared by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``:
words up to 1,000 tokens, a run of 1,001 'a's, unk bytes (-1 too), new
ids past 65535 (a resume near merge 65280), a min_pair_freq stop and
words that merge down to one token."""

import numpy as np


def flat_corpus(seed, n_words=300, alpha=4, max_len=200, unk=None, run=0):
    """The flat engine's stream: words of 1..max_len tokens over a few
    letters (words up to 1,000 tokens and long 'aaaa' runs), an optional
    unk byte (-1 too) and a word of `run` 'a's first."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    lens[:5] = rng.randint(2, 30, 5)                  # 'aaaa...' runs
    if run:
        lens[0] = run
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < 5] = 97
    if unk is not None:
        tokens[(rng.rand(len(tokens)) < 0.05) & (word_id >= 5)] = unk
    wcount = rng.randint(1, 60, n_words).astype(np.int32)[word_id]
    return tokens, word_id, wcount


# name: (corpus arguments, target merges, resumed merges, unk_id,
#        min_pair_freq)
FLAT_CASES = {
    "long_words": (dict(seed=60, max_len=1000), 300, 0, -1, 2),
    "run_a1001": (dict(seed=61, n_words=80, run=1001), 200, 0, -1, 2),
    "unk_byte": (dict(seed=62, unk=98, alpha=5), 250, 0, 98, 2),
    "unk_minus_one": (dict(seed=63, unk=-1, alpha=5), 250, 0, -1, 2),
    # new ids cross 65535: pairs of ids above 16 bits
    "ids_past_65535": (dict(seed=64, n_words=400, max_len=60), 65330,
                       65270, -1, 2),
    "min_freq_stop": (dict(seed=65, max_len=100), 300, 0, -1, 400),
    # words that merge down to one token
    "to_one_token": (dict(seed=66, n_words=40, alpha=2, max_len=12), 400,
                     0, -1, 1),
}
