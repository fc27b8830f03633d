"""Seeded flat-engine streams for F1 (``csrc/flat.cu``) against its plain
version, shared by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``:
words up to 1,000 tokens, a run of 1,001 'a's, unk bytes (-1 too), new
ids past 65535 (a resume near merge 65280), a min_pair_freq stop, words
that merge down to one token, and the cases of F1's presence index: a
long tail of count-1 merges, late pairs held by one word at a chunk's
edge, a resumed stream that holds ids past 65535, and a run toward
vocab 131,328, for which F1's presence index grows to 131,328 rows."""

import numpy as np


def flat_corpus(seed, n_words=300, alpha=4, max_len=200, unk=None, run=0,
                count=60, edges=False, rare=(), high=0):
    """The flat engine's stream: words of 1..max_len tokens over a few
    letters (words up to 1,000 tokens and long 'aaaa' runs), an optional
    unk byte (-1 too), a word of `run` 'a's first and word counts below
    `count`.  `edges` makes the first and the last word of every chunk of
    32 words (but the first chunk) one token long; `rare` puts the given
    tokens, count 1, in the given words; `high` draws 15% of the tokens
    from the 64 ids below 256 + high, as in a stream resumed at merge
    `high`."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    lens[:5] = rng.randint(2, 30, 5)                  # 'aaaa...' runs
    if run:
        lens[0] = run
    w = np.arange(n_words)
    if edges:
        lens[(w >= 32) & ((w % 32 == 0) | (w % 32 == 31))] = 1
    for word, toks in rare:
        lens[word] = len(toks)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < 5] = 97
    if unk is not None:
        tokens[(rng.rand(len(tokens)) < 0.05) & (word_id >= 5)] = unk
    wcount = rng.randint(1, count, n_words).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)])
    for word, toks in rare:
        tokens[starts[word]:starts[word] + len(toks)] = toks
        wcount[word] = 1
    if high:
        ids = rng.randint(256 + high - 64, 256 + high, len(tokens))
        pick = (rng.rand(len(tokens)) < 0.15) & (word_id >= 5)
        tokens = np.where(pick, ids, tokens).astype(np.int32)
    return tokens, word_id, wcount[word_id]


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
    # the presence index's cases: 4,001 words (not a multiple of 32) with
    # one-token words at the chunks' edges, run to the end, the last 538
    # merges of count 1 (one word each)
    "long_tail": (dict(seed=67, n_words=4001, alpha=3, max_len=8, count=3,
                       edges=True), 1600, 0, -1, 1),
    # merges 457 and 461 of 467: pairs held only by the first word of
    # chunk 5 and the last word of chunk 9
    "late_edge_pair": (dict(seed=68, n_words=700, alpha=3, max_len=8,
                            rare=((160, (120, 121, 120, 121)),
                                  (319, (122, 123, 122)))), 500, 0, -1, 1),
    # a resumed stream that holds ids past 65535
    "resumed_high_ids": (dict(seed=69, n_words=400, max_len=60,
                              high=65400), 65460, 65400, -1, 2),
    # a run toward vocab 131,328 resumed at merge 65270: the presence
    # index grows to 131,328 rows, new ids cross 65535 after ten merges
    # and most of the 454 merges (to a min_pair_freq stop) hold one past it
    "reserve_131328_rows": (dict(seed=70, n_words=400, max_len=60,
                                 high=65270), 131072, 65270, -1, 60),
}

# The sharded flat engine's cases (S1 and its plain version against the
# JAX package's sharded_train), the same fields as FLAT_CASES: words over
# 64 tokens and an unk byte; a vocab past the JAX package's PACK_LIMIT
# (2^14: its 2-key path) with a min_pair_freq stop after 70 merges; a
# resume at merge 16300 whose stream holds ids past 16383
SHARDED_CASES = {
    "long_words_unk": (dict(seed=80, n_words=90, max_len=150, unk=98,
                            alpha=4), 120, 0, 98, 2),
    "two_key_stop": (dict(seed=81, n_words=120, max_len=90, alpha=4),
                     16300, 0, -1, 200),
    "two_key_resumed": (dict(seed=82, n_words=120, max_len=80,
                             high=16300), 16420, 16300, -1, 2),
}
