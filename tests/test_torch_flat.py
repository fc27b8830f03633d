"""Differential tests: the port's flat-stream engine (plain PyTorch)
against the JAX package's flat engine, and against the port's own hist
engine.  Exact int32 counts: merges, frequencies and the final stream
must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from shredword_tpu.ops import bpe_ops as jax_ops
from shredword_tpu_torch.ops import bpe_hist, bpe_ops


def _rand_corpus(seed, n_words=300, alpha=6, max_len=12):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 60, n_words).astype(np.int32)[word_id]
    return tokens, word_id, wcount


def _runs_corpus():
    words = [b"aaaa", b"aaa", b"aa", b"baab", b"aabb", b"aaaaaaa"]
    tokens = np.concatenate(
        [np.frombuffer(w, np.uint8).astype(np.int32) for w in words])
    word_id = np.repeat(np.arange(len(words), dtype=np.int32),
                        [len(w) for w in words])
    return tokens, word_id, np.asarray([7, 5, 3, 2, 9, 4], np.int32)[word_id]


def _jax_flat(tokens, word_id, wcount, target, unk, minf, n_prev):
    cap = max(1024, 1 << int(np.ceil(np.log2(max(len(tokens), 2)))))
    state = jax_ops.make_state(tokens, word_id, wcount, cap)
    ts = jax_ops.train_init(state, max(target, 1), n_prev_merges=n_prev)
    ts = jax_ops.train_loop(ts, jnp.int32(unk), jnp.int32(minf),
                            target_merges=target, max_steps=target + 4)
    n = int(ts.n_merges)
    length = int(ts.corpus.length)
    return (np.asarray(ts.merges)[n_prev:n],
            np.asarray(ts.merge_freqs)[n_prev:n],
            np.asarray(ts.corpus.tokens)[:length],
            np.asarray(ts.corpus.word_id)[:length])


def _port_flat(tokens, word_id, wcount, target, unk, minf, n_prev,
               max_steps):
    ts = bpe_ops.train_init(bpe_ops.make_state(tokens, word_id, wcount,
                                               device="cpu"),
                            max(target, 1), n_prev_merges=n_prev)
    while True:
        n_before = ts.n_merges
        ts = bpe_ops.train_loop(ts, unk, minf, target_merges=target,
                                max_steps=max_steps)
        if ts.done or ts.n_merges in (n_before, target):
            break
    n = ts.n_merges
    return (ts.merges[n_prev:n], ts.merge_freqs[n_prev:n],
            ts.corpus.tokens.numpy(), ts.corpus.word_id.numpy())


CASES = {
    **{f"seed{s}": (lambda s=s: _rand_corpus(s), 40, -1, 2, 0)
       for s in range(3)},
    "runs": (_runs_corpus, 10, -1, 2, 0),
    "unk_byte": (lambda: _rand_corpus(7, n_words=120, alpha=5),
                 20, 99, 2, 0),
    "unk_minus_one": (lambda: _rand_corpus(5, alpha=7), 30, -1, 3, 0),
    "exhausted": (lambda: _rand_corpus(9), 40, -1, 10**9, 0),
    "n_prev": (lambda: _rand_corpus(4), 40, -1, 2, 11),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_steps", [64, 7])
def test_flat_matches_jax_flat(case, max_steps):
    make, target, unk, minf, n_prev = CASES[case]
    tokens, word_id, wcount = make()
    if unk == -1 and case == "unk_minus_one":
        tokens = np.where(tokens == 99, -1, tokens).astype(np.int32)
    want = _jax_flat(tokens, word_id, wcount, target, unk, minf, n_prev)
    got = _port_flat(tokens, word_id, wcount, target, unk, minf, n_prev,
                     max_steps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["seed0", "runs", "unk_byte"])
def test_flat_matches_port_hist(case):
    make, target, unk, minf, _ = CASES[case]
    tokens, word_id, wcount = make()
    wc_word = wcount[np.searchsorted(word_id, np.arange(word_id[-1] + 1))]
    merges, freqs, _, _ = bpe_hist.hist_train(
        tokens, word_id, wc_word, target_merges=target, unk_id=unk,
        min_pair_freq=minf, device="cpu")
    got = _port_flat(tokens, word_id, wcount, target, unk, minf, 0, 64)
    np.testing.assert_array_equal(got[0], merges)
    np.testing.assert_array_equal(got[1], freqs)
