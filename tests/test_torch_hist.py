"""Differential tests: the port's hist engine (shredword_tpu_torch, plain
PyTorch version of the fused kernel on the CPU) against the JAX
package's hist engine (Pallas in interpret mode).  Every count is int32,
so merges, frequencies, tables and tokens must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shredword_tpu.ops import bpe_hist as jax_hist
from shredword_tpu_torch.ops import _kernels, bpe_hist


def _rand_corpus(seed, n_words=300, alpha=6, max_len=12):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    wc_word = rng.randint(1, 60, n_words).astype(np.int32)
    return tokens, word_id, wc_word


def _overlap_corpus():
    # 'aaaa'-style runs exercise the greedy overlap rule and its deltas
    words = [b"aaaa", b"aaa", b"aa", b"baab", b"aabb"]
    tokens = np.concatenate(
        [np.frombuffer(w, np.uint8).astype(np.int32) for w in words])
    word_id = np.repeat(np.arange(len(words), dtype=np.int32),
                        [len(w) for w in words])
    return tokens, word_id, np.asarray([7, 5, 3, 2, 9], np.int32)


def _force_big(monkeypatch):
    monkeypatch.setattr(jax_hist, "_fused_vmem_bytes",
                        lambda *a, **k: 1 << 60)


# name: (corpus, hist_train keyword arguments, force the big variant)
CASES = {
    **{f"seed{s}": (lambda s=s: _rand_corpus(s), dict(target_merges=40),
                    False) for s in range(4)},
    "overlap_runs": (_overlap_corpus, dict(target_merges=10), False),
    "unk_byte": (lambda: _rand_corpus(7, n_words=120, alpha=5),
                 dict(target_merges=20, unk_id=99), False),
    "chunked": (lambda: _rand_corpus(8, n_words=600, alpha=8),
                dict(target_merges=40, max_steps_per_call=7), False),
    "exhausted": (lambda: _rand_corpus(9),
                  dict(target_merges=40, min_pair_freq=10**9), False),
    "min_freq_stop": (lambda: _rand_corpus(10, n_words=200),
                      dict(target_merges=60, min_pair_freq=150,
                           max_steps_per_call=16), False),
    "n_prev": (lambda: _rand_corpus(3),
               dict(target_merges=40, n_prev_merges=9), False),
    "rows32": (lambda: _rand_corpus(13, n_words=150, alpha=4, max_len=30),
               dict(target_merges=30), False),
    "big": (lambda: _rand_corpus(11, n_words=600, alpha=8),
            dict(target_merges=40), True),
    "big_chunked": (lambda: _rand_corpus(12, n_words=400, alpha=7),
                    dict(target_merges=30, max_steps_per_call=9), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hist_train_matches_jax(case, monkeypatch):
    make, kw, big = CASES[case]
    tokens, word_id, wc_word = make()
    kw = {"unk_id": -1, "min_pair_freq": 2, **kw}
    if big:
        _force_big(monkeypatch)
    want = jax_hist.hist_train(tokens, word_id, wc_word, interpret=True,
                               _cache={}, **kw)
    got = bpe_hist.hist_train(tokens, word_id, wc_word, device="cpu", **kw)
    assert len(want) == len(got) == 4
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(got[0]) <= kw["target_merges"]
    # the lazy final corpus is the eager one
    merges, freqs, final_fn = bpe_hist.hist_train(
        tokens, word_id, wc_word, device="cpu", lazy_final=True, **kw)
    np.testing.assert_array_equal(merges, got[0])
    for w, g in zip(want[2:], final_fn()):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_long_word_declines_layout():
    tokens = np.arange(100, dtype=np.int32) % 26 + 97
    word_id = np.zeros(100, np.int32)  # one 100-byte word
    assert bpe_hist.hist_train(tokens, word_id, np.ones(1, np.int32),
                               target_merges=4, max_word_len=64,
                               device="cpu") is None


def test_vocab_beyond_table_raises():
    """Beyond the fused engine's table (v > 4096) hist_train routes to
    the giant engine, as the JAX package does, and gives its results."""
    tokens, word_id, wc_word = _rand_corpus(0, n_words=40, max_len=6)
    kw = dict(target_merges=4864 - 256, unk_id=-1, min_pair_freq=1,
              max_steps_per_call=64)
    want = jax_hist.hist_train(tokens, word_id, wc_word, interpret=True,
                               _cache={}, **kw)
    got = bpe_hist.hist_train(tokens, word_id, wc_word, device="cpu", **kw)
    assert len(got[0]) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_hist_train_respects_explicit_steps_for_giant(monkeypatch):
    from shredword_tpu_torch.ops import bpe_giant

    tokens, word_id, wc_word = _rand_corpus(0)
    seen = []
    monkeypatch.setattr(bpe_giant, "giant_train",
                        lambda *a, **k: seen.append(k["steps_per_call"]))
    for steps in (64, None):
        assert bpe_hist.hist_train(tokens, word_id, wc_word,
                                   target_merges=5000, device="cpu",
                                   max_steps_per_call=steps) is None
    assert seen == [64, 4096]


def _fused_layout(seed, n_words, alpha):
    tokens, word_id, wc_word = _rand_corpus(seed, n_words=n_words,
                                            alpha=alpha)
    c = jax_hist.build_layout(tokens, word_id, wc_word, 64, min_len=16)
    L, W = c.tw.shape
    fc = jax_hist.FUSED_CHUNK
    nc = -(-W // fc)
    tw = np.pad(c.tw, ((0, 0), (0, nc * fc - W)),
                constant_values=jax_hist.PAD)
    wc = np.pad(c.wcount, ((0, 0), (0, nc * fc - W)))
    tw3 = np.ascontiguousarray(tw.reshape(L, nc, fc).transpose(1, 0, 2))
    wc3 = np.ascontiguousarray(wc.reshape(1, nc, fc).transpose(1, 0, 2))
    return tw3, wc3


@pytest.mark.parametrize("variant,unk,minf", [
    ("small", -1, 2), ("small", 99, 2), ("small", -1, 400),
    ("big", -1, 2), ("big", 100, 3)])
def test_fused_step_for_step(variant, unk, minf):
    """The port's fused call and the JAX kernel, driven call by call from
    one state (carried over with state_from_jax), give identical
    records, tables and tokens after every call, including calls cut
    short by `allowed` and by exhaustion."""
    tw3, wc3 = _fused_layout(5, n_words=600, alpha=8)
    nc, L, fc = tw3.shape
    v, steps, target = 384, 16, 40
    hist = jax_hist._hist_from_3d(jnp.asarray(tw3), jnp.asarray(wc3),
                                  jnp.int32(unk), v)
    if variant == "small":
        fused = jax_hist.make_fused_train(v, L, nc, steps, fc=fc,
                                          interpret=True)
    else:
        fused = jax_hist.make_fused_train_big(v, L, nc, steps, fc=fc,
                                              rb=128, interpret=True)
    tw_t, wc_t, hist_t = bpe_hist.state_from_jax(tw3, wc3, hist,
                                                 device="cpu")
    np.testing.assert_array_equal(
        bpe_hist.init_hist(tw_t, wc_t, unk, v).numpy(), np.asarray(hist))
    tw_j, hist_j = jnp.asarray(tw3), hist
    n_done, done = 0, 0
    for _ in range(4):
        allowed = target - n_done
        scal = jnp.array([unk, minf, n_done, done, allowed], jnp.int32)
        tw_j, hist_j, mrows = fused(tw_j, jnp.asarray(wc3), hist_j, scal)
        want = np.asarray(mrows)[::8, :4]
        got = _kernels.hist_fused_train(
            tw_t, wc_t, hist_t, unk=unk, min_freq=minf, n_done=n_done,
            init_done=done, allowed=allowed, steps=steps)
        np.testing.assert_array_equal(got.numpy(), want)
        tw_p, wc_p, hist_p = bpe_hist.state_to_jax(tw_t, wc_t, hist_t,
                                                   fc=fc)
        np.testing.assert_array_equal(hist_p, np.asarray(hist_j))
        np.testing.assert_array_equal(tw_p, np.asarray(tw_j))
        np.testing.assert_array_equal(wc_p, wc3)
        n_new = int(want[:, 3].sum())
        done = int(n_new < min(steps, allowed))
        n_done += n_new
    assert n_done > 0


def test_state_round_trip_2d():
    tokens, word_id, wc_word = _rand_corpus(4)
    c = jax_hist.build_layout(tokens, word_id, wc_word, 64, min_len=16)
    hist = np.arange(384 * 384, dtype=np.int32).reshape(384, 384)
    tw_t, wc_t, hist_t = bpe_hist.state_from_jax(c.tw, c.wcount, hist,
                                                 device="cpu")
    assert tw_t.dtype == torch.int16 and wc_t.shape == (c.tw.shape[1],)
    for a, b in zip(bpe_hist.state_to_jax(tw_t, wc_t, hist_t),
                    (c.tw, c.wcount, hist)):
        np.testing.assert_array_equal(a, b)


def test_port_layout_matches_jax():
    tokens, word_id, wc_word = _rand_corpus(6, max_len=20)
    want = jax_hist.build_layout(tokens, word_id, wc_word, 64, min_len=16)
    got = bpe_hist.build_layout(tokens, word_id, wc_word, 64)
    np.testing.assert_array_equal(got.tw, want.tw)
    np.testing.assert_array_equal(got.wcount, want.wcount)
