"""Differential tests: the port's giant engine (shredword_tpu_torch, plain
PyTorch version of csrc/giant.cu on the CPU) against the JAX package's
giant engine (Pallas in interpret mode).  Every count is int32, so
merges, frequencies, final corpora, layouts and the kernel state after
every call must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shredword_tpu.ops import bpe_giant as jax_giant
from shredword_tpu_torch.ops import _kernels, bpe_giant


def _corpus(seed, n_words=60, vmax=250, maxlen=9):
    """gen_corpus of tests/test_giant_engine.py: random byte words."""
    rng = np.random.default_rng(seed)
    toks, wid, wcnt = [], [], []
    for w in range(n_words):
        ln = int(rng.integers(1, maxlen))
        toks.extend(rng.integers(0, vmax, ln).tolist())
        wid.extend([w] * ln)
        wcnt.append(int(rng.integers(1, 50)))
    return (np.array(toks, np.int32), np.array(wid, np.int32),
            np.array(wcnt, np.int32))


def _letters(seed, n_words=600, alpha=6, max_len=8, runs=0):
    """Words over a small alphabet, so pairs repeat across chunks; the
    first `runs` words are 'aaaa...' runs (the greedy overlap rule)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, max_len + 1, n_words)
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.integers(97, 97 + alpha, len(word_id)).astype(np.int32)
    tokens[word_id < runs] = 97
    return tokens, word_id, rng.integers(1, 50, n_words).astype(np.int32)


def _replayed(seed, n_prev):
    """A corpus with n_prev merges already applied, as a resumed run
    passes it (ids up to 256 + n_prev)."""
    tokens, word_id, wc = _letters(seed, n_words=400)
    _, _, tokens, word_id = bpe_giant.giant_train(
        tokens, word_id, wc, target_merges=n_prev, min_pair_freq=2,
        device="cpu")
    return tokens, word_id, wc


# name: (corpus, giant_train keyword arguments)
CASES = {
    "seed0": (lambda: _corpus(0), dict(target_merges=40, steps_per_call=32)),
    "seed2_unk7": (lambda: _corpus(2),               # unk is a live byte
                   dict(target_merges=30, unk_id=7, steps_per_call=32)),
    "seed4_minf1": (lambda: _corpus(4), dict(target_merges=50,
                                             min_pair_freq=1,
                                             steps_per_call=32)),
    "multicall": (lambda: _corpus(1, n_words=50),
                  dict(target_merges=48, min_pair_freq=1,
                       steps_per_call=7)),
    "v4864": (lambda: _corpus(5, n_words=40, maxlen=6),  # exhausts early
              dict(target_merges=4864 - 256, min_pair_freq=1,
                   steps_per_call=64)),
    "cw512": (lambda: _letters(11), dict(target_merges=24, steps_per_call=8,
                                         chunk_width=512)),
    "cw1024": (lambda: _letters(11), dict(target_merges=24, steps_per_call=8,
                                          chunk_width=1024)),
    "cw2048": (lambda: _letters(11), dict(target_merges=24, steps_per_call=8,
                                          chunk_width=2048)),
    "n_prev": (lambda: _replayed(12, 9),
               dict(target_merges=30, n_prev_merges=9, steps_per_call=8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_giant_train_matches_jax(case):
    make, kw = CASES[case]
    tokens, word_id, wc = make()
    kw = {"unk_id": -1, "min_pair_freq": 2, **kw}
    want = jax_giant.giant_train(tokens, word_id, wc, interpret=True,
                                 _cache={}, **kw)
    got = bpe_giant.giant_train(tokens, word_id, wc, device="cpu", **kw)
    assert len(want) == len(got) == 4 and len(got[0]) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the lazy final corpus is the eager one
    merges, freqs, final_fn = bpe_giant.giant_train(
        tokens, word_id, wc, device="cpu", lazy_final=True, **kw)
    np.testing.assert_array_equal(merges, got[0])
    for w, g in zip(want[2:], final_fn()):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_chunk_width_and_resume_agree():
    """Chunk widths give one merge sequence, and a resumed run continues
    the uninterrupted one."""
    tokens, word_id, wc = _letters(12, n_words=400)
    full = [bpe_giant.giant_train(tokens, word_id, wc, target_merges=30,
                                  chunk_width=cw, steps_per_call=8,
                                  device="cpu")
            for cw in (512, 1024)]
    np.testing.assert_array_equal(full[0][0], full[1][0])
    np.testing.assert_array_equal(full[0][2], full[1][2])
    rt, rw, _ = _replayed(12, 9)
    m, f, t, w = bpe_giant.giant_train(rt, rw, wc, target_merges=30,
                                       n_prev_merges=9, steps_per_call=8,
                                       device="cpu")
    np.testing.assert_array_equal(m, full[0][0][9:])
    np.testing.assert_array_equal(f, full[0][1][9:])
    np.testing.assert_array_equal(t, full[0][2])
    np.testing.assert_array_equal(w, full[0][3])


def _overlap_corpus():
    words = [b"aaaa", b"aaaaaaa", b"aa", b"baab", b"aabb", b"abab"] * 150
    tokens = np.concatenate(
        [np.frombuffer(w, np.uint8).astype(np.int32) for w in words])
    word_id = np.repeat(np.arange(len(words), dtype=np.int32),
                        [len(w) for w in words])
    wc = (np.arange(len(words), dtype=np.int32) % 13) + 1
    return tokens, word_id, wc


# name: (corpus, unk, min_pair_freq, merges per call, target)
STEP_CASES = {
    "unk_byte": (lambda: _letters(3, n_words=700, alpha=7), 99, 2, 16, 40),
    "min_freq_stop": (lambda: _letters(4, n_words=700), -1, 150, 16, 60),
    "allowed_cut": (lambda: _letters(5, n_words=700), -1, 2, 16, 37),
    "overlap_runs": (_overlap_corpus, -1, 2, 8, 20),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_giant_step_for_step(case):
    """The port's call and the JAX kernel, driven call by call from one
    state (carried over with giant_state_from_jax), give identical
    records (all five lanes), tokens, tables, presence and row-max
    bounds after every call, including calls cut short by `allowed`, by
    min_pair_freq and by the sticky done flag."""
    make, unk, minf, steps, target = STEP_CASES[case]
    tokens, word_id, wc = make()
    v, cw = 1024, 512
    lay = jax_giant.build_giant_layout(tokens, word_id, wc, v, cw=cw)
    L, W = lay.tw.shape
    NC = W // cw
    nc_used = -(-lay.n_words // cw)
    assert nc_used > 1
    hist4, rowmax = jax_giant._giant_init_tables(
        jnp.asarray(lay.tw), jnp.asarray(lay.wc), jnp.int32(unk), v=v)
    state = bpe_giant.giant_state_from_jax(lay.tw, lay.wc, hist4,
                                           lay.presT, rowmax, device="cpu")
    hist_t, rowmax_t = bpe_giant.init_tables(state[0], state[1], unk, v)
    np.testing.assert_array_equal(hist_t.numpy(), state[2].numpy())
    np.testing.assert_array_equal(rowmax_t.numpy(), state[4].numpy())
    giant = jax_giant.make_giant_train(v, L, NC, steps, interpret=True,
                                       cw=cw)
    jstate = (jnp.asarray(lay.tw), hist4, jnp.asarray(lay.presT), rowmax)
    lens, wc_j = jnp.asarray(lay.lens), jnp.asarray(lay.wc)
    n_done, done = 0, 0
    for _ in range(4):
        allowed = target - n_done
        scal = jnp.array([unk, minf, n_done, done, allowed, nc_used],
                         jnp.int32)
        *jstate, mrows = giant(lens, scal, wc_j, *jstate)
        want = np.asarray(mrows)[::8, :5]
        got = _kernels.giant_train_step(
            *state, unk=unk, min_freq=minf, n_done=n_done, init_done=done,
            allowed=allowed, nc_used=nc_used, steps=steps)
        np.testing.assert_array_equal(got.numpy(), want)
        tw_p, wc_p, hist_p, presT_p, rowmax_p = \
            bpe_giant.giant_state_to_jax(*state)
        np.testing.assert_array_equal(tw_p, np.asarray(jstate[0]))
        np.testing.assert_array_equal(hist_p, np.asarray(jstate[1]))
        np.testing.assert_array_equal(presT_p, np.asarray(jstate[2]))
        np.testing.assert_array_equal(rowmax_p, np.asarray(jstate[3]))
        np.testing.assert_array_equal(wc_p, lay.wc)
        n_new = int(want[:, 3].sum())
        done = int(n_new < min(steps, allowed))
        n_done += n_new
    assert n_done > 0


@pytest.mark.parametrize("cw,v", [(512, 1024), (1024, 2048), (2048, 4096)])
def test_layout_matches_jax(cw, v):
    tokens, word_id, wc = _letters(6, n_words=1500, max_len=20)
    want = jax_giant.build_giant_layout(tokens, word_id, wc, v, cw=cw)
    got = bpe_giant.build_giant_layout(tokens, word_id, wc, v, cw=cw)
    for name in bpe_giant.GiantLayout._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.presT.shape[1] % 128 == 0


@pytest.mark.parametrize("n_words,cw", [(1_500_000, 1024),
                                         (1_500_001, 2048)])
def test_chunk_width_widens_above_1_5m_words(n_words, cw, monkeypatch):
    """Both packages' giant_train lay the corpus out in chunks of 2048
    words above 1,500,000 unique words and of 1024 at or below it (the
    layout builders are replaced, so no large layout is built)."""
    widths = []

    def build(tokens, word_id, wcount, v, max_word_len=64, cw=None):
        widths.append(cw)
        return None

    monkeypatch.setattr(bpe_giant, "build_giant_layout", build)
    monkeypatch.setattr(jax_giant, "build_giant_layout", build)
    tokens = np.array([97, 98], np.int32)
    word_id = np.array([0, n_words - 1], np.int32)
    wc = np.ones(n_words, np.int32)
    assert bpe_giant.giant_train(tokens, word_id, wc, target_merges=10,
                                 device="cpu") is None
    assert jax_giant.giant_train(tokens, word_id, wc, target_merges=10,
                                 interpret=True, _cache={}) is None
    assert widths == [cw, cw]


def _long_word():
    tokens, word_id, wc = _corpus(0, n_words=10)
    return (np.concatenate([tokens, np.ones(100, np.int32)]),
            np.concatenate([word_id,
                            np.full(100, word_id[-1] + 1, np.int32)]),
            np.concatenate([wc, np.ones(1, np.int32)]))


@pytest.mark.parametrize("make,kw", [
    (_long_word, dict(target_merges=10)),                # a 100-token word
    (lambda: _corpus(0, n_words=10), dict(target_merges=40000)),  # v > 32768
    (lambda: _corpus(0, n_words=10), dict(target_merges=10, unk_id=300)),
], ids=["long_word", "vocab", "unk300"])
def test_giant_declines_out_of_envelope(make, kw):
    tokens, word_id, wc = make()
    assert jax_giant.giant_train(tokens, word_id, wc, interpret=True,
                                 **kw) is None
    assert bpe_giant.giant_train(tokens, word_id, wc, device="cpu",
                                 **kw) is None


def test_state_round_trip():
    rng = np.random.default_rng(0)
    v, L, W, NC = 1024, 16, 512 * 128, 128
    arrays = (rng.integers(-3, 300, (L, W)).astype(np.int16),
              rng.integers(0, 99, (1, W)).astype(np.int32),
              rng.integers(0, 99, (v, v // 128, 128)).astype(np.int32),
              rng.integers(0, 2, (v, NC)).astype(np.int8),
              rng.integers(0, 99, (v // 128, 128)).astype(np.int32))
    state = bpe_giant.giant_state_from_jax(*arrays, device="cpu")
    assert [t.shape for t in state] == [(L, W), (W,), (v, v), (v, NC), (v,)]
    for got, want in zip(bpe_giant.giant_state_to_jax(*state), arrays):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_input():
    v, L, cw, NC = 1024, 16, 512, 128
    tw = torch.full((L, cw * NC), _kernels.PAD, dtype=torch.int16)
    wc = torch.zeros(cw * NC, dtype=torch.int32)
    hist = torch.zeros((v, v), dtype=torch.int32)
    presT = torch.zeros((v, NC), dtype=torch.int8)
    rowmax = torch.zeros(v, dtype=torch.int32)
    kw = dict(unk=-1, min_freq=2, n_done=0, init_done=0, allowed=8,
              nc_used=1, steps=8)
    with pytest.raises(TypeError):
        _kernels.giant_train_step(tw, wc, hist, presT.int(), rowmax, **kw)
    with pytest.raises(ValueError, match="L must be"):
        _kernels.giant_train_step(tw[:12].contiguous(), wc, hist, presT,
                                  rowmax, **kw)
    with pytest.raises(ValueError, match="shape"):
        _kernels.giant_train_step(tw, wc, hist, presT, rowmax[:100], **kw)
    with pytest.raises(ValueError, match="nc_used"):
        _kernels.giant_train_step(tw, wc, hist, presT, rowmax,
                                  **{**kw, "nc_used": NC + 1})
    with pytest.raises(ValueError, match="exceed"):
        _kernels.giant_train_step(tw, wc, hist, presT, rowmax,
                                  **{**kw, "n_done": v - 257})
    recs = _kernels.giant_train_step(tw, wc, hist, presT, rowmax, **kw)
    assert recs.shape == (8, 5) and not recs[:, 3].any()
    assert _kernels.giant_train_step.launches == 0
