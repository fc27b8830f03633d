"""Differential tests of the per-merge hist step (K4) and its sparse
variant (K5), and of the loops around them (the sharded chain
``hist_sharded_train`` and the sparse loop ``hist_sparse_train``): the
port's plain PyTorch versions on the CPU against the JAX package's Pallas
kernels in interpret mode, step for step and call by call.  Every value
is an exact integer, so tokens, deltas, counts, presence, tables and
merge sequences must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shredword_tpu.ops import bpe_hist as jax_hist
from shredword_tpu_torch.ops import _kernels, bpe_hist

UNK = 99


def _rand_corpus(seed, n_words=300, alpha=6, max_len=12, unk=None,
                 runs=True):
    """Seeded words over `alpha` letters from 'a', with 'aaaa...' runs
    (a == b merges) and, given unk, an unk byte."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, n_words)
    if runs:
        lens[:8] = max_len
    word_id = np.repeat(np.arange(n_words, dtype=np.int32), lens)
    tokens = rng.randint(97, 97 + alpha, len(word_id)).astype(np.int32)
    if runs:
        tokens[word_id < 8] = 97
    if unk is not None:
        tokens[rng.rand(len(tokens)) < 0.04] = unk
    wc_word = rng.randint(1, 60, n_words).astype(np.int32)
    return tokens, word_id, wc_word


def _layout(seed, **kw):
    tokens, word_id, wc_word = _rand_corpus(seed, **kw)
    return bpe_hist.build_layout(tokens, word_id, wc_word, 64)


def _scal(a, b, new, unk, do=1):
    return torch.tensor([a, b, new, unk, do], dtype=torch.int32)


_JAX_STEPS = {}


def _jax_step(v, L, W, sparse=False):
    """One compiled JAX step per shape (interpret mode)."""
    key = (v, L, W, sparse)
    if key not in _JAX_STEPS:
        make = (jax_hist.make_merge_step_sparse if sparse
                else jax_hist.make_merge_step)
        _JAX_STEPS[key] = make(v, L, W, interpret=True)
    return _JAX_STEPS[key]


# name: (corpus arguments, unk id); L 16 up to 16 tokens a word, else 32
STEP_CASES = {
    "L16": (dict(seed=0), -1),
    "L16_unk": (dict(seed=1, unk=UNK), UNK),
    "L32": (dict(seed=2, max_len=30, alpha=4), -1),
    "L32_unk": (dict(seed=3, max_len=30, alpha=4, unk=UNK), UNK),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_merge_step_matches_jax(case):
    """K4's plain version against make_merge_step(interpret=True) over a
    chain of merges: the best pair, an a == b run pair ('a', 'a'), a
    pair next to unk, and a pair that occurs nowhere."""
    corpus_kw, unk = STEP_CASES[case]
    c = _layout(**corpus_kw)
    L, W = c.tw.shape
    v = 384
    step = _jax_step(v, L, W)
    tw_j = jnp.asarray(c.tw)
    tw_t, wc_t, _ = bpe_hist.state_from_jax(c.tw, c.wcount,
                                            np.zeros((v, v), np.int32),
                                            device="cpu")
    hist = bpe_hist.init_hist(tw_t, wc_t, unk, v)
    a0, b0 = divmod(int(hist.view(-1).argmax()), v)
    pairs = [(a0, b0), (97, 97), (256, 97), (98, 97), (97, UNK),
             (120, 121)]
    for i, (a, b) in enumerate(pairs):
        new = 256 + i
        tw_j, dl, dr, nm = step(tw_j, jnp.asarray(c.wcount),
                                jnp.array([a, b, new, unk], jnp.int32))
        out = _kernels.hist_merge_step_plain(tw_t, wc_t,
                                             _scal(a, b, new, unk), v=v)
        np.testing.assert_array_equal(tw_t.numpy(), np.asarray(tw_j))
        np.testing.assert_array_equal(out[:v].numpy(), np.asarray(dl)[:, 0])
        np.testing.assert_array_equal(out[v:2 * v].numpy(),
                                      np.asarray(dr)[:, 0])
        assert int(out[2 * v]) == int(np.asarray(nm)[0, 0])
    assert int(np.asarray(nm)[0, 0]) == 0       # (120, 121) never occurs
    # do == 0 changes nothing
    before = tw_t.clone()
    out = _kernels.hist_merge_step_plain(tw_t, wc_t,
                                         _scal(97, 97, 300, unk, 0), v=v)
    assert torch.equal(tw_t, before) and not out.any()


def test_apply_hist_updates_matches_jax():
    """The five table updates in the JAX order, with a == b and with
    neighbours that are a, b or new themselves."""
    rng = np.random.RandomState(0)
    v = 384
    for a, b, new in [(97, 98, 256), (97, 97, 257), (256, 97, 258),
                      (98, 256, 259), (259, 259, 260)]:
        hist = rng.randint(0, 1000, (v, v)).astype(np.int32)
        dl = np.zeros(v, np.int32)
        dr = np.zeros(v, np.int32)
        for x in (a, b, new, 97, 100):
            dl[x] = rng.randint(1, 50)
            dr[x] = rng.randint(1, 50)
        want = np.asarray(jax_hist.apply_hist_updates(
            jnp.asarray(hist), a, b, new, jnp.asarray(dl), jnp.asarray(dr)))
        table = torch.tensor(hist)
        got = _kernels.apply_hist_updates(table, a, b, new,
                                          torch.tensor(dl), torch.tensor(dr))
        assert got is table                              # in place
        np.testing.assert_array_equal(got.numpy(), want)


_JAX_LOOPS = {}


@pytest.mark.parametrize("unk,minf,max_steps,target,n_prev", [
    (-1, 2, 16, 40, 0),
    (UNK, 2, 7, 30, 0),
    (-1, 150, 16, 60, 0),      # min_pair_freq stops the loop
    (-1, 2, 16, 40, 9),        # resume: ids continue at 256 + n_prev
])
def test_train_loop_matches_jax(unk, minf, max_steps, target, n_prev):
    """The port's make_train_loop against JAX's, call by call: merges,
    frequencies, counters, tokens and table."""
    c = _layout(4, unk=None if unk < 0 else unk, n_words=250)
    L, W = c.tw.shape
    v = 384
    key = (v, L, W, target, max_steps)
    if key not in _JAX_LOOPS:
        _JAX_LOOPS[key] = jax_hist.make_train_loop(
            v, L, W, target_merges=target, max_steps=max_steps,
            interpret=True)
    jloop = _JAX_LOOPS[key]
    js = jax_hist.hist_train_init(
        jax_hist.HistCorpus(jnp.asarray(c.tw), jnp.asarray(c.wcount)),
        unk, max(target, 1), v)._replace(n_merges=jnp.int32(n_prev))
    loop = bpe_hist.make_train_loop(v, L, W, target_merges=target,
                                    max_steps=max_steps)
    ts = bpe_hist.hist_train_init(c, unk, target, v, device="cpu")._replace(
        n_merges=n_prev)
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    for _ in range(8):
        js = jloop(js, jnp.int32(unk), jnp.int32(minf))
        ts = loop(ts, unk, minf)
        assert ts.n_merges == int(js.n_merges)
        assert ts.done == bool(js.done)
        np.testing.assert_array_equal(ts.merges, np.asarray(js.merges))
        np.testing.assert_array_equal(ts.merge_freqs,
                                      np.asarray(js.merge_freqs))
        np.testing.assert_array_equal(ts.corpus.tw.numpy(),
                                      np.asarray(js.corpus.tw))
        np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    assert ts.n_merges > n_prev
    assert ts.done or ts.n_merges == target


def _sparse_layout():
    """Three chunks of 512 words; 'x' and 'y' only in the first chunk and
    'y z' only in the last, so flagged and skipped chunks both occur."""
    tokens, word_id, wc_word = _rand_corpus(6, n_words=1400, alpha=5)
    first = np.isin(word_id, np.arange(0, 40))
    tokens[first & (np.arange(len(tokens)) % 3 == 0)] = ord("x")
    tokens[first & (np.arange(len(tokens)) % 3 == 1)] = ord("y")
    last = np.isin(word_id, np.arange(1300, 1340))
    tokens[last & (np.arange(len(tokens)) % 2 == 0)] = ord("y")
    tokens[last & (np.arange(len(tokens)) % 2 == 1)] = ord("z")
    return bpe_hist.build_layout(tokens, word_id, wc_word, 64)


def test_presence_matches_jax():
    c = _sparse_layout()
    v = 384
    want = jax_hist.build_presence(c.tw, v)
    got = bpe_hist.build_presence(c.tw, v)
    assert got.dtype == np.int8 and got.shape == (v, c.tw.shape[1] // 512)
    np.testing.assert_array_equal(got, want[:, 0, :].T)
    tw_t, wc_t, hist_t, pres_t = bpe_hist.state_from_jax(
        c.tw, c.wcount, np.zeros((v, v), np.int32), device="cpu",
        presence=want)
    np.testing.assert_array_equal(pres_t.numpy(), got)
    back = bpe_hist.state_to_jax(tw_t, wc_t, hist_t, presT=pres_t)
    np.testing.assert_array_equal(back[3], want)


@pytest.mark.parametrize("unk", [-1, ord("b")])
def test_sparse_step_matches_jax(unk):
    """K5's plain version against make_merge_step_sparse(interpret=True)
    through the presence converter: tokens, presence, deltas and match
    count after each merge of a chain that flags one chunk, all chunks,
    a chunk with no match, and none."""
    c = _sparse_layout()
    L, W = c.tw.shape
    v = 384
    step = _jax_step(v, L, W, sparse=True)
    pres_j = jnp.asarray(jax_hist.build_presence(c.tw, v))
    tw_j = jnp.asarray(c.tw)
    tw_t, wc_t, _, pres_t = bpe_hist.state_from_jax(
        c.tw, c.wcount, np.zeros((v, v), np.int32), device="cpu",
        presence=np.asarray(pres_j))
    pairs = [(ord("x"), ord("y")), (97, 97), (ord("y"), ord("z")),
             (ord("y"), ord("x")), (ord("z"), ord("x")), (256, 97),
             (ord("x"), ord("z"))]
    for i, (a, b) in enumerate(pairs):
        new = 256 + i
        flags = pres_j[:, 0, a] * pres_j[:, 0, b]
        tw_j, pres_j, dl, dr, nm = step(
            tw_j, jnp.asarray(c.wcount), pres_j, flags,
            jnp.array([a, b, new, unk], jnp.int32))
        out = _kernels.hist_merge_step_sparse_plain(
            tw_t, wc_t, pres_t, _scal(a, b, new, unk), v=v)
        np.testing.assert_array_equal(tw_t.numpy(), np.asarray(tw_j))
        np.testing.assert_array_equal(
            bpe_hist.state_to_jax(tw_t, wc_t, torch.zeros(1),
                                  presT=pres_t)[3], np.asarray(pres_j))
        np.testing.assert_array_equal(out[:v].numpy(), np.asarray(dl)[:, 0])
        np.testing.assert_array_equal(out[v:2 * v].numpy(),
                                      np.asarray(dr)[:, 0])
        assert int(out[2 * v]) == int(np.asarray(nm)[0, 0])
    # the presence stays exact: it equals a rebuild from the tokens
    np.testing.assert_array_equal(pres_t.numpy(),
                                  bpe_hist.build_presence(tw_t.numpy(), v))


def test_sparse_train_loop_matches_dense_loop():
    """make_train_loop_sparse and make_train_loop, call by call, from one
    state: the same merges, tokens and table; presence stays exact."""
    c = _sparse_layout()
    L, W = c.tw.shape
    v, target = 384, 40
    dense = bpe_hist.make_train_loop(v, L, W, target_merges=target,
                                     max_steps=9)
    sparse = bpe_hist.make_train_loop_sparse(v, L, W, target_merges=target,
                                             max_steps=9)
    td = bpe_hist.hist_train_init(c, -1, target, v, device="cpu")
    tsp = bpe_hist.hist_train_init(c, -1, target, v, device="cpu")
    pres = torch.tensor(bpe_hist.build_presence(c.tw, v))
    for _ in range(5):
        td = dense(td, -1, 2)
        tsp = sparse(tsp, pres, -1, 2)
        np.testing.assert_array_equal(tsp.merges, td.merges)
        assert torch.equal(tsp.corpus.tw, td.corpus.tw)
        assert torch.equal(tsp.hist, td.hist)
    assert td.n_merges == target
    np.testing.assert_array_equal(
        pres.numpy(), bpe_hist.build_presence(tsp.corpus.tw.numpy(), v))


@pytest.mark.parametrize("seed", [0, 5])
def test_sparse_hist_train_matches_jax_and_dense(seed):
    """hist_train(sparse=True) against the JAX package's sparse engine
    (interpret mode) and the port's dense engine, mirroring
    tests/test_hist_engine.py::test_sparse_kernel_matches_dense."""
    tokens, word_id, wc_word = _rand_corpus(seed, n_words=250, runs=False)
    kw = dict(target_merges=30, unk_id=-1, min_pair_freq=2)
    want = jax_hist.hist_train(tokens, word_id, wc_word, interpret=True,
                               sparse=True, _cache={}, **kw)
    got = bpe_hist.hist_train(tokens, word_id, wc_word, sparse=True,
                              device="cpu", **kw)
    dense = bpe_hist.hist_train(tokens, word_id, wc_word, device="cpu", **kw)
    for w, g, d in zip(want, got, dense):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, d)


def test_sparse_hist_train_resume_and_progress():
    """With n_prev_merges the sparse request runs the fused engine (as in
    the JAX package); without, progress_cb sees every merge."""
    tokens, word_id, wc_word = _rand_corpus(7, n_words=200)
    kw = dict(target_merges=30, unk_id=-1, min_pair_freq=2,
              max_steps_per_call=8, device="cpu")
    seen = []
    got = bpe_hist.hist_train(tokens, word_id, wc_word, sparse=True,
                              progress_cb=lambda m, f: seen.append(len(m)),
                              **kw)
    dense = bpe_hist.hist_train(tokens, word_id, wc_word, **kw)
    for g, d in zip(got, dense):
        np.testing.assert_array_equal(g, d)
    assert seen[-1] == len(got[0]) == 30 and len(seen) >= 4
    n0 = _kernels.hist_fused_train.launches
    resumed = bpe_hist.hist_train(tokens, word_id, wc_word, sparse=True,
                                  n_prev_merges=5, **kw)
    assert _kernels.hist_fused_train.launches == n0    # CPU: plain version
    assert len(resumed[0]) == 25


# name: (unk id, min_pair_freq, steps per call, target merges)
SPARSE_CALL_CASES = {
    "steps8": (-1, 2, 8, 30),
    "unk_steps5": (ord("b"), 2, 5, 24),
    "min_freq_stop": (-1, 1500, 6, 40),    # stops after 23 merges
}


@pytest.mark.parametrize("case", sorted(SPARSE_CALL_CASES))
def test_sparse_wrapper_matches_jax_loop(case):
    """hist_sparse_train (the K5 wrapper, CPU: its plain version) against
    JAX make_train_loop_sparse (interpret mode), call by call as
    drive_calls makes them: the merges of each call's records, tokens,
    table and presence; then a call past the end changes nothing and
    merges nothing."""
    unk, minf, steps, target = SPARSE_CALL_CASES[case]
    c = _sparse_layout()
    L, W = c.tw.shape
    v = 384
    jloop = jax_hist.make_train_loop_sparse(
        v, L, W, target_merges=target, max_steps=steps, interpret=True)
    js = [jnp.asarray(c.tw), jnp.asarray(jax_hist.build_presence(c.tw, v)),
          jax_hist.init_hist(jax_hist.HistCorpus(jnp.asarray(c.tw),
                                                 jnp.asarray(c.wcount)),
                             jnp.int32(unk), v=v),
          jnp.zeros((target, 2), jnp.int32), jnp.zeros(target, jnp.int32),
          jnp.int32(0), jnp.bool_(False)]
    ts = bpe_hist.hist_train_init(c, unk, target, v, device="cpu")
    (tw, wc), hist = ts.corpus, ts.hist
    pres = torch.tensor(bpe_hist.build_presence(c.tw, v))
    kw = dict(unk=unk, min_freq=minf)
    n, done = 0, 0
    while n < target and not done:
        allowed = target - n
        recs = _kernels.hist_sparse_train(
            tw, wc, hist, pres, n_done=n, init_done=0, allowed=allowed,
            steps=min(steps, allowed), **kw).numpy()
        js = list(jloop(js[0], jnp.asarray(c.wcount), *js[1:],
                        jnp.int32(unk), jnp.int32(minf)))
        did = recs[:, 3] != 0
        assert list(did) == sorted(did, reverse=True)   # did is sticky
        n_j = int(js[5])
        np.testing.assert_array_equal(recs[did, :2],
                                      np.asarray(js[3])[n:n_j])
        np.testing.assert_array_equal(recs[did, 2], np.asarray(js[4])[n:n_j])
        n, done = n_j, int(did.sum() < len(recs))
        assert done == bool(js[6])
        np.testing.assert_array_equal(tw.numpy(), np.asarray(js[0]))
        np.testing.assert_array_equal(
            bpe_hist.state_to_jax(tw, wc, hist, presT=pres)[3],
            np.asarray(js[1]))
        np.testing.assert_array_equal(hist.numpy(), np.asarray(js[2]))
    assert (n < target) == (case == "min_freq_stop") and n > 0
    before = [x.clone() for x in (tw, hist, pres)]
    recs = _kernels.hist_sparse_train(tw, wc, hist, pres, n_done=n,
                                      init_done=1, allowed=0, steps=4, **kw)
    assert not recs[:, 3].any() and (recs[:, 2] == recs[0, 2]).all()
    assert all(torch.equal(x, y) for x, y in zip(before, (tw, hist, pres)))


def test_step_wrappers_reject_bad_input():
    tw = torch.full((16, 1024), bpe_hist.PAD, dtype=torch.int16)
    wc = torch.zeros(1024, dtype=torch.int32)
    hist = torch.zeros((384, 384), dtype=torch.int32)
    pres = torch.zeros((384, 2), dtype=torch.int8)
    kw = dict(unk=-1, min_freq=2, n_done=0, init_done=0, allowed=8,
              steps=8)
    for wrapper, extra in ((_kernels.hist_sharded_train, ()),
                           (_kernels.hist_sparse_train, (pres,))):
        with pytest.raises(TypeError):
            wrapper(tw.int(), wc, hist, *extra, **kw)
        with pytest.raises(ValueError, match="L must be"):
            wrapper(tw[:12].contiguous(), wc, hist, *extra, **kw)
        with pytest.raises(ValueError, match="shape"):
            wrapper(tw, wc, hist[:, :100].contiguous(), *extra, **kw)
        with pytest.raises(ValueError, match="exceed"):
            wrapper(tw, wc, hist, *extra, **{**kw, "n_done": 127})
        recs = wrapper(tw, wc, hist, *extra, **kw)       # nothing to merge
        assert recs.shape == (8, 4) and not recs.any()
    with pytest.raises(ValueError, match="presT"):
        _kernels.hist_sparse_train(tw, wc, hist, pres[:, :1], **kw)
    with pytest.raises(ValueError, match="presT"):
        _kernels.hist_sparse_train(tw[:, :1000].contiguous(), wc[:1000],
                                   hist, pres, **kw)
    assert not _kernels.hist_merge_step_sparse_plain(
        tw, wc, pres, _scal(97, 98, 256, -1), v=384).any()
