"""The flat route on corpora of long words (``bench.make_long_corpus``:
CJK clauses of 2-40 characters, about half over 64 bytes): the port's
``BPETrainer`` auto-routes them to the flat engine, whose loop is F1
(``csrc/flat.cu``) on the card and its plain version here, and must give
the JAX package's merges, frequencies and .model/.vocab bytes, also on
resume and at a min_pair_freq stop."""

import hashlib

import numpy as np
import pytest
import torch

from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu_torch import BPETrainer
from shredword_tpu_torch.bench import (LONG_CORPUS_BYTES, LONG_CORPUS_SHA256,
                                       make_long_corpus)
from shredword_tpu_torch.ops import _kernels, bpe_ops
from torch_flat_cases import FLAT_CASES, flat_corpus

# target vocab, unk_id, coverage (0.995: some rare bytes become unk),
# min_pair_freq
CFG = (640, 0, 0.995, 2)
STOP_CFG = (640, 0, 0.995, 30)     # stops before its target


def _save(trainer, tmp_path, tag):
    mp, vp = tmp_path / f"{tag}.model", tmp_path / f"{tag}.vocab"
    trainer.save(str(mp), str(vp))
    return mp.read_bytes(), vp.read_bytes()


def _out(trainer, tmp_path, tag):
    return (trainer.merges.tolist(), trainer.merge_freqs.tolist(),
            _save(trainer, tmp_path, tag))


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("long") / "long.txt"
    make_long_corpus(str(path), raw_mb=0.05)
    return str(path)


@pytest.fixture(scope="module")
def jax_out(long_corpus, tmp_path_factory):
    """The JAX package's trainer on the corpus, for each config."""
    d = tmp_path_factory.mktemp("jax")
    out = {}
    for cfg in (CFG, STOP_CFG):
        j = JaxTrainer(*cfg, backend="tpu")
        j.load_corpus(long_corpus)
        j.train()
        out[cfg] = _out(j, d, "jax")
    return out


def _port(cfg, path):
    t = BPETrainer(*cfg, device="cpu")
    t.load_corpus(path)
    return t


def test_long_corpus_is_deterministic(tmp_path):
    path = tmp_path / "c.txt"
    make_long_corpus(str(path), raw_mb=0.2)
    data = path.read_bytes()
    assert len(data) == 266140
    assert hashlib.sha256(data).hexdigest() == (
        "428c386505de99dc2645e1d72a0d4a2fb91e973eac5d204163b47da9d34d529b")
    words = data.split()
    assert {len(w) % 3 for w in words} == {0}        # CJK, 3 bytes each
    assert 6 <= min(map(len, words)) and max(map(len, words)) <= 120
    assert 0.4 < np.mean([len(w) > 64 for w in set(words)]) < 0.6


def test_long_corpus_at_full_size_matches_its_digest(tmp_path):
    path = tmp_path / "c.txt"
    make_long_corpus(str(path))
    data = path.read_bytes()
    assert len(data) == LONG_CORPUS_BYTES
    assert hashlib.sha256(data).hexdigest() == LONG_CORPUS_SHA256


def test_auto_routes_long_words_to_flat_and_matches_jax(
        long_corpus, jax_out, tmp_path, monkeypatch):
    calls = []
    flat = BPETrainer._train_flat

    def spy(self, *args):
        calls.append(args[3])                           # the target
        return flat(self, *args)

    monkeypatch.setattr(BPETrainer, "_train_flat", spy)
    launches = _kernels.flat_train.launches
    t = _port(CFG, long_corpus)
    assert t.train() == CFG[0] - 256
    assert calls == [CFG[0] - 256]
    assert _kernels.flat_train.launches == launches     # plain on the CPU
    assert _out(t, tmp_path, "port") == jax_out[CFG]


@pytest.mark.parametrize("k", [1, 97, 383])
def test_resume_matches_uninterrupted(k, long_corpus, jax_out, tmp_path):
    half = _port(CFG, long_corpus)
    assert half.train(max_merges=k) == k
    ck = str(tmp_path / "ck.npz")
    half.save_checkpoint(ck)
    t = _port(CFG, long_corpus)
    assert t.load_checkpoint(ck) == k
    assert t.train() == CFG[0] - 256 - k
    assert _out(t, tmp_path, "resumed") == jax_out[CFG]


def test_second_train_continues(long_corpus, jax_out, tmp_path):
    t = _port(CFG, long_corpus)
    assert t.train(max_merges=150) == 150
    assert t.train() == CFG[0] - 256 - 150
    assert _out(t, tmp_path, "again") == jax_out[CFG]


def test_min_pair_freq_stops_at_the_same_merge(long_corpus, jax_out,
                                               tmp_path):
    t = _port(STOP_CFG, long_corpus)
    n = t.train()
    assert 0 < n < STOP_CFG[0] - 256
    assert min(t.merge_freqs) >= STOP_CFG[3]
    assert _out(t, tmp_path, "stop") == jax_out[STOP_CFG]


def _stream(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 90, 60)
    word_id = np.repeat(np.arange(60, dtype=np.int32), lens)
    tokens = rng.randint(97, 100, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 9, 60).astype(np.int32)[word_id]
    return tokens, word_id, wcount


def test_flat_train_runs_the_plain_version_on_cpu():
    ts0 = bpe_ops.train_init(bpe_ops.make_state(*_stream(), device="cpu"),
                             50)
    ts1 = bpe_ops.train_init(bpe_ops.make_state(*_stream(), device="cpu"),
                             50)
    launches = _kernels.flat_train.launches
    for _ in range(4):
        ts0 = _kernels.flat_train(ts0, -1, 2, target_merges=50, max_steps=7)
        ts1 = _kernels.flat_train_plain(ts1, -1, 2, target_merges=50,
                                        max_steps=7)
    assert _kernels.flat_train.launches == launches
    assert ts0.n_merges == ts1.n_merges == 28
    np.testing.assert_array_equal(ts0.merges, ts1.merges)
    for a, b in zip(ts0.corpus, ts1.corpus):
        assert torch.equal(a, b)
    fs = bpe_ops.FlatState(ts0.corpus)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flat_train(ts0._replace(corpus=fs), -1, 2,
                            target_merges=50, max_steps=7)


def test_flat_state_layout_and_compaction():
    corpus = bpe_ops.make_state(*_stream(1), device="cpu")
    fs = bpe_ops.FlatState(bpe_ops.CorpusState(*(x.clone()
                                                 for x in corpus)))
    lens = np.bincount(corpus.word_id.numpy())
    assert fs.n_words == 60 and fs.stream_len == len(corpus.tokens)
    np.testing.assert_array_equal(fs.off.numpy(),
                                  np.concatenate([[0], np.cumsum(lens)]))
    assert fs.cap >= 6 * len(corpus.tokens) and fs.cap & (fs.cap - 1) == 0
    # F1 leaves each word left-aligned with its live length: compact()
    # keeps each word's first len[w] tokens, in stream order
    fs.len[::2] -= 1
    got = fs.compact()
    keep = np.concatenate([np.arange(n) < n - (i % 2 == 0)
                           for i, n in enumerate(lens)])
    for a, b in zip(got, corpus):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[keep])
    bad = corpus.wcount.clone()
    w = int(np.argmax(lens > 1))
    bad[int(fs.off[w]) + 1] += 1        # the second token of word w
    with pytest.raises(ValueError, match="one count per word"):
        bpe_ops.FlatState(corpus._replace(wcount=bad))


def _presence_reference(tokens, word_id, rows):
    """For each id, the chunks of 32 words that hold it, as F1's bits."""
    first = np.r_[True, word_id[1:] != word_id[:-1]]
    word = np.cumsum(first) - 1
    nc = -(-int(first.sum()) // 32)
    want = np.zeros((rows, -(-nc // 32)), np.uint32)
    for x, w in zip(tokens.tolist(), word.tolist()):
        if x >= 0:
            c = w // 32
            want[x, c // 32] |= np.uint32(1 << (c % 32))
    return want


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_state_presence_index_and_signatures(case):
    ckw, target, n_prev, unk, minf = FLAT_CASES[case]
    tokens, word_id, wcount = flat_corpus(**ckw)
    fs = bpe_ops.FlatState(bpe_ops.make_state(tokens, word_id, wcount,
                                              device="cpu"))
    rows = max(256, int(tokens.max()) + 1)
    assert fs.pres.dtype == torch.int32 and fs.pres.shape[0] == rows
    np.testing.assert_array_equal(fs.pres.numpy().view(np.uint32),
                                  _presence_reference(tokens, word_id, rows))
    if unk == -1 and (tokens == -1).any():
        assert fs.pres.shape[0] == 256           # unk -1 has no row
    # the wrapper's rows for every id the run makes, the stream's kept
    before = fs.pres.clone()
    fs.reserve(256 + target)
    assert fs.pres.shape == (max(rows, 256 + target), before.shape[1])
    assert torch.equal(fs.pres[:rows], before)
    assert not fs.pres[rows:].any()
    # each word's signature: bit sig_bit(x) of every id x in it
    first = np.r_[True, word_id[1:] != word_id[:-1]]
    word = np.cumsum(first) - 1
    want = np.zeros((int(first.sum()), 4), np.uint32)
    for x, w in zip(tokens.tolist(), word.tolist()):
        bit = ((x & 0xFFFFFFFF) * 0x9E3779B1 & 0xFFFFFFFF) >> 25
        want[w, bit // 32] |= np.uint32(1 << (bit % 32))
    np.testing.assert_array_equal(fs.sig.numpy().view(np.uint32), want)
    # the kept segment maxima cover every slot of the table
    assert len(fs.skey) * bpe_ops.SEG_SLOTS == fs.cap == len(fs.cnt)
    assert len(fs.dirty) == len(fs.sce) == len(fs.skey)
