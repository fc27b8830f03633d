"""The sharded flat engine of the port (parallel/train.py) in gloo CPU
ranks (tests/torch_dist_workers.py) against the JAX package's
sharded_train on the CPU virtual mesh and the port's single-device flat
engine: its stream layout, merges and frequencies, resume, the routes of
BPETrainer(shards=N) that reach it, the calls of its wrapper
(_kernels.flat_sharded_train, S1 on a card) over 1, 2 and 3 ranks, and
the host glue of S1's delta exchange: its start, and the plain version
of its fixed-size exchange with the fallback and the overflow that
every rank sees alike."""

import contextlib

import numpy as np
import pytest
import torch
from torch_flat_cases import FLAT_CASES, SHARDED_CASES, flat_corpus

import torch_dist_workers as workers
from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu.parallel import make_mesh, shard_corpus, sharded_train
from shredword_tpu_torch.ops import _kernels, bpe_ops
from shredword_tpu_torch.parallel import train


@pytest.fixture(scope="module")
def ranks(zipf_corpus_file, tmp_path_factory):
    """Both ranks' results of workers.sharded_flat_scenarios."""
    tmp = tmp_path_factory.mktemp("flat_ranks")
    return workers.run_ranks(workers.sharded_flat_scenarios, 2, str(tmp),
                             zipf_corpus_file, str(tmp), timeout=150)


def _single(corpus, tmp, tag, **kw):
    """The port's single-device flat engine: (merges, freqs, token
    frequencies, .model bytes, .vocab bytes)."""
    t = workers._trainer(corpus, engine="flat", **kw)
    t.train()
    t.save(str(tmp / f"{tag}.m"), str(tmp / f"{tag}.v"))
    return (t.merges, t.merge_freqs, t.token_frequencies(),
            (tmp / f"{tag}.m").read_bytes(), (tmp / f"{tag}.v").read_bytes())


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_corpus_matches_jax(n_shards):
    """Cuts at word boundaries and the common power-of-two capacity,
    array for array as the JAX package lays them out
    (tests/test_parallel.py:83's corpus)."""
    rng = np.random.RandomState(0)
    lens = rng.randint(1, 9, 57)
    word_id = np.repeat(np.arange(57, dtype=np.int32), lens)
    tokens = rng.randint(0, 256, len(word_id)).astype(np.int32)
    wcount = rng.randint(1, 9, len(word_id)).astype(np.int32)
    got = train.shard_corpus(tokens, word_id, wcount, n_shards)
    want = shard_corpus(tokens, word_id, wcount, n_shards)
    for field in ("tokens", "word_id", "wcount", "lengths"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))
    seen = np.concatenate([got.word_id[d, :got.lengths[d]]
                           for d in range(n_shards)])
    np.testing.assert_array_equal(seen, word_id)


def test_sharded_flat_matches_jax_and_resumes(ranks, zipf_corpus_file):
    """sharded_train in 2 gloo ranks == the JAX sharded_train on a
    4-device mesh; resumed after 12 merges it returns the rest
    (tests/test_sharded_resume.py:65)."""
    t = workers._trainer(zipf_corpus_file)
    tokens, word_id, wcount = t._token_arrays()
    jm, jf = sharded_train(tokens, word_id, wcount, mesh=make_mesh(4),
                           target_merges=60, unk_id=-1, min_pair_freq=5)
    assert len(jm) > 12
    for r in ranks:
        m, f = r["engine"]
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(f, jf)
        m2, f2 = r["engine_resumed"]
        np.testing.assert_array_equal(np.concatenate([jm[:12], m2]), jm)
        np.testing.assert_array_equal(np.concatenate([jf[:12], f2]), jf)


def test_bpetrainer_shards_flat_fallback(ranks, zipf_corpus_file,
                                         tmp_path):
    """When the table engines decline, BPETrainer(shards=2) trains on the
    sharded flat engine and equals the single-device flat engine and the
    JAX package (tests/test_parallel.py:132)."""
    single = _single(zipf_corpus_file, tmp_path, "s",
                     target_vocab_size=2400)
    j = JaxTrainer(target_vocab_size=2400, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="tpu", engine="flat")
    j.load_corpus(zipf_corpus_file)
    j.train()
    np.testing.assert_array_equal(single[0], j.merges)
    for r in ranks:
        assert workers._engine_of(r["fallback_log"]) == "flat"
        merges, freqs, tf, model, vocab = r["fallback"]
        assert len(merges) > 100
        np.testing.assert_array_equal(merges, single[0])
        np.testing.assert_array_equal(freqs, single[1])
        np.testing.assert_array_equal(tf, single[2])
        assert (model, vocab) == single[3:]


def test_long_words_reach_sharded_flat(ranks, tmp_path):
    """A word over 64 tokens: both table engines decline and
    BPETrainer(shards=2) trains on the sharded flat engine with no
    patch, equal to the single-device flat engine."""
    corpus = tmp_path / "long.txt"
    corpus.write_bytes((b"x" * 100 + b" the quick brown fox\n") * 20)
    single = _single(str(corpus), tmp_path, "l", target_vocab_size=300,
                     character_coverage=0.9999, min_pair_freq=2)
    for r in ranks:
        assert workers._engine_of(r["long_log"]) == "flat"
        merges, freqs, tf, model, vocab = r["long"]
        assert len(merges) > 0
        np.testing.assert_array_equal(merges, single[0])
        np.testing.assert_array_equal(freqs, single[1])
        np.testing.assert_array_equal(tf, single[2])
        assert (model, vocab) == single[3:]


@pytest.fixture(scope="module", params=[1, 2, 3])
def calls(request, tmp_path_factory):
    """(world, every rank's workers.sharded_flat_calls) over 1, 2 and 3
    gloo ranks."""
    tmp = tmp_path_factory.mktemp(f"flat_calls{request.param}")
    return request.param, workers.run_ranks(
        workers.sharded_flat_calls, request.param, str(tmp), timeout=300)


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX package's sharded_train on a 2-device mesh, per case of
    SHARDED_CASES: (merges, freqs)."""
    out = {}
    for case, (ckw, target, n_prev, unk, minf) in SHARDED_CASES.items():
        out[case] = sharded_train(*flat_corpus(**ckw), mesh=make_mesh(2),
                                  target_merges=target, unk_id=unk,
                                  min_pair_freq=minf, n_prev_merges=n_prev)
    return out


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_flat_calls_match_jax(case, calls, jax_sharded):
    """sharded_train over 1, 2 and 3 ranks, in calls of 1, 7 and 256
    merges (max_steps_per_call), == the JAX sharded_train (merges and
    freqs): words over 64 tokens with an unk byte; past PACK_LIMIT (the
    JAX 2-key path) to a min_pair_freq stop; resumed at merge 16300."""
    world, ranks = calls
    jm, jf = jax_sharded[case]
    ckw, target, n_prev, _, _ = SHARDED_CASES[case]
    assert 0 < len(jm) < target - n_prev if case == "two_key_stop" \
        else len(jm) == target - n_prev
    if case == "long_words_unk":
        assert np.bincount(flat_corpus(**ckw)[1]).max() > 64
    else:
        assert 256 + target > 2**14
    for r in ranks:
        for steps in workers.SHARDED_STEPS:
            m, f = r[case, steps]
            np.testing.assert_array_equal(m, jm, f"{world} ranks, {steps}")
            np.testing.assert_array_equal(f, jf, f"{world} ranks, {steps}")


def test_delta_exchange_builds_the_whole_table(calls):
    """S1's host glue alone: on every rank the table it builds from the
    gathered lists (train.initial_deltas, then each rank's net deltas of
    each plain merge through train.gather_padded) == bpe_ops.pair_counts
    of the whole corpus, after the start and after each merge; the
    whole stream's length is summed over the ranks."""
    world, ranks = calls
    ckw, _, _, unk, _ = SHARDED_CASES["long_words_unk"]
    arrays = flat_corpus(**ckw)
    whole = bpe_ops.make_state(*arrays, device="cpu")
    want = [bpe_ops.pair_counts(whole, unk)]
    for i, ((a, b), _) in enumerate(ranks[0]["glue"][1:]):
        whole = bpe_ops.apply_merge(whole, a, b, 256 + i)
        want.append(bpe_ops.pair_counts(whole, unk))
    assert len(want) == workers.GLUE_MERGES + 1
    for r in ranks:
        glue = r["glue"]
        assert glue[0][0] == len(arrays[0])
        assert [g[0] for g in glue[1:]] == [g[0] for g in ranks[0]["glue"][1:]]
        for (_, (keys, counts)), (wk, wc) in zip(glue, want):
            np.testing.assert_array_equal(keys, wk.numpy())
            np.testing.assert_array_equal(counts, wc.numpy())


def _whole_run(arrays, unk, merges):
    """The plain version on the whole stream, min_pair_freq 1: the
    merges and the pair counts (bpe_ops.pair_counts) at the start and
    after each merge."""
    whole = bpe_ops.make_state(*arrays, device="cpu")
    picked, tables = [], [bpe_ops.pair_counts(whole, unk)]
    for i in range(merges):
        a, b, _ = bpe_ops.best_pair(whole, unk, 1)
        whole = bpe_ops.apply_merge(whole, a, b, 256 + i)
        picked.append((a, b))
        tables.append(bpe_ops.pair_counts(whole, unk))
    return picked, tables


@pytest.mark.parametrize("rows", workers.FIXED_ROWS)
def test_fixed_exchange_builds_the_whole_table(rows, calls):
    """The plain version of S1's fixed-size exchange
    (train.exchange_deltas of train.pack_rows lists, at S1's first rows
    and at 4, where lists are longer), each merge picked from the table
    it builds: on every rank the table == bpe_ops.pair_counts of the
    whole corpus after the start and after each merge, and == the table
    of the exchange it replaced (exchange_tables, train.gather_padded)
    over that one's merges; the merges == the plain version's on the
    whole stream."""
    world, ranks = calls
    ckw, _, _, unk, _ = SHARDED_CASES["long_words_unk"]
    arrays = flat_corpus(**ckw)
    picked, want = _whole_run(arrays, unk, workers.FIXED_MERGES)
    for r in ranks:
        fixed = r["fixed", rows]
        assert fixed["n_all"] == len(arrays[0])
        assert fixed["raised"] is None
        assert fixed["merges"] == picked
        assert len(fixed["tables"]) == workers.FIXED_MERGES + 1
        for (keys, counts), (wk, wc) in zip(fixed["tables"], want):
            np.testing.assert_array_equal(keys, wk.numpy())
            np.testing.assert_array_equal(counts, wc.numpy())
        for (keys, counts), (_, (gk, gc)) in zip(fixed["tables"], r["glue"]):
            np.testing.assert_array_equal(keys, gk)
            np.testing.assert_array_equal(counts, gc)


def test_fixed_exchange_falls_back_alike(calls):
    """At 4 rows a list the first lists are longer: every rank falls back
    at the same merges to the same rows (the next power of two at or
    above the longest list, never shrunk), and makes S1's merges at its
    first rows."""
    world, ranks = calls
    small, big = workers.FIXED_ROWS[1], workers.FIXED_ROWS[0]
    grown = ranks[0]["fixed", small]["rows"]
    assert grown[0] > small and grown == sorted(grown)
    assert all(g & (g - 1) == 0 for g in grown)
    for r in ranks:
        assert r["fixed", small]["rows"] == grown
        assert r["fixed", small]["merges"] == r["fixed", big]["merges"]
        assert r["fixed", big]["rows"] == [big] * workers.FIXED_MERGES


@pytest.mark.parametrize("world", [2, 3])
def test_overflow_flag_raises_on_every_rank(world, tmp_path):
    """One rank's overflow flag in its header (the last rank's, at merge
    OVERFLOW_MERGE): every rank raises the same RuntimeError at that
    merge, and none hangs (the ranks have 120 s, then the test fails)."""
    ranks = workers.run_ranks(workers.overflow_raises, world,
                              str(tmp_path), timeout=120)
    raised = {r["raised"] for r in ranks}
    assert len(raised) == 1
    merge, message = raised.pop()
    assert merge == workers.OVERFLOW_MERGE and "overflowed" in message
    assert all(len(r["merges"]) == workers.OVERFLOW_MERGE for r in ranks)


def _span_reference(tokens, word_id, rows):
    """F1's presence index and word signatures of a span, by numpy: for
    each id >= 0 the chunks of 32 words that hold it, and for each word
    bit sig_bit(x) of every id x in it."""
    first = np.r_[True, word_id[1:] != word_id[:-1]][:len(word_id)]
    word = np.cumsum(first) - 1
    n_words = int(first.sum())
    nc = -(-n_words // 32)
    pres = np.zeros((rows, -(-nc // 32)), np.uint32)
    sig = np.zeros((n_words, 4), np.uint32)
    for x, w in zip(tokens.tolist(), word.tolist()):
        if x >= 0:
            pres[x, w // 32 // 32] |= np.uint32(1 << (w // 32 % 32))
        bit = ((x & 0xFFFFFFFF) * 0x9E3779B1 & 0xFFFFFFFF) >> 25
        sig[w, bit // 32] |= np.uint32(1 << (bit % 32))
    return pres, sig


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_state_of_each_span(case, world):
    """The state S1's first call builds on each rank, on the CPU:
    bpe_ops.FlatState of every span of shard_corpus, sized on the whole
    stream, has the span's words, counts, presence index (a row for
    every id up to the span's largest, at least 256) and signatures, by
    numpy; its table is the whole stream's."""
    ckw, _, _, _, _ = FLAT_CASES[case]
    arrays = flat_corpus(**ckw)
    sc = train.shard_corpus(*arrays, world)
    for r in range(world):
        m = int(sc.lengths[r])
        tokens, word_id, wcount = (x[r, :m] for x in sc[:3])
        fs = bpe_ops.FlatState(train.local_state(sc, r, "cpu"),
                               table_n=len(arrays[0]))
        rows = max(256, int(tokens.max()) + 1)
        pres, sig = _span_reference(tokens, word_id, rows)
        np.testing.assert_array_equal(fs.pres.numpy().view(np.uint32), pres)
        np.testing.assert_array_equal(fs.sig.numpy().view(np.uint32), sig)
        starts = fs.off[:-1].numpy()
        np.testing.assert_array_equal(fs.wcnt.numpy(), wcount[starts])
        assert fs.off[-1] == m and (fs.len > 0).all()
        assert fs.cap == bpe_ops.FlatState(bpe_ops.make_state(
            *arrays, device="cpu")).cap


def test_flat_state_of_an_empty_span():
    """A rank whose span is empty (more ranks than words): its FlatState
    has no word, no chunk and 256 empty rows (no modulo by zero words),
    and compacts to nothing."""
    tokens = np.array([97, 98, 97], np.int32)
    word_id = np.array([0, 0, 1], np.int32)
    sc = train.shard_corpus(tokens, word_id, np.ones(3, np.int32), 4)
    assert 0 in sc.lengths
    for r in range(4):
        fs = bpe_ops.FlatState(train.local_state(sc, r, "cpu"), table_n=3)
        m = int(sc.lengths[r])
        assert fs.n_words == len(np.unique(sc.word_id[r, :m]))
        assert fs.pres.shape[0] == 256
        assert fs.pres.shape[1] == (1 if m else 0)
        assert all(len(x) == m for x in fs.compact())


@pytest.mark.parametrize("group", ["none", "gloo1"])
def test_flat_sharded_train_on_cpu_is_plain(group, tmp_path, monkeypatch):
    """The S1 wrapper on CPU tensors runs its plain version
    (bpe_ops.train_loop) with no group and over a one-rank gloo group:
    the same records call by call as train_loop, the kernel library
    never loaded and no launch counted."""
    def no_lib():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_kernels, "lib", no_lib)
    ckw, target, n_prev, unk, minf = SHARDED_CASES["long_words_unk"]
    arrays = flat_corpus(**ckw)
    want, got = (bpe_ops.train_init(bpe_ops.make_state(*arrays, "cpu"),
                                    target, n_prev) for _ in range(2))
    n0 = _kernels.flat_sharded_train.launches
    with (workers.one_rank_gloo(str(tmp_path / "store")) if group == "gloo1"
          else contextlib.nullcontext()) as g:
        while not want.done and want.n_merges < target:
            want = bpe_ops.train_loop(want, unk, minf, target_merges=target,
                                      max_steps=7)
            got = _kernels.flat_sharded_train(got, unk, minf,
                                              target_merges=target,
                                              max_steps=7, group=g)
            assert (got.n_merges, got.done) == (want.n_merges, want.done)
            np.testing.assert_array_equal(got.merges, want.merges)
            np.testing.assert_array_equal(got.merge_freqs, want.merge_freqs)
            for x, y in zip(got.corpus, want.corpus):
                assert torch.equal(x, y)
    assert _kernels.flat_sharded_train.launches == n0
    assert want.n_merges == target
