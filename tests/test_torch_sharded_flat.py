"""The sharded flat engine of the port (parallel/train.py) in two gloo CPU
ranks (tests/torch_dist_workers.py) against the JAX package's
sharded_train on the CPU virtual mesh and the port's single-device flat
engine: its stream layout, merges and frequencies, resume, and the
routes of BPETrainer(shards=N) that reach it."""

import numpy as np
import pytest

import torch_dist_workers as workers
from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu.parallel import make_mesh, shard_corpus, sharded_train
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
