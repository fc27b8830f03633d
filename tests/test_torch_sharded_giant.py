"""The row-sharded giant engine of the port (parallel/giant.py, G1's
plain version on the CPU) in gloo CPU ranks (tests/torch_dist_workers.py)
against the JAX package's sharded_giant_train and sharded_train on the
CPU virtual mesh, and against the port's single-device engines.  Counts
are integers, so merges, frequencies and saved bytes must be identical.
G1 itself is held against this plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

import torch_dist_workers as workers
from shredword_tpu.models.bpe import BPETrainer as JaxTrainer
from shredword_tpu.parallel import make_mesh, sharded_giant_train, \
    sharded_train
from shredword_tpu_torch.ops import bpe_hist


def _random_words():
    """The random-words corpus of tests/test_parallel.py:155: (tokens,
    word_id, per-word counts)."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 104, int(rng.integers(2, 8))).tolist())
             for _ in range(300)]
    counts = rng.integers(1, 60, len(words)).astype(np.int32)
    toks = np.concatenate([np.frombuffer(w, np.uint8).astype(np.int32)
                           for w in words])
    wid = np.repeat(np.arange(len(words), dtype=np.int32),
                    [len(w) for w in words])
    return toks, wid, counts


@pytest.fixture(scope="module")
def ranks(zipf_corpus_file, tmp_path_factory):
    """Both ranks' results of workers.sharded_giant_scenarios."""
    tmp = tmp_path_factory.mktemp("giant_ranks")
    return workers.run_ranks(workers.sharded_giant_scenarios, 2, str(tmp),
                             zipf_corpus_file, _random_words(), str(tmp),
                             timeout=200)


@pytest.fixture(scope="module")
def full_flat(zipf_corpus_file, tmp_path_factory):
    """The single-device flat engine of the port at vocab 4500: (merges,
    freqs, token frequencies, .model bytes, .vocab bytes)."""
    t = workers._trainer(zipf_corpus_file, target_vocab_size=4500,
                         engine="flat")
    t.train()
    tmp = tmp_path_factory.mktemp("flat4500")
    t.save(str(tmp / "m"), str(tmp / "v"))
    return (t.merges, t.merge_freqs, t.token_frequencies(),
            (tmp / "m").read_bytes(), (tmp / "v").read_bytes())


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_giant_matches_jax(ranks, n_shards, tmp_path):
    """sharded_giant_train in 2 and 4 gloo ranks == the JAX engine on a
    2- and 4-device mesh == the single-device hist engine
    (tests/test_parallel.py:155)."""
    arrays = _random_words()
    jm, jf = sharded_giant_train(*arrays, mesh=make_mesh(n_shards),
                                 target_merges=32, min_pair_freq=2,
                                 max_steps_per_call=16)
    hm, hf, _ = bpe_hist.hist_train(*arrays, target_merges=32,
                                    min_pair_freq=2, lazy_final=True,
                                    device="cpu")
    np.testing.assert_array_equal(hm, jm)
    np.testing.assert_array_equal(hf, jf)
    assert len(jm) == 32
    if n_shards == 2:
        outs = [r["engine"] for r in ranks]
    else:
        outs = workers.run_ranks(workers.sharded_giant_engine, 4,
                                 str(tmp_path), arrays, timeout=120)
    for m, f in outs:
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(f, jf)


def test_bpetrainer_shards_routes_to_giant(ranks, full_flat,
                                           zipf_corpus_file):
    """Above vocab 4096 BPETrainer(shards=2) trains on the sharded giant
    engine (no TrainingError) and equals the single-device flat engine
    and the JAX package (tests/test_parallel.py:183)."""
    j = JaxTrainer(target_vocab_size=4500, unk_id=-1,
                   character_coverage=0.9995, min_pair_freq=5,
                   backend="tpu", engine="flat")
    j.load_corpus(zipf_corpus_file)
    j.train()
    np.testing.assert_array_equal(full_flat[0], j.merges)
    np.testing.assert_array_equal(full_flat[2], j.token_frequencies())
    for r in ranks:
        assert workers._engine_of(r["full_log"]) == "giant"
        merges, freqs, tf, model, vocab = r["full"]
        assert len(merges) > 100
        np.testing.assert_array_equal(merges, full_flat[0])
        np.testing.assert_array_equal(freqs, full_flat[1])
        np.testing.assert_array_equal(tf, full_flat[2])
        assert (model, vocab) == full_flat[3:]


def test_sharded_giant_resume(ranks, full_flat):
    """Above vocab 4096, interrupted-then-resumed sharded training equals
    the uninterrupted run, and a single-device checkpoint resumes
    sharded (tests/test_sharded_resume.py:27, :44)."""
    for r in ranks:
        assert r["half"] == 12
        for key in ("resumed", "single_resumed"):
            merges, freqs, tf, model, vocab = r[key]
            np.testing.assert_array_equal(merges, full_flat[0])
            np.testing.assert_array_equal(freqs, full_flat[1])
            np.testing.assert_array_equal(tf, full_flat[2])
            assert (model, vocab) == full_flat[3:]


def test_envelope_crosses_int16(ranks):
    """The int16-crossing envelope of tests/test_giant_64k_envelope.py on
    2 ranks (the table is [16512, 33024] a rank, 4.4 GB in all): new ids
    pass 32767 and a merge consumes one; giant == the port's sharded flat
    == the JAX sharded flat engine."""
    tokens, word_id, _, wcount = workers.envelope_corpus()
    jm, jf = sharded_train(tokens, word_id, wcount, mesh=make_mesh(4),
                           target_merges=workers.ENVELOPE_TARGET, unk_id=-1,
                           min_pair_freq=2,
                           n_prev_merges=workers.ENVELOPE_N_PREV)
    assert len(jm) == 14 and (jm > 32767).any()
    for r in ranks:
        (m, f), largest = r["envelope"]
        assert largest == (33024 // 2, 33024)
        for got_m, got_f in ((m, f), r["envelope_flat"]):
            np.testing.assert_array_equal(got_m, jm)
            np.testing.assert_array_equal(got_f, jf)


def test_resume_near_v_allocates_only_own_rows(ranks):
    """A resume near v on 2 ranks: the largest tensor any op makes is the
    rank's own rows [v/2, v] (v 2304) -- not the [vi, vi] (vi 2176)
    table of the replayed ids that the JAX package builds
    (shredword_tpu/parallel/giant.py:222-233) -- and the merges equal the
    port's sharded flat engine and the JAX package's engines."""
    tokens, word_id, counts, wcount = workers.near_v_corpus()
    kw = dict(target_merges=workers.NEAR_V_TARGET, unk_id=-1,
              min_pair_freq=2, n_prev_merges=workers.NEAR_V_N_PREV)
    jm, jf = sharded_giant_train(tokens, word_id, counts,
                                 mesh=make_mesh(2), **kw)
    fm, ff = sharded_train(tokens, word_id, wcount, mesh=make_mesh(2),
                           **kw)
    np.testing.assert_array_equal(jm, fm)
    np.testing.assert_array_equal(jf, ff)
    assert len(jm) == 14 and 2176 ** 2 > 1152 * 2304
    for r in ranks:
        (m, f), largest = r["near_v"]
        assert largest == (1152, 2304)
        for got_m, got_f in ((m, f), r["near_v_flat"]):
            np.testing.assert_array_equal(got_m, jm)
            np.testing.assert_array_equal(got_f, jf)
