"""Unigram of the PyTorch port against the JAX package, on the CPU.

The native bindings give the JAX package's seed vocabulary, piece tables
and word dedup; the plain versions of the lattice kernels
(``fb_core_plain``, ``viterbi_core_plain``) agree with the JAX package's
``_fb_core`` (jit on the CPU), its numpy ``_fb_numpy`` and its
``viterbi``; the trainer gives the JAX package's pieces on both of its
backends; the tokenizer gives its ids; sharded EM in two gloo ranks gives
the single-device pieces.

Tolerances: expected counts rtol=atol=1e-5 (the JAX package sums in
float32, the port in float64), log-likelihood 1e-6 relative + 1e-3,
trained log_probs rtol=atol=1e-4 (the JAX package's own bound between
its backends); Viterbi ids and scores and trained pieces exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import torch_dist_workers as workers
from golden.corpus_gen import small_corpus, zipf_corpus
from shredword_tpu.errors import EncodeError as JaxEncodeError
from shredword_tpu.models.unigram import UnigramTokenizer as JaxTokenizer
from shredword_tpu.models.unigram import UnigramTrainer as JaxTrainer
from shredword_tpu.models.unigram import _prep_words as jax_prep_words
from shredword_tpu.ops import unigram_ops as jax_ops
from shredword_tpu.runtime import native as jax_native
from shredword_tpu_torch import (ConfigError, EncodeError, UnigramConfig,
                                 UnigramTokenizer, UnigramTrainer)
from shredword_tpu_torch.models.unigram import _prep_words
from shredword_tpu_torch.ops import unigram_ops
from shredword_tpu_torch.runtime import native
from torch_unigram_cases import LATTICES, random_lattice

MARKER = "▁".encode()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops, which PyTorch's CPU thread
    pool only slows down here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(seed, n=300, alpha=5, max_len=20):
    rng = np.random.RandomState(seed)
    letters = b"abcdefghijklmnopqrstuvwxyz"[:alpha]
    words = [MARKER + bytes(rng.choice(list(letters), rng.randint(1, max_len)))
             for _ in range(n)]
    return words, rng.randint(1, 40, n)


# ---------------------------------------------------------------------
# native bindings
# ---------------------------------------------------------------------

@pytest.mark.parametrize("skip_markers", [True, False])
def test_seed_vocab_matches_jax(skip_markers):
    words, counts = _words(0)
    out = []
    for mod in (native, jax_native):
        sv = mod.SeedVocab()
        for w, c in zip(words, counts):
            sv.add(w, max_len=7, weight=int(c), skip_markers=skip_markers)
        out.append((len(sv), *sv.export(500)))
        sv.free()
    (n, p, c), (jn, jp, jc) = out
    assert n == jn > 100 and p == jp and len(p) == min(n, 500)
    np.testing.assert_array_equal(c, jc)


def test_piece_table_matches_jax():
    words, _ = _words(1, max_len=30)
    sv = native.SeedVocab()
    for w in words:
        sv.add(w, max_len=6, skip_markers=False)
    pieces, _ = sv.export(400)
    for lmax, k in ((32, 6), (16, 4)):
        got = native.piece_table(words, pieces, lmax, k)
        np.testing.assert_array_equal(
            got, jax_native.piece_table(words, pieces, lmax, k))
        assert (got >= 0).any() and (got < 0).any()


def test_marker_word_dedup_and_prep_words_match_jax():
    texts = ["hello world hello", "a  b\n\nc a", "", "   ",
             "one\ntwo three\ntwo", "x" * 100 + " y " + "x" * 100,
             "café naïve café", zipf_corpus()[:5000]]
    for text in texts:
        norm = native.normalize(text.encode())
        assert norm == jax_native.normalize(text.encode())
        for a, b in zip(native.marker_word_dedup(norm),
                        jax_native.marker_word_dedup(norm)):
            np.testing.assert_array_equal(a, b)
        w, c = _prep_words(text.encode(), 16)
        jw, jc = jax_prep_words(text.encode(), 16)
        assert w == jw
        np.testing.assert_array_equal(c, jc)


# ---------------------------------------------------------------------
# the lattice ops against the JAX package
# ---------------------------------------------------------------------

def _port_tensors(table, wlen, wcount, logp):
    dt = unigram_ops.make_device_table(table, wlen, wcount, "cpu")
    return (dt.ids, torch.from_numpy(logp.astype(np.float32)), dt.wlen,
            dt.wcount)


@pytest.mark.parametrize("case", sorted(LATTICES))
def test_fb_core_plain_matches_jax(case):
    table, wlen, wcount, logp = random_lattice(case)
    counts, ll = unigram_ops.fb_core_plain(
        *_port_tensors(table, wlen, wcount, logp))
    assert counts.dtype == ll.dtype == torch.float64
    n = len(logp)
    ids_s = np.transpose(table, (1, 0, 2))
    lp_ext = np.concatenate([logp, [-np.inf]]).astype(np.float32)
    jc, jl = jax_ops._fb_device(jnp.asarray(ids_s), jnp.asarray(lp_ext),
                                jnp.asarray(wlen), jnp.asarray(wcount),
                                n_pieces=n)
    nc, nl = jax_ops.forward_backward(table, wlen, wcount, logp, n,
                                      backend="cpu")
    for want, want_ll in ((np.asarray(jc), float(jl)), (nc, nl)):
        np.testing.assert_allclose(counts.numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        assert abs(float(ll) - want_ll) <= 1e-6 * abs(want_ll) + 1e-3
    # the host entry points: the plain version on the CPU device, and the
    # numpy backend as the JAX package's
    fc, fl = unigram_ops.forward_backward(table, wlen, wcount, logp, n,
                                          device="cpu")
    np.testing.assert_array_equal(fc, counts.numpy())
    assert fl == float(ll)
    cc, cl = unigram_ops.forward_backward(table, wlen, wcount, logp, n,
                                          backend="cpu")
    np.testing.assert_array_equal(cc, nc)
    assert cl == nl
    assert counts.sum() > 0 and np.isfinite(float(ll))


@pytest.mark.parametrize("case", sorted(LATTICES))
def test_viterbi_matches_jax(case):
    table, wlen, _, logp = random_lattice(case)
    segs, scores = unigram_ops.viterbi(table, wlen, logp,
                                       return_scores=True, device="cpu")
    jsegs, jscores = jax_ops.viterbi(table, wlen, logp, return_scores=True)
    assert segs == jsegs
    np.testing.assert_array_equal(scores, jscores)        # bit-identical
    assert segs[3] == [] and scores[3] == -np.inf         # no piece
    np.testing.assert_array_equal(
        unigram_ops.viterbi_scores(table, wlen, logp, device="cpu"), scores)
    with pytest.raises(EncodeError):
        unigram_ops.viterbi(table, wlen, logp, device="cpu")
    with pytest.raises(JaxEncodeError):
        jax_ops.viterbi(table, wlen, logp)
    ok = np.isfinite(scores)
    assert unigram_ops.viterbi(table[ok], wlen[ok], logp, device="cpu") \
        == jax_ops.viterbi(table[ok], wlen[ok], logp)


def test_device_table_round_trip_and_remap_match_jax():
    """The port's resident table and its prune remap equal the JAX
    package's, through device_table_from_jax / device_table_to_jax."""
    table, wlen, wcount, _ = random_lattice("mixed")
    n = LATTICES["mixed"][4]
    jdt = jax_ops.make_device_table(table, wlen, wcount)
    dt = unigram_ops.device_table_from_jax(
        np.asarray(jdt.ids_s), np.asarray(jdt.wlen), np.asarray(jdt.wcount),
        jdt.n_words, device="cpu")
    own = unigram_ops.make_device_table(table, wlen, wcount, "cpu")
    assert torch.equal(dt.ids, own.ids) and torch.equal(dt.wlen, own.wlen)
    ids_s, wl, wc, nw = unigram_ops.device_table_to_jax(dt)
    np.testing.assert_array_equal(ids_s, np.transpose(table, (1, 0, 2)))
    np.testing.assert_array_equal(wl, wlen)
    np.testing.assert_array_equal(wc, wcount)
    assert nw == len(wlen)
    keep = np.random.RandomState(9).rand(n) < 0.7
    perm = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    jr = jax_ops.remap_device_table(jdt, perm)
    got = unigram_ops.remap_device_table(dt, perm)
    want = unigram_ops.device_table_from_jax(
        np.asarray(jr.ids_s), np.asarray(jr.wlen), np.asarray(jr.wcount),
        jr.n_words, device="cpu")
    assert torch.equal(got.ids, want.ids)
    assert (got.ids >= 0).any() and int(got.ids.max()) < keep.sum()


def test_wrappers_reject_bad_input():
    ids, lp, wlen, wcount = _port_tensors(*random_lattice("short_k"))
    for fn, args in ((unigram_ops.fb_core, (ids, lp, wlen, wcount)),
                     (unigram_ops.viterbi_core, (ids, lp, wlen))):
        with pytest.raises(ValueError, match="K must be"):
            fn(torch.full((4, 16, 3), -1, dtype=torch.int32), lp,
               *(a[:3] for a in args[2:]))
        with pytest.raises(ValueError, match="n_pieces"):
            fn(ids, lp[:10], *args[2:])
        with pytest.raises(ValueError, match="word lengths"):
            fn(ids, lp, wlen + ids.shape[0], *args[3:])
        with pytest.raises(TypeError):
            fn(ids.long(), *args[1:])
        with pytest.raises(ValueError, match="must be"):
            fn(ids, lp, wlen[:5], *args[3:])


@pytest.mark.parametrize("case", sorted(LATTICES))
def test_hot_ids_are_the_most_frequent(case):
    """U1's hot ids: the table's HOT_IDS ids that fill the most cells
    (ties to the smaller id), their slots, recomputed by a remap."""
    table, wlen, wcount, _ = random_lattice(case)
    n = LATTICES[case][4]
    dt = unigram_ops.make_device_table(table, wlen, wcount, "cpu")
    occ = np.bincount(table[table >= 0])
    want = np.argsort(-occ, kind="stable")[:unigram_ops.HOT_IDS]
    hot, slot = dt.hot
    assert hot.dtype == slot.dtype == torch.int32
    np.testing.assert_array_equal(hot.numpy(), want)
    assert len(slot) == table.max() + 1
    np.testing.assert_array_equal(slot.numpy()[want], np.arange(len(want)))
    assert (slot >= 0).sum() == len(want)
    few = unigram_ops.hot_ids(dt.ids, 5)
    np.testing.assert_array_equal(few.ids.numpy(), want[:5])
    keep = np.random.RandomState(3).rand(n) < 0.5
    perm = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
    got = unigram_ops.remap_device_table(dt, perm)
    again = unigram_ops.hot_ids(got.ids)
    assert torch.equal(got.hot.ids, again.ids)
    assert torch.equal(got.hot.slot, again.slot)


def test_fb_core_rejects_bad_hot_ids():
    """fb_core raises on hot ids the kernel does not take: other types or
    ranks, more than HOT_IDS, slots short of the table's largest id,
    non-contiguous vectors."""
    ids, lp, wlen, wcount = _port_tensors(*random_lattice("mixed"))
    hot = unigram_ops.hot_ids(ids, 50)
    want = unigram_ops.fb_core_plain(ids, lp, wlen, wcount)
    for h in (hot, unigram_ops.hot_ids(ids, 0)):
        got = unigram_ops.fb_core(ids, lp, wlen, wcount, h)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    H = unigram_ops.HOT_IDS
    bad = {
        TypeError: [hot._replace(ids=hot.ids.long()),
                    hot._replace(slot=hot.slot[None])],
        ValueError: [
            unigram_ops.HotIds(torch.arange(H + 1, dtype=torch.int32),
                               hot.slot),
            hot._replace(slot=hot.slot[:int(ids.max())]),
            hot._replace(ids=hot.ids.repeat(2)[::2]),
        ],
    }
    for err, cases in bad.items():
        for h in cases:
            with pytest.raises(err):
                unigram_ops.fb_core(ids, lp, wlen, wcount, h)


def test_cuda_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ConfigError):
        UnigramTrainer(target_vocab_size=30)
    with pytest.raises(ConfigError):
        UnigramTokenizer([b"a"], np.zeros(1))
    UnigramTrainer(backend="cpu")              # the numpy E-step needs none
    assert UnigramConfig().backend == "cuda"
    with pytest.raises(ConfigError):
        UnigramConfig(backend="tpu").validate()


# ---------------------------------------------------------------------
# the trainer and the tokenizer against the JAX package
# ---------------------------------------------------------------------

CATS = ("the cat sat on the mat " * 30 + "\n"
        + "a cat and a hat " * 30 + "\n") * 3
# name: (text, trainer keywords); the first two are tests/test_unigram.py's
CORPORA = {
    "cats": (CATS, dict(target_vocab_size=40, seed_size=500,
                        max_word_len=16)),
    "mat": ("the cat sat on the mat \n" * 50,
            dict(target_vocab_size=30, seed_size=200, max_word_len=16)),
    "small": (small_corpus(), dict(target_vocab_size=120, seed_size=1500,
                                   max_word_len=16)),
    "zipf": (zipf_corpus()[:30000], dict(target_vocab_size=300,
                                         seed_size=3000, max_piece_len=8,
                                         max_word_len=16)),
}


def _train(cls, path, kw):
    t = cls(**kw)
    t.load_corpus(path)
    n = t.train()
    return t, n


@pytest.mark.parametrize("pair", ["device", "cpu"])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_trainer_matches_jax(name, pair, tmp_path, monkeypatch):
    """pair "device": the port on the CPU device (the kernel's plain
    version) against the JAX device path (XLA on the CPU); "cpu": both
    numpy backends."""
    text, kw = CORPORA[name]
    path = tmp_path / "c.txt"
    path.write_text(text)
    backend = {} if pair == "device" else dict(backend="cpu")
    port, n = _train(UnigramTrainer, str(path),
                     dict(kw, device="cpu", **backend))
    if pair == "device":
        monkeypatch.setenv("SHRED_INTERPRET_OK", "1")
    jax_t, jn = _train(JaxTrainer, str(path), dict(kw, **backend))
    assert n == jn == kw["target_vocab_size"]
    assert port.pieces == jax_t.pieces
    np.testing.assert_allclose(port.log_probs, jax_t.log_probs, rtol=1e-4,
                               atol=1e-4)
    assert abs(port.final_ll - jax_t.final_ll) \
        <= 1e-6 * abs(jax_t.final_ll) + 1e-3
    assert set(port.timings) >= {"seed", "e_step", "m_step", "prune"}
    port.save(str(tmp_path / "p.model"))
    jax_t.save(str(tmp_path / "j.model"))
    assert UnigramTrainer.load_model(str(tmp_path / "j.model"))[0] \
        == port.pieces


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    """A model trained by the JAX package on the zipf slice, saved."""
    text, kw = CORPORA["zipf"]
    tmp = tmp_path_factory.mktemp("uni")
    (tmp / "c.txt").write_text(text)
    t, _ = _train(JaxTrainer, str(tmp / "c.txt"), dict(kw, backend="cpu"))
    t.save(str(tmp / "u.model"))
    return str(tmp / "u.model"), text


def test_tokenizer_matches_jax(model_file):
    path, text = model_file
    tok = UnigramTokenizer.load(path, device="cpu")
    want = JaxTokenizer.load(path)
    words = text.split()
    longw = "".join(words[:20])                 # a word over 64 bytes
    assert len(longw) > 64
    sample = " ".join(words[:400]) + " " + longw + "\n" + " ".join(words[-50:])
    ids = tok.encode_array(sample)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, want.encode_array(sample))
    assert tok.encode(sample) == want.encode(sample) == ids.tolist()
    plain = " ".join(sample.split()).lower()       # the normalized text
    assert tok.decode(ids) == want.decode(ids) == plain
    assert tok.decode_bytes(ids) == want.decode_bytes(ids)
    docs = [sample[:300], "", longw, sample[300:]]
    assert tok.encode_batch(docs) == want.encode_batch(docs)
    for got, w in zip(tok.encode_batch_arrays(docs),
                      want.encode_batch_arrays(docs)):
        np.testing.assert_array_equal(got, w)
    # the device path's memo == the per-word host DP
    for w in list(tok._memo)[:100]:
        assert tok._memo[w] == tok.encode_word(w)
    with pytest.raises(EncodeError):
        tok.encode("0123")                      # bytes the model lacks
    with pytest.raises(EncodeError):
        tok.decode([len(tok.pieces)])


def test_sharded_em_matches_single_device(tmp_path):
    """UnigramTrainer(shards=2) and (mesh=...) in two gloo ranks give the
    single-device pieces, and log_probs and log-likelihood within 1e-6
    relative: the plain version's float32 posteriors may differ by an ulp
    when a word sits in a slab of another width (PyTorch's CPU exp)."""
    text, kw = CORPORA["small"]
    path = tmp_path / "c.txt"
    path.write_text(text)
    single, _ = _train(UnigramTrainer, str(path), dict(kw, device="cpu"))
    ranks = workers.run_ranks(workers.unigram_sharded, 2, str(tmp_path),
                              str(path), kw, timeout=150)
    for rank in ranks:
        for pieces, log_probs, ll in rank:
            assert pieces == single.pieces
            np.testing.assert_allclose(log_probs, single.log_probs,
                                       rtol=1e-6)
            assert abs(ll - single.final_ll) <= 1e-6 * abs(ll)
