"""Unigram of the PyTorch port against the JAX package on a slice of the
Heaps-law corpus of BASELINE config 2 (``bench.make_big_corpus``), on
the CPU, with slabs small enough that the E-step and the encoder run
several of them, as they do at GB scale; and the port's GB-scale
measurement (``bench.measure_big_unigram``) on a tiny prefix.

Tolerances as in tests/test_torch_unigram.py: trained pieces exactly,
log_probs rtol=atol=1e-4 (the JAX package's own bound between its
backends), the log-likelihood 1e-6 relative + 1e-3; ids exactly.
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from shredword_tpu.models.unigram import UnigramTokenizer as JaxTokenizer
from shredword_tpu.models.unigram import UnigramTrainer as JaxTrainer
from shredword_tpu_torch import UnigramTokenizer, UnigramTrainer, bench
from shredword_tpu_torch.runtime import native
from test_torch_isolation import BLOCK, ROOT

SLICE_MB = 0.064        # the first ~64 KB: 5,278 unique words
# the E-step slab, patched on both trainers: max_word_len 16 puts the
# slice's words in buckets of 4,133 (7 slabs) and 1,145 (2), every slab
# in one of the JAX package's power-of-two widths (one XLA compile a
# bucket)
SLAB_WORDS = 600
SLABS = [7, 2]
ENC_SLAB_WORDS = 256    # encoder slab, patched on both tokenizers
CFG = dict(target_vocab_size=300, seed_size=3000, max_word_len=16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run many small ops, which PyTorch's CPU thread
    pool only slows down here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def heaps(tmp_path_factory):
    """(the one-block corpus of make_big_corpus(raw_mb=1), about 15 MB;
    its first SLICE_MB MB, cut after a newline)."""
    tmp = tmp_path_factory.mktemp("heaps")
    big = str(tmp / "big.txt")
    bench.make_big_corpus(big, 1)
    path = str(tmp / "slice.txt")
    with open(path, "wb") as f:
        f.write(bench.prefix_bytes(big, SLICE_MB))
    return big, path


def _train(cls, path, kw):
    t = cls(**kw)
    t.load_corpus(path)
    return t, t.train()


@pytest.fixture(scope="module")
def trained(heaps, tmp_path_factory):
    """The port on the CPU device (the kernels' plain versions) and the
    JAX device path (XLA on the CPU) trained on the slice, both with
    EM_SLAB_WORDS patched to SLAB_WORDS; the JAX model saved.  Returns
    (port trainer, JAX trainer, the JAX model's path)."""
    _, path = heaps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(UnigramTrainer, "EM_SLAB_WORDS", SLAB_WORDS)
        mp.setattr(JaxTrainer, "EM_SLAB_WORDS", SLAB_WORDS)
        port, n = _train(UnigramTrainer, path, dict(CFG, device="cpu"))
        mp.setenv("SHRED_INTERPRET_OK", "1")
        jax_t, jn = _train(JaxTrainer, path, CFG)
    assert n == jn == CFG["target_vocab_size"]
    model = str(tmp_path_factory.mktemp("model") / "u.model")
    jax_t.save(model)
    return port, jax_t, model


@pytest.fixture(scope="module")
def jax_model(trained):
    return trained[2]


def test_trainer_matches_jax_over_many_slabs(trained):
    """The same slabs in both length buckets, the same pieces, log_probs
    and log-likelihood."""
    port, jax_t, _ = trained
    half = CFG["max_word_len"] // 2
    got = [sum(dt.ids.shape[0] == L for dt in port._slabs)
           for L in (half, CFG["max_word_len"])]
    assert got == SLABS and len(jax_t._slabs) == sum(SLABS)
    assert port.pieces == jax_t.pieces
    np.testing.assert_allclose(port.log_probs, jax_t.log_probs, rtol=1e-4,
                               atol=1e-4)
    assert abs(port.final_ll - jax_t.final_ll) \
        <= 1e-6 * abs(jax_t.final_ll) + 1e-3


def test_tokenizer_matches_jax_over_many_slabs(heaps, jax_model,
                                               monkeypatch):
    """The JAX package's model loaded by the port's UnigramTokenizer
    (device "cpu": U2's plain version), ENC_SLAB_WORDS patched small on
    both tokenizers, encodes the slice and the next 64 KB (words the
    model never saw) to the JAX tokenizer's ids; decode round trips."""
    big, _ = heaps
    monkeypatch.setattr(UnigramTokenizer, "ENC_SLAB_WORDS", ENC_SLAB_WORDS)
    monkeypatch.setattr(JaxTokenizer, "ENC_SLAB_WORDS", ENC_SLAB_WORDS)
    text = bench.prefix_bytes(big, 2 * SLICE_MB).decode()
    tok = UnigramTokenizer.load(jax_model, device="cpu")
    want = JaxTokenizer.load(jax_model)
    ids = tok.encode_array(text)
    np.testing.assert_array_equal(ids, want.encode_array(text))
    assert len(tok._memo) > 10 * ENC_SLAB_WORDS
    norm = native.normalize(text.encode())
    assert tok.decode_bytes(ids) == want.decode_bytes(ids) \
        == bench.marker_words(norm)
    assert tok.decode(ids) == " ".join(text.split()).lower()


def test_measure_big_unigram_runs_on_the_cpu(heaps, tmp_path):
    """measure_big_unigram on a tiny prefix with device "cpu" (the plain
    versions: no launch counted, no device time) and a small config in
    place of UNI_DEFAULT, in a process where jax, the JAX package and
    its bench cannot be imported: every key, its checks over several
    slabs of both buckets, then the encode of a longer prefix with the
    saved model, in a second call."""
    big, _ = heaps
    model = str(tmp_path / "u.model")
    code = BLOCK + textwrap.dedent(f"""
        import json

        import torch

        from shredword_tpu_torch import UnigramTrainer, bench

        torch.set_num_threads(1)
        UnigramTrainer.EM_SLAB_WORDS = 200
        bench.UNI_DEFAULT = dict(target_vocab_size=200, seed_size=2000,
                                 max_word_len=16)
        a = bench.measure_big_unigram({big!r}, "cpu", 0.03,
                                      save_to={model!r})
        b = bench.measure_big_unigram({big!r}, "cpu", 0, encode_mb=0.05,
                                      model={model!r})
        print(json.dumps([a, b]))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    a, b = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(a) == {
        "mb", "bytes", "launches", "u1_ms", "u2_prune_ms", "layers",
        "load_s", "train_s", "train_mbs", "pieces", "unique_words",
        "occurrences", "max_count", "count_f32_max_err", "seed_entries",
        "slabs", "final_ll", "ll_per_word", "ll_per_byte",
        "peak_device_bytes", "peak_rss_bytes", "peak_rss_load_bytes",
        "pieces_per_word", "checks"}
    assert 0 < a["peak_rss_load_bytes"] <= a["peak_rss_bytes"]
    assert set(a["layers"]) == {
        "load: normalize", "load: read, split and count", "seed: adds",
        "seed: export and sort", "seed: free", "seed: singles", "tables",
        "e_step", "m_step", "prune"}
    assert min(a["layers"].values()) >= 0
    assert a["launches"] == {"U1": 0, "U2": 0}
    assert a["u1_ms"] is None and a["u2_prune_ms"] is None
    assert a["pieces"] == 200 and a["bytes"] <= 30000
    assert a["seed_entries"] > 2000 and a["count_f32_max_err"] == 0
    n = a["slabs"]
    assert len(n) == 2 and min(n.values()) >= 2
    # the first, a middle and the last slab of each bucket
    assert len(a["checks"]["u1"]) == 6
    assert all(c["max_abs_err"] == 0 for c in a["checks"]["u1"])
    assert a["checks"]["u2"]["identical"]
    assert set(b) == {"mb", "encode"}
    e = b["encode"]
    assert set(e) == {
        "bytes", "s", "mbs", "layers", "u2_ms", "launches", "distinct",
        "n_ids", "words", "pieces_per_word", "peak_device_bytes",
        "rss_bytes", "sample_flips", "decode_bytes", "decode"}
    assert set(e["layers"]) == {
        "normalize", "marker_word_dedup", "viterbi slabs",
        "viterbi slabs: piece tables", "viterbi slabs: viterbi",
        "viterbi slabs: the rest", "expand_ids", "the rest"}
    assert e["sample_flips"] == 0 and e["n_ids"] >= e["words"] > 5000
    assert set(e["decode"]) == set(e["decode_bytes"]) \
        == {"s", "mbs", "rss_bytes"}


def test_prefix_bytes_cuts_after_a_newline(tmp_path):
    path = tmp_path / "c.txt"
    path.write_bytes(b"ab cd\nef gh\nij\n")
    assert bench.prefix_bytes(str(path), 8e-6) == b"ab cd\n"
    assert bench.prefix_bytes(str(path), 12e-6) == b"ab cd\nef gh\n"
    assert bench.prefix_bytes(str(path), 1) == path.read_bytes()
    with pytest.raises(bench.BenchError):
        bench.prefix_bytes(str(path), 3e-6)


@pytest.mark.parametrize("text", [
    "the cat\nsat on the mat\n", "  lead and trail  \n\n\nx\n", "one",
    "", "\n\n", "a\tb\r\nc d"])
def test_marker_words_are_what_the_ids_decode_to(jax_model, text):
    """marker_words of the normalized text == the JAX tokenizer's
    decode_bytes of its ids (every byte here is a piece)."""
    tok = JaxTokenizer.load(jax_model)
    norm = native.normalize(text.encode())
    assert bench.marker_words(norm) \
        == tok.decode_bytes(tok.encode_array(text))


def test_checked_slabs_are_the_ends_and_middle_of_each_bucket():
    assert bench.checked_slabs([16] * 7 + [32] * 2) == {0, 3, 6, 7, 8}
    assert bench.checked_slabs([16]) == {0}
    assert bench.checked_slabs([]) == set()
