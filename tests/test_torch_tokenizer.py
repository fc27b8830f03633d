"""The port's Tokenizer (shredword_tpu_torch.Tokenizer) on the CPU against
the JAX package's on both of its backends: the cases of
tests/test_tokenizer.py and tests/test_edges.py, models saved by either
package loading in the other, and the port's own copies of the native
host helpers and the GPT class table.  The port's "cuda" backend runs
with device="cpu" here, i.e. the encode kernel's plain versions.  Ids are
integers, so every comparison is exact."""

import numpy as np
import pytest
import torch
from torch_encode_cases import FHUS, random_merges

import shredword_tpu
import shredword_tpu_torch
from shredword_tpu import Tokenizer as JaxTokenizer
from shredword_tpu_torch import Tokenizer, merge, pretokenize
from shredword_tpu_torch.bench import big_documents
from shredword_tpu_torch.errors import ConfigError, DecodeError, EncodeError

BACKENDS = ("cuda", "cpu")          # the port's; "cuda" on device="cpu"
PATTERNS = ("", "gpt", "prefix", "word", "lossy")


def _tok(merges, backend="cuda", **kw):
    return Tokenizer(merges=merges, backend=backend, device="cpu", **kw)


def _jax_ids(merges, text, pattern="", backend="cpu"):
    return JaxTokenizer(merges=merges, pattern=pattern,
                        backend=backend).encode(text)


def oracle_encode_chunk(data: bytes, merges) -> list[int]:
    """The contract spelled out with the port's ``merge``: the lowest-rank
    pair present, every occurrence left to right, until none is left."""
    ranks = {}
    for m, (a, b) in enumerate(merges):
        ranks.setdefault((int(a), int(b)), m)
    ids = list(data)
    while len(ids) >= 2:
        best = min((ranks.get(p, 1 << 60) for p in zip(ids, ids[1:])),
                   default=1 << 60)
        if best >= 1 << 60:
            break
        ids = merge(ids, tuple(int(x) for x in merges[best]), 256 + best)
    return ids


@pytest.fixture(scope="module")
def trained(tmp_path_factory, zipf_corpus_text):
    p = tmp_path_factory.mktemp("tok") / "corpus.txt"
    p.write_text(zipf_corpus_text)
    return Tokenizer.train(str(p), vocab_size=384, device="cpu")


def test_train_matches_jax(trained, zipf_corpus_file):
    want = JaxTokenizer.train(zipf_corpus_file, vocab_size=384,
                              backend="tpu")
    np.testing.assert_array_equal(trained.merges, want.merges)
    assert len(trained.merges) == 128
    assert trained.backend == "cuda" and trained.device.type == "cpu"


@pytest.mark.parametrize("pattern", PATTERNS)
def test_patterns_match_jax_both_backends(trained, zipf_corpus_text,
                                          pattern):
    """Every pattern, both port backends, both JAX backends: equal ids;
    decode round-trips except for the lossy pattern."""
    text = (zipf_corpus_text[:3000] + " Hello WORLD'S we've 12345 test...  "
            "\n\nnew-line\ttabs it'll o'clock 世界 🙂 x aaaa aaa zzz")
    want = _jax_ids(trained.merges, text, pattern)
    assert _jax_ids(trained.merges, text, pattern, "tpu") == want
    for backend in BACKENDS:
        tok = _tok(trained.merges, backend, pattern=pattern)
        assert tok.encode(text) == want, backend
        if pattern != "lossy":
            assert tok.decode(want) == text


def test_encode_matches_oracle(trained, zipf_corpus_text):
    text = zipf_corpus_text[:2000] + " aaaa aaa zzz"
    expected = []
    for c in pretokenize.whitespace_keep_split(text.encode("utf-8")):
        expected.extend(oracle_encode_chunk(c, trained.merges))
    for backend in BACKENDS:
        assert _tok(trained.merges, backend).encode(text) == expected


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("merges, text, want", [
    (np.array([[97, 97]], np.int32), "aaaa", [256, 256]),
    (np.array([[97, 97]], np.int32), "aaa", [256, 97]),
    # a distant lowest-rank merge creates a pair that beats an existing
    # local minimum (test_tpu_encode_created_pair_preemption)
    (FHUS, "fhus", [102, 257]),
], ids=["aaaa", "aaa", "fhus"])
def test_merge_order_cases(merges, text, want, backend):
    assert _tok(merges, backend).encode(text) == want
    assert JaxTokenizer(merges=merges).encode(text) == want


def test_rank_order_fuzz(zipf_corpus_file):
    """Dense differential over real-corpus words: the faithful engine's
    merges, both port backends against the JAX native encoder."""
    tok = Tokenizer.train(zipf_corpus_file, vocab_size=600, min_pair_freq=5,
                          character_coverage=0.9995, backend="cpu",
                          tie_break="faithful")
    assert tok.backend == "cpu"
    jt = JaxTokenizer(merges=tok.merges)
    dev = _tok(tok.merges)
    with open(zipf_corpus_file) as f:
        words = f.read().split()[:3000]
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(words, int(rng.integers(1, 8))))
             for _ in range(300)]
    for s in texts:
        want = jt.encode(s)
        assert tok.encode(s) == want, repr(s)
        assert dev.encode(s) == want, repr(s)
    assert dev.encode_batch(texts) == [jt.encode(s) for s in texts]


def test_random_merges_and_unk_merges_match_jax():
    """Deep random merge chains, a repeated pair and merges naming ids
    outside the vocab (as the faithful engine's unk merges can), at the
    dense (v 768) and the hash table (v 5000)."""
    rng = np.random.RandomState(3)
    text = " ".join("".join(chr(97 + c) for c in rng.randint(0, 6, k))
                    for k in rng.randint(1, 30, 1500))
    for v in (768, 5000):
        merges = random_merges(v, v - 256)
        want = _jax_ids(merges, text, backend="tpu")
        assert _jax_ids(merges, text) == want
        for backend in BACKENDS:
            assert _tok(merges, backend).encode(text) == want
        assert len(want) < 0.7 * len(text)


def test_special_tokens(trained):
    tok = _tok(trained.merges)
    tok.register_special_tokens({"<|eot|>": 1000, "<|sot|>": 1001})
    text = "<|sot|>hello world<|eot|>"
    with pytest.raises(EncodeError):
        tok.encode(text)  # none_raise default
    ids = tok.encode(text, allowed_special="all")
    assert ids[0] == 1001 and ids[-1] == 1000
    assert tok.decode(ids) == text
    ids2 = tok.encode(text, allowed_special={"<|eot|>"})
    assert ids2[-1] == 1000 and 1001 not in ids2
    jt = JaxTokenizer(merges=trained.merges,
                      special_tokens=tok.special_tokens)
    for allowed in ("all", {"<|eot|>"}, "none"):
        assert tok.encode(text, allowed_special=allowed) == \
            jt.encode(text, allowed_special=allowed)
    with pytest.raises(EncodeError):
        tok.encode(text, allowed_special=3)


@pytest.mark.parametrize("pattern", ["", "gpt"])
def test_endoftext_documents_match_jax(pattern):
    """Documents cut right after a newline and joined by a registered
    <|endoftext|> (64 KB documents in the 1 GB run, 2 KB here): the
    port's encode(allowed_special="all") == the JAX package's == each
    document's ids with the special's id between them, decode gives the
    joined text back, and encode_batch with the special registered (the
    per-text path) == encode_batch_arrays without it."""
    merges = random_merges(41, 900, alpha=26)
    rng = np.random.RandomState(42)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, k))
             for k in rng.randint(1, 12, 4000)]
    text = "".join(w + ("\n" if i % 16 == 15 else " ")
                   for i, w in enumerate(words))
    docs = big_documents(text, 2048)
    assert len(docs) >= 10 and all(d.endswith("\n") for d in docs)
    eot = 256 + len(merges)
    plain = _tok(merges, pattern=pattern)
    per_doc = plain.encode_batch_arrays(docs)
    tok = _tok(merges, pattern=pattern,
               special_tokens={"<|endoftext|>": eot})
    joined = "<|endoftext|>".join(docs)
    ids = tok.encode(joined, allowed_special="all")
    want = []
    for i, d in enumerate(per_doc):
        want += ([eot] if i else []) + d.tolist()
    assert ids == want
    jt = JaxTokenizer(merges=merges, pattern=pattern,
                      special_tokens={"<|endoftext|>": eot}, backend="tpu")
    assert ids == jt.encode(joined, allowed_special="all")
    assert tok.decode(ids) == joined
    batch = tok.encode_batch(docs)
    assert batch == [d.tolist() for d in per_doc]
    assert np.array_equal(np.concatenate(per_doc), plain.encode_array(text))


def test_special_id_collision_rejected(trained):
    tok = _tok(trained.merges)
    with pytest.raises(EncodeError):
        tok.register_special_tokens({"<|bad|>": 10})
    with pytest.raises(EncodeError):
        _tok(trained.merges, special_tokens={"<|bad|>": 300})


def test_decode_error_modes():
    tok = _tok(np.array([[104, 105]], np.int32))  # "hi"
    assert tok.decode_bytes([104, 105, 256]) == b"hihi"
    assert tok.decode_bytes(np.array([256, 33])) == b"hi!"
    with pytest.raises(DecodeError):
        tok.decode_bytes([256, 999], errors="strict")
    with pytest.raises(DecodeError):
        tok.decode_bytes([999], errors="bogus")
    assert tok.decode_bytes([104, 999], errors="ignore") == b"h"
    assert tok.decode_bytes([999], errors="replace").decode() == "�"
    assert tok.decode([999]) == "�"
    assert tok.decode_bytes([]) == b""
    text = "hello high hills"
    assert tok.decode(tok.encode(text)) == text


@pytest.mark.parametrize("pattern", ["", "gpt"])
def test_encode_batch_matches_per_text(pattern):
    rng = np.random.default_rng(3)
    corpus = [" ".join("".join(chr(97 + c) for c in rng.integers(0, 26, 5))
                       for _ in range(20)) for _ in range(8)] + ["", "a"]
    merges = random_merges(5, 300, alpha=26)
    tok = _tok(merges, pattern=pattern)
    batch = tok.encode_batch(corpus)
    assert batch == [tok.encode(t) for t in corpus]
    assert batch == [_jax_ids(merges, t, pattern) for t in corpus]
    arrays = tok.encode_batch_arrays(corpus)
    assert [a.tolist() for a in arrays] == batch
    assert all(a.dtype == np.int32 for a in arrays)


@pytest.mark.parametrize("pattern", ["", "gpt", "word"])
def test_splice_of_long_chunks_matches_jax(pattern, monkeypatch):
    """Chunks over 64 bytes: the JAX tpu backend splices them in through
    encode_chunks; the port encodes them in the same call as the short
    ones (one encode_core call per encode_array or encode_batch), to the
    same ids, one output per text in encode_batch."""
    from shredword_tpu_torch.ops import encode_ops

    calls = []
    core = encode_ops.encode_core
    monkeypatch.setattr(encode_ops, "encode_core",
                        lambda *a, **k: calls.append(1) or core(*a, **k))
    merges = random_merges(9, 400, alpha=6)
    rng = np.random.RandomState(10)
    texts = [" ".join("".join(chr(97 + c) for c in rng.randint(0, 6, k))
                      for k in rng.randint(1, 120, 40)) for _ in range(3)]
    for text in texts:
        want = _jax_ids(merges, text, pattern, "tpu")
        assert _jax_ids(merges, text, pattern) == want
        for backend in BACKENDS:
            assert _tok(merges, backend, pattern=pattern).encode(text) == want
    tok = _tok(merges, pattern=pattern)
    calls.clear()
    tok.encode_array(texts[0])
    assert len(calls) == 1
    assert max(len(c) for c in tok._chunks(texts[0])) > 64
    calls.clear()
    batch = tok.encode_batch(texts)
    assert len(calls) == 1
    assert batch == [tok.encode(t) for t in texts]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("text", [
    "", "   \t\n  ", "naïve café — ☃ 日本語 🙂 \x00\x01 mixed",
    bytes(range(256)).decode("latin-1")], ids=["empty", "whitespace",
                                               "unicode", "all_bytes"])
def test_edges_roundtrip(trained, backend, text):
    tok = _tok(trained.merges, backend)
    ids = tok.encode_ordinary(text)
    assert ids == _jax_ids(trained.merges, text)
    assert tok.decode_bytes(ids) == text.encode("utf-8")
    assert tok.decode(ids) == text


def test_mutable_state_rebuilds(trained):
    tok = _tok(trained.merges)
    before = tok.encode("hello there")
    tok.merges = trained.merges[:10]
    assert tok.encode("hello there") == _jax_ids(trained.merges[:10],
                                                 "hello there")
    tok.merges = trained.merges
    assert tok.encode("hello there") == before
    tok.pattern = "gpt"
    assert tok.pattern == "gpt"
    tok.special_tokens = {"<|x|>": 5000}
    assert tok.vocab[5000] == b"<|x|>" and tok.vocab_size == 256 + 128 + 1
    with pytest.raises(ConfigError):
        tok.backend = "tpu"


def test_cuda_backend_needs_a_card(trained):
    """backend="cuda" on a host without a CUDA device raises ConfigError,
    at construction and at load; backend="cpu" needs no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(ConfigError):
        Tokenizer(merges=trained.merges)
    tok = Tokenizer(merges=trained.merges, backend="cpu")
    assert tok.encode("hello") == _jax_ids(trained.merges, "hello")
    with pytest.raises(ConfigError):
        tok.backend = "cuda"


@pytest.mark.parametrize("kind", ["binary", "v1", "v1_pattern_special"])
def test_models_cross_packages(trained, tmp_path, kind):
    """A model saved by either package loads in the other and encodes to
    the same ids; both save byte-identical files."""
    kw = {}
    name = "t.model" if kind == "binary" else "t.v1.model"
    if kind == "v1_pattern_special":
        kw = dict(pattern="gpt", special_tokens={"<|eot|>": 9000,
                                                 "<|my tok|>": 9001})
    port = _tok(trained.merges, **kw)
    jax = JaxTokenizer(merges=trained.merges, **kw)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pm, jm = str(tmp_path / "p" / name), str(tmp_path / "j" / name)
    port.save(pm, str(tmp_path / "p" / "t.vocab"))
    jax.save(jm, str(tmp_path / "j" / "t.vocab"))
    for f in (name, "t.vocab"):
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    text = "round trip! it's 1234 <|eot|> done"
    allowed = "all" if kw else "none"
    from_jax = Tokenizer.load(jm, device="cpu")
    from_port = JaxTokenizer.load(pm)
    assert from_jax.pattern == from_port.pattern == kw.get("pattern", "")
    assert from_jax.special_tokens == from_port.special_tokens
    want = jax.encode(text, allowed_special=allowed)
    assert from_jax.encode(text, allowed_special=allowed) == want
    assert from_port.encode(text, allowed_special=allowed) == want
    # the instance form mutates in place
    other = _tok(np.zeros((0, 2), np.int32))
    assert other.load(jm) is other
    np.testing.assert_array_equal(other.merges, trained.merges)


def test_serialization_matches_jax(trained, tmp_path):
    from shredword_tpu import serialization as js
    from shredword_tpu_torch import serialization as ps
    from shredword_tpu_torch.errors import SerializationError

    special = {"<|eot|>": 9000}
    ps.write_model_v1(str(tmp_path / "p.txt"), trained.merges, "word",
                      special)
    js.write_model_v1(str(tmp_path / "j.txt"), trained.merges, "word",
                      special)
    assert (tmp_path / "p.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    ps.convert(str(tmp_path / "p.txt"), str(tmp_path / "p2.v1.model"))
    m, pat, sp = ps.read_model_any(str(tmp_path / "p2.v1.model"))
    np.testing.assert_array_equal(m, trained.merges)
    assert (pat, sp) == ("word", special)
    ps.write_model_binary(str(tmp_path / "b.model"), trained.merges)
    ps.convert(str(tmp_path / "b.model"), str(tmp_path / "b.txt"))
    assert js.read_model_any(str(tmp_path / "b.txt"))[1:] == ("", {})
    with pytest.raises(SerializationError):
        ps.convert(str(tmp_path / "p.txt"), str(tmp_path / "x.model"))
    with pytest.raises(SerializationError):
        ps.write_model_v1(str(tmp_path / "y.txt"), trained.merges, "a\nb")


def test_native_helpers_match_jax():
    """The port's copies of the native host helpers equal the JAX
    package's on seeded data."""
    from shredword_tpu.runtime import native as jn
    from shredword_tpu_torch.runtime import native as pn

    rng = np.random.RandomState(4)
    alphabet = np.frombuffer(b"abcab  \t\n\rxyz'.,", np.uint8)
    data = alphabet[rng.randint(0, len(alphabet), 20000)].tobytes()
    data += "héllo wörld ✓ ".encode() * 50
    for got, want in zip(pn.ws_chunk_dedup(data), jn.ws_chunk_dedup(data)):
        np.testing.assert_array_equal(got, want)
    flat = np.frombuffer(data, np.uint8)
    lens = rng.randint(0, 6, 3000).astype(np.int64)
    off = rng.randint(0, len(flat) - 6, 3000).astype(np.int64)
    inv, uniq = pn.dedup_spans(flat, off, lens)
    for got, want in zip((inv, uniq), jn.dedup_spans(flat, off, lens)):
        np.testing.assert_array_equal(got, want)
    cnt = rng.randint(0, 4, len(uniq))
    uoff = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    ids_u = rng.randint(0, 1000, int(uoff[-1])).astype(np.int32)
    total = int(cnt[inv].sum())
    np.testing.assert_array_equal(pn.expand_ids(ids_u, uoff, inv, total),
                                  jn.expand_ids(ids_u, uoff, inv, total))
    ids = rng.randint(0, 300, 2000).astype(np.int32)
    plen = rng.randint(0, 5, 301)
    poff = np.concatenate([[0], np.cumsum(plen)]).astype(np.int64)
    pflat = rng.randint(0, 256, int(poff[-1])).astype(np.uint8)
    nbytes = int(plen[ids].sum())
    assert pn.expand_bytes(pflat, poff, ids, nbytes) == \
        jn.expand_bytes(pflat, poff, ids, nbytes)
    for text in (data, b"  Hello\tWORLD  \n", b""):
        assert pn.normalize(text) == jn.normalize(text)
    from shredword_tpu.ops.pretok_ops import class_table as jax_table
    from shredword_tpu_torch.ops.pretok_ops import class_table

    np.testing.assert_array_equal(class_table(), jax_table())
    gpt = "Hello WORLD'S we've 12345 test...  \n\n世界 🙂 x".encode() + data
    np.testing.assert_array_equal(pn.gpt_starts_bytes(gpt, class_table()),
                                  jn.gpt_starts_bytes(gpt, jax_table()))
    merges = random_merges(6, 300, alpha=26)
    pe, je = pn.NativeEncoder(merges), jn.NativeEncoder(merges)
    np.testing.assert_array_equal(pe.encode_text(data), je.encode_text(data))
    np.testing.assert_array_equal(pe.encode_text(data, nthreads=3),
                                  je.encode_text(data))
    words = np.frombuffer(data, np.uint8)
    woff = np.concatenate([[0], np.cumsum(rng.randint(1, 9, 2000))])
    woff = woff[woff <= len(words)].astype(np.int64)
    np.testing.assert_array_equal(pe.encode_words(words, woff),
                                  je.encode_words(words, woff))
    pe.free()
    je.free()


def test_pretokenize_matches_jax():
    from shredword_tpu import pretokenize as jp

    text = ("Hello WORLD'S we've 12345 test...  \n\nnew-line\ttabs   "
            "it'll o'clock 世界 🙂 x")
    for pattern in PATTERNS[1:]:
        assert pretokenize.regex_split(text, pattern) == \
            jp.regex_split(text, pattern)
    data = text.encode()
    assert pretokenize.whitespace_keep_split(data) == \
        jp.whitespace_keep_split(data)
    assert pretokenize.whitespace_split(data) == jp.whitespace_split(data)
    special = {"<|a|>": 1, "<|ab|>": 2}
    s = "x<|ab|>y<|a|>z"
    for allowed in (None, {"<|a|>"}):
        assert pretokenize.split_special(s, special, allowed) == \
            jp.split_special(s, special, allowed)


def test_exports_match_jax_package():
    names = ["Tokenizer", "build_vocab", "get_stats", "merge",
             "render_token", "ShredError", "CorpusError", "ConfigError",
             "TrainingError", "SerializationError", "EncodeError",
             "DecodeError"]
    for name in names:
        assert name in shredword_tpu_torch.__all__
        assert hasattr(shredword_tpu, name)
    ids = [1, 2, 3, 1, 2]
    assert shredword_tpu_torch.get_stats(ids) == shredword_tpu.get_stats(ids)
    assert shredword_tpu_torch.build_vocab(FHUS, {"<s>": 300}) == \
        shredword_tpu.build_vocab(FHUS, {"<s>": 300})
    assert shredword_tpu_torch.render_token(b"a\nb\xff") == \
        shredword_tpu.render_token(b"a\nb\xff")
