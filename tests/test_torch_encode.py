"""The port's encoder (shredword_tpu_torch.ops.encode_ops) against the JAX
package's (shredword_tpu.ops.encode_ops) on the CPU: the rank tables,
the plain versions of the encode kernel (csrc/encode.cu) against
_encode_device, _encode_device_hash and encode_chunks, the host
entry points encode_stream and encode_ws_text, and the Tokenizer with
merge tables whose ids pass 32767 and 65535.  Inputs are seeded numpy
arrays; the outputs are integer ids, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_encode_cases import (FHUS, boundary_cases, high_id_merges,
                                random_chunks, random_merges)

from shredword_tpu import Tokenizer as JaxTokenizer
from shredword_tpu.ops import encode_ops as J
from shredword_tpu.pretokenize import whitespace_keep_split
from shredword_tpu_torch import Tokenizer
from shredword_tpu_torch.ops import encode_ops as P


def _tables(merges, v):
    """(JAX table, port table on the CPU) as encode_stream picks them."""
    if v <= P.DENSE_V_MAX:
        return J.build_rank_table(merges, v), P.build_rank_table(merges, v,
                                                                 "cpu")
    return J.build_merge_table(merges), P.build_merge_table(merges, "cpu")


@pytest.mark.parametrize("v", [300, 768, 4096, 5000])
def test_tables_match_jax(v):
    merges = random_merges(v, v - 256)
    jd, pd = J.build_rank_table(merges, v), P.build_rank_table(merges, v,
                                                               "cpu")
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    jh, ph = J.build_merge_table(merges), P.build_merge_table(merges, "cpu")
    assert ph.max_probe == jh.max_probe and ph.v == 256 + len(merges)
    for got, want in ((ph.ka, jh.ka), (ph.kb, jh.kb), (ph.rank, jh.rank)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the hash lookup over every id pair a chunk can hold, and invalid ones
    rng = np.random.RandomState(v)
    a = rng.randint(-1, v, 4000).astype(np.int32)
    b = rng.randint(-1, v, 4000).astype(np.int32)
    a[:len(merges)], b[:len(merges)] = merges[:4000].T
    valid = (a >= 0) & (b >= 0) & (rng.rand(4000) < 0.9)
    want = J.lookup_ranks(jh, jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(valid))
    got = P.lookup_ranks_plain(ph, torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_encode_device(flat, lens, table, v):
    """(ids, counts) of the JAX package's _encode_device(_hash) over one
    block of contiguous chunks."""
    W = len(lens)
    Wb = 1 << max(8, (W - 1).bit_length())
    lens_w = np.zeros(Wb, np.uint8)
    lens_w[:W] = lens
    gb = np.full(16, W, np.int32)
    gb[0] = 0
    dflat = jnp.asarray(np.concatenate([flat, np.zeros(64, np.uint8)]))
    kw = dict(v=v, L=64, out_cap=int(lens.sum()))
    if isinstance(table, J.MergeTable):
        ids, _, cnt = J._encode_device_hash(
            dflat, None, jnp.asarray(lens_w), jnp.asarray(gb), table.ka,
            table.kb, table.rank, max_probe=table.max_probe, **kw)
    else:
        ids, _, cnt = J._encode_device(dflat, None, jnp.asarray(lens_w),
                                       jnp.asarray(gb), table, **kw)
    cnt = np.asarray(cnt)[:W].astype(np.int64)
    return np.asarray(ids)[:cnt.sum()].astype(np.int32), cnt


@pytest.mark.parametrize("v", [300, 768, 5000])
def test_encode_core_plain_matches_jax(v):
    """encode_core_plain (dense below vocab 4097, hash above) against
    _encode_device / _encode_device_hash, and encode_flat_plain with the
    same table on the same chunks."""
    merges = random_merges(v, v - 256)
    flat, lens = random_chunks(v + 1, 700)
    jt, pt = _tables(merges, v)
    want_ids, want_counts = _jax_encode_device(flat, lens, jt, v)
    tf, tl = torch.from_numpy(flat), torch.from_numpy(lens.astype(np.int32))
    ids, counts = P.encode_core_plain(tf, tl, pt, v)
    assert ids.dtype == P.out_dtype(v) == torch.int16
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(P.ids_to_numpy(ids), want_ids)
    assert len(want_ids) < 0.9 * len(flat)              # merges fired
    st = P.encode_flat_plain(tf.int(), torch.repeat_interleave(
        torch.arange(len(lens), dtype=torch.int32), tl.long()), len(flat),
        pt, num_chunks=len(lens), v=v)
    np.testing.assert_array_equal(st.tokens[:st.length].numpy(), want_ids)
    # the wrapper takes the plain version for CPU tensors
    got = P.encode_core(tf, tl, pt, v=v)
    np.testing.assert_array_equal(P.ids_to_numpy(got[0]), want_ids)
    np.testing.assert_array_equal(got[1].numpy(), want_counts)


@pytest.mark.parametrize("kind", ["dense", "hash"])
@pytest.mark.parametrize("case", sorted(boundary_cases()))
def test_length_class_edges_match_jax(case, kind):
    """The edges of the kernel's length classes (chunks of exactly 1, 2,
    8, 9, 16, 17, 32, 33, 64 and 65 bytes; 'a' runs of 2-70 bytes under
    (a, a) merges; windows mixing one-byte chunks with longer ones)
    through encode_core on the CPU: the chunks of at most 64 bytes
    against _encode_device / _encode_device_hash, and all of them against
    encode_chunks."""
    flat, lens, merges = boundary_cases()[case]
    v = 256 + len(merges)
    jt, pt = (J.build_rank_table(merges, v), P.build_rank_table(
        merges, v, "cpu")) if kind == "dense" else (
        J.build_merge_table(merges), P.build_merge_table(merges, "cpu"))
    short = lens <= P.MAX_TW_LEN
    starts = np.cumsum(lens) - lens
    chunks = [flat[s:s + n].tobytes() for s, n in zip(starts, lens)]
    sflat = np.frombuffer(b"".join(c for c, k in zip(chunks, short) if k),
                          np.uint8).copy()
    want_ids, want_counts = _jax_encode_device(sflat, lens[short], jt, v)
    ids, counts = P.encode_core(torch.from_numpy(sflat), torch.from_numpy(
        lens[short].astype(np.int32)), pt, v=v)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(P.ids_to_numpy(ids), want_ids)
    want, want_cid = J.encode_chunks(chunks, J.build_merge_table(merges),
                                     return_chunk_ids=True)
    ids, counts = P.encode_core(torch.from_numpy(flat), torch.from_numpy(
        lens.astype(np.int32)), pt, v=v)
    np.testing.assert_array_equal(P.ids_to_numpy(ids), want)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(want_cid, minlength=len(lens)))
    assert len(want) < 0.8 * len(flat) and (lens > P.MAX_TW_LEN).any()


@pytest.mark.parametrize("v", [300, 5000])
def test_encode_flat_plain_matches_jax_encode_chunks(v):
    """Chunks over 64 bytes: the JAX package's encode_chunks
    (encode_flat) against the port's, which runs encode_flat_plain
    through the encode_core wrapper on the CPU."""
    merges = random_merges(v + 2, v - 256)
    flat, lens = random_chunks(v + 3, 30, n_long=20)
    starts = np.cumsum(lens) - lens
    chunks = [flat[s:s + n].tobytes() for s, n in zip(starts, lens)]
    jt, pt = J.build_merge_table(merges), P.build_merge_table(merges, "cpu")
    want = J.encode_chunks(chunks, jt, return_chunk_ids=True)
    got = P.encode_chunks(chunks, pt, return_chunk_ids=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert P.encode_chunks([], pt).shape == (0,)


@pytest.mark.parametrize("v, n_base, n_chunks, dedup", [
    (768, 150, 3000, True), (768, 150, 500, False), (768, 2500, 2600, False),
    (5000, 150, 2500, True)])
def test_encode_stream_matches_jax(v, n_base, n_chunks, dedup):
    """Groups, with the JAX package on its dedup path (from
    DEDUP_MIN_CHUNKS chunks on, when at most half of them are distinct)
    or its direct one; the port encodes every chunk in either case."""
    merges = random_merges(v + 4, v - 256)
    base, base_lens = random_chunks(v + 5, n_base, max_len=12)
    reps = np.random.RandomState(v).randint(0, n_base, n_chunks)
    starts = np.cumsum(base_lens) - base_lens
    flat = np.concatenate([base[starts[r]:starts[r] + base_lens[r]]
                           for r in reps])
    lens = base_lens[reps]
    off = np.cumsum(lens) - lens
    taken = (n_chunks >= J.DEDUP_MIN_CHUNKS
             and J._try_dedup(flat, off, lens) is not None)
    assert taken == dedup
    bounds = np.array([0, 7, 7, n_chunks // 2, n_chunks], np.int64)
    want = J.encode_stream(flat, lens, merges, v, bounds, {})
    cache = {}
    got = P.encode_stream(flat, lens, merges, v, bounds, cache,
                          device="cpu")
    assert len(got) == len(want) == 4 and len(got[1]) == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(cache) == [("table", v, "cpu")]
    empty = P.encode_stream(flat[:0], lens[:0], merges, v, device="cpu")
    assert len(empty) == 1 and empty[0].shape == (0,)


def test_encode_ws_text_matches_jax():
    merges = random_merges(11, 512, alpha=26)
    rng = np.random.RandomState(12)
    words = [(97 + rng.randint(0, 26, k)).astype(np.uint8).tobytes()
             for k in rng.randint(1, 10, 400)]
    seps = [b" ", b"  ", b"\n", b"\t "]
    data = b"".join(words[i] + seps[i % 4] for i in rng.randint(0, 400, 5000))
    flat = np.frombuffer(data, np.uint8)
    want = J.encode_ws_text(flat, merges, 768, {})
    got = P.encode_ws_text(flat, merges, 768, {}, device="cpu")
    assert want is not None and len(want) < len(flat)      # merges fired
    np.testing.assert_array_equal(got, want)
    # a chunk over 64 bytes: the JAX package returns None and its
    # Tokenizer splices the chunk in through encode_chunks; the port
    # encodes it in the same call, to the same ids
    long_data = data[:100] + b"x" * 65 + b"ab" * 40 + b" y"
    long = np.frombuffer(long_data, np.uint8)
    assert J.encode_ws_text(long, merges, 768, {}) is None
    want = J.encode_chunks(whitespace_keep_split(long_data),
                           J.build_merge_table(merges))
    got = P.encode_ws_text(long, merges, 768, {}, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert P.encode_ws_text(flat[:0], merges, 768, device="cpu").shape == (0,)


@pytest.fixture
def one_thread():
    """One PyTorch thread: the plain versions' many small ops run many
    times slower when the test workers' thread pools oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("v", [65536, 131072])
def test_tokenizer_ids_past_32767_match_jax(v, one_thread):
    """A merge table of vocab v (high_id_merges: most ranks name pairs
    that never occur, the last ones make ids past 32767, stored as int16
    up to vocab 65536, and past 65535 above it, in int32): the port's
    Tokenizer (the encode kernel's plain versions) gives the ids of the
    JAX package's device path on the CPU, and decode round-trips."""
    merges = high_id_merges(v, v - 256)
    rng = np.random.RandomState(v)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 8, k))
             for k in rng.randint(1, 14, 2000)]
    text = " ".join(words) + " gggh ghhg hg\tgh\n"
    want = JaxTokenizer(merges=merges, backend="tpu").encode(text)
    tok = Tokenizer(merges=merges, device="cpu")
    got = tok.encode(text)
    assert got == want
    assert max(got) == v - 1 and 32771 in got and 32772 in got
    assert tok.decode(got) == text


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ws_chunk_lens_match_whitespace_keep_split(seed):
    """encode_ws_text's numpy chunking gives the chunks of the port's
    whitespace_keep_split, whatever their length."""
    from shredword_tpu_torch.pretokenize import whitespace_keep_split as split

    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ab \t\r\n\x00\xff", np.uint8)
    for n in (0, 1, 2, 300):
        flat = alphabet[rng.randint(0, len(alphabet), n)]
        flat[: n // 3] = 97 if seed else 32         # a long run
        want = [len(c) for c in split(flat.tobytes())]
        assert P.ws_chunk_lens(flat).tolist() == want


def test_created_pair_preemption_and_overlap_runs():
    """'fhus': a distant lowest-rank merge creates a pair that beats an
    existing local minimum; 'aaaa' / 'aaa': overlapping runs."""
    for merges, text, want in ((FHUS, b"fhus", [102, 257]),
                               (np.array([[97, 97]], np.int32), b"aaaa",
                                [256, 256]),
                               (np.array([[97, 97]], np.int32), b"aaa",
                                [256, 97])):
        v = 256 + len(merges)
        for table in (P.build_rank_table(merges, v, "cpu"),
                      P.build_merge_table(merges, "cpu")):
            flat = torch.frombuffer(bytearray(text), dtype=torch.uint8)
            lens = torch.tensor([len(text)], dtype=torch.int32)
            ids, counts = P.encode_core(flat, lens, table, v=v)
            assert P.ids_to_numpy(ids).tolist() == want
            st = P._flat_plain_counts(flat, lens, table, v)
            assert P.ids_to_numpy(st[0]).tolist() == want


def test_encode_core_rejects_bad_input():
    merges = random_merges(1, 40)
    v = 296
    table = P.build_rank_table(merges, v, "cpu")
    flat = torch.zeros(10, dtype=torch.uint8)
    lens = torch.tensor([4, 6], dtype=torch.int32)
    with pytest.raises(TypeError):
        P.encode_core(flat.int(), lens, table, v=v)
    with pytest.raises(TypeError):
        P.encode_core(flat, lens.long(), table, v=v)
    with pytest.raises(ValueError, match="dense table"):
        P.encode_core(flat, lens, table[:-1], v=v)
    with pytest.raises(ValueError, match="reach"):
        P.encode_core(flat, lens, P.build_merge_table(merges, "cpu"), v=290)
    with pytest.raises(ValueError, match="contiguous"):
        P.encode_core(torch.zeros(20, dtype=torch.uint8)[::2], lens, table,
                      v=v)
    with pytest.raises(ValueError, match="sum to at most"):
        P.encode_core(flat, lens + 1, table, v=v)
    with pytest.raises(ValueError, match=">= 0"):
        P.encode_core(flat, torch.tensor([-1, 6], dtype=torch.int32),
                      table, v=v)
    ids, counts = P.encode_core(flat, lens[:0], table, v=v)
    assert ids.shape == counts.shape == (0,)
    assert P.out_dtype(65536) == torch.int16
    assert P.out_dtype(65537) == torch.int32
    big = torch.tensor([0, 255, 32767, 32768, 65535], dtype=torch.int32)
    np.testing.assert_array_equal(P.ids_to_numpy(P._to_out(big, 65536)),
                                  big.numpy())


# ---------------------------------------------------------------------
# stream windows (JAX: tests/test_advice_r3.py
# test_encode_stream_windows_large_streams)
# ---------------------------------------------------------------------

WINDOW = 4096        # STREAM_WINDOW_BYTES patched small on both packages


def _windowed(monkeypatch, window=WINDOW):
    monkeypatch.setattr(J, "STREAM_WINDOW_BYTES", window)
    monkeypatch.setattr(P, "STREAM_WINDOW_BYTES", window)


def _spy_calls(monkeypatch) -> list:
    """The (bytes, chunks) of every device call the port makes."""
    calls = []
    orig = P._encode_contiguous

    def spy(flat, lens, *args, **kw):
        calls.append((len(flat), len(lens)))
        return orig(flat, lens, *args, **kw)

    monkeypatch.setattr(P, "_encode_contiguous", spy)
    return calls


@pytest.mark.parametrize("v", [768, 5000])
def test_encode_stream_windows_match_jax(v, monkeypatch):
    """The JAX test's stream (4,000 words of 1-11 bytes, groups that span
    windows) with windows of 4 KB on both packages: the port's windowed
    encode_stream == its one call == the JAX package's windowed one, and
    each call holds at most 4 KB, cut at a chunk boundary."""
    rng = np.random.default_rng(8 + v)
    words = [bytes(rng.integers(97, 110, int(rng.integers(1, 12))).tolist())
             for _ in range(4000)]
    flat = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int64)
    merges = random_merges(v, v - 256, alpha=13)
    gbn = np.array([0, 7, 1500, 1501, 1501, 4000], np.int64)
    whole = P.encode_stream(flat, lens, merges, v, gbn, device="cpu")
    _windowed(monkeypatch)
    calls = _spy_calls(monkeypatch)
    got = P.encode_stream(flat, lens, merges, v, gbn, device="cpu")
    want = J.encode_stream(flat, lens, merges, v, gbn)
    assert len(got) == len(whole) == len(want) == 5 and len(got[3]) == 0
    for g, o, w in zip(got, whole, want):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, w)
    assert len(calls) == -(-len(flat) // WINDOW) >= 6
    assert all(b <= WINDOW for b, _ in calls)
    assert sum(b for b, _ in calls) == len(flat)
    assert sum(c for _, c in calls) == len(lens)
    bounds = P.stream_windows(lens)
    ends = np.concatenate([[0], np.cumsum(lens)])
    assert (ends[bounds[1:-1]] - ends[bounds[:-2]] <= WINDOW).all()
    # each window ends at the last chunk boundary that fits
    assert (ends[bounds[1:-1] + 1] - ends[bounds[:-2]] > WINDOW).all()


def test_chunk_longer_than_a_window_matches_jax(monkeypatch):
    """A chunk over the window takes a window of its own; the ids match
    one call and the JAX package's encode_chunks (any length), also
    through the port's encode_chunks, which takes the same windows."""
    merges = random_merges(21, 400, alpha=4)
    flat, lens = random_chunks(22, 600, alpha=4)
    starts = np.cumsum(lens) - lens
    parts = [flat[s:s + n] for s, n in zip(starts, lens)]
    rng = np.random.RandomState(23)
    for at, n in ((600, 4097), (300, 9000), (0, 5000)):
        parts.insert(at, (97 + rng.randint(0, 4, n)).astype(np.uint8))
    lens = np.array([len(p) for p in parts], np.int64)
    flat = np.concatenate(parts)
    chunks = [p.tobytes() for p in parts]
    v = 656
    gbn = np.array([0, 1, 300, 302, len(lens)], np.int64)
    whole = P.encode_stream(flat, lens, merges, v, gbn, device="cpu")
    want, want_cid = J.encode_chunks(chunks, J.build_merge_table(merges),
                                     return_chunk_ids=True)
    _windowed(monkeypatch)
    calls = _spy_calls(monkeypatch)
    got = P.encode_stream(flat, lens, merges, v, gbn, device="cpu")
    for g, o in zip(got, whole):
        np.testing.assert_array_equal(g, o)
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert (5000, 1) in calls and (9000, 1) in calls and (4097, 1) in calls
    assert len(calls) >= 6
    del calls[:]
    ids, cid = P.encode_chunks(chunks, P.build_merge_table(merges, "cpu"),
                               return_chunk_ids=True)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(cid, want_cid)
    assert len(calls) >= 6


@pytest.mark.parametrize("pattern", ["", "gpt"])
def test_tokenizer_windows_match_jax(pattern, monkeypatch):
    """Tokenizer.encode_array and encode_batch_arrays with 4 KB windows:
    the port (whitespace chunks, and the GPT pre-split through
    encode_stream) == its unwindowed ids == the JAX package's tpu
    backend, windowed the same; documents span windows."""
    merges = random_merges(31, 700, alpha=26)
    rng = np.random.RandomState(32)
    words = ["".join(chr(97 + c) for c in rng.randint(0, 26, k))
             for k in rng.randint(1, 10, 6000)]
    text = " ".join(words[:3000]) + "\n" + "  ".join(words[3000:]) + "\n"
    docs = [text[i:i + 3000] for i in range(0, len(text), 3000)]
    tok = Tokenizer(merges, pattern=pattern, device="cpu")
    whole = tok.encode_array(text)
    whole_b = tok.encode_batch_arrays(docs)
    _windowed(monkeypatch)
    calls = _spy_calls(monkeypatch)
    jt = JaxTokenizer(merges=merges, pattern=pattern, backend="tpu")
    got = tok.encode_array(text)
    n_calls = len(calls)
    assert n_calls >= -(-len(text) // WINDOW) >= 10
    np.testing.assert_array_equal(got, whole)
    np.testing.assert_array_equal(got, jt.encode(text))
    batch = tok.encode_batch_arrays(docs)
    assert len(calls) - n_calls >= 10
    want = jt.encode_batch(docs)
    for g, o, w in zip(batch, whole_b, want):
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(batch), got)


def test_encode_core_refuses_c_int_overflow(monkeypatch):
    """W and n reach csrc/encode.cu as C ints, which ctypes wraps without
    a word: encode_core raises from C_INT_LIMIT (patched to 8 here) on,
    on the CPU too, before the plain versions run."""
    monkeypatch.setattr(P, "C_INT_LIMIT", 8)
    merges = random_merges(1, 40)
    table = P.build_rank_table(merges, 296, "cpu")
    with pytest.raises(ValueError, match="fewer than 8"):
        P.encode_core(torch.zeros(8, dtype=torch.uint8),
                      torch.ones(4, dtype=torch.int32), table, v=296)
    with pytest.raises(ValueError, match="W 8"):
        P.encode_core(torch.zeros(7, dtype=torch.uint8),
                      torch.zeros(8, dtype=torch.int32), table, v=296)
    ids, counts = P.encode_core(torch.full((7,), 97, dtype=torch.uint8),
                                torch.tensor([3, 4], dtype=torch.int32),
                                table, v=296)
    assert counts.sum() == len(ids) > 0
    # the windows keep each call below the limit
    monkeypatch.setattr(P, "STREAM_WINDOW_BYTES", 7)
    flat = np.full(40, 97, np.uint8)
    got = P.encode_stream(flat, np.full(20, 2, np.int64), merges, 296,
                          device="cpu")[0]
    monkeypatch.setattr(P, "C_INT_LIMIT", 2 ** 31)
    monkeypatch.setattr(P, "STREAM_WINDOW_BYTES", 2 ** 28)
    np.testing.assert_array_equal(got, P.encode_stream(
        flat, np.full(20, 2, np.int64), merges, 296, device="cpu")[0])


@pytest.mark.parametrize("window,scan", [(1, 1), (7, 3), (64, 5),
                                         (300, 1 << 16)])
def test_ws_windows_are_stream_windows(window, scan, monkeypatch):
    """encode_ws_text's byte windows (each cut found by a search for a
    word / whitespace transition in steps of WS_SCAN_BYTES, without the
    chunk lengths) are stream_windows' over ws_chunk_lens, on seeded
    texts with whitespace runs and chunks longer than the window; its
    ids equal one call's."""
    monkeypatch.setattr(P, "STREAM_WINDOW_BYTES", window)
    monkeypatch.setattr(P, "WS_SCAN_BYTES", scan)
    rng = np.random.default_rng(window)
    alphabet = np.frombuffer(b"ab \n\t\r", np.uint8)
    for _ in range(150):
        flat = rng.choice(alphabet, int(rng.integers(0, 700)),
                          p=rng.dirichlet(np.ones(6))).astype(np.uint8)
        if len(flat) > 200:
            at = int(rng.integers(0, 100))
            flat[at:at + int(rng.integers(1, 3 * window + 2))] = 97
        ends = np.concatenate([[0], np.cumsum(P.ws_chunk_lens(flat))])
        want = ends[P.stream_windows(P.ws_chunk_lens(flat))].tolist()
        assert P.ws_windows(flat) == want
    merges = random_merges(41, 300, alpha=4)
    text = np.frombuffer(b"abba  ab\n\tbbbbbbbbbbbbbbbbab a " * 40, np.uint8)
    got = P.encode_ws_text(text, merges, 556, device="cpu")
    monkeypatch.setattr(P, "STREAM_WINDOW_BYTES", len(text))
    np.testing.assert_array_equal(
        got, P.encode_ws_text(text, merges, 556, device="cpu"))
