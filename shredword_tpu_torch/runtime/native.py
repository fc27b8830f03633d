"""ctypes bindings of the port's native host runtime.

The part of the JAX package's ``shredword_tpu/runtime/native.py`` that
the port's trainer and tokenizer call: corpus loading and dedup
(``NativeCorpus``, ``CorpusArrays``), the reference-faithful CPU trainer
(``FaithfulTrainer``), the CPU encoder and merge replay
(``NativeEncoder``), the encoder's host helpers (``normalize``,
``dedup_spans``, ``ws_chunk_dedup``, ``expand_ids``, ``expand_bytes``,
``gpt_starts_bytes``), and the Unigram trainer's and tokenizer's
(``SeedVocab``, ``piece_table``, ``marker_word_dedup``).  Handles are opaque ``c_void_p``; arrays cross the
boundary as numpy buffers with explicit sizes.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from . import build as _build


class ShredConfigC(ctypes.Structure):
    _fields_ = [
        ("target_vocab_size", ctypes.c_int64),
        ("unk_id", ctypes.c_int32),
        ("character_coverage", ctypes.c_double),
        ("min_pair_freq", ctypes.c_uint64),
    ]


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        L = ctypes.CDLL(_build.build())
        _declare(L)
        _lib = L
    return _lib


def _declare(L: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i64 = ctypes.c_int64
    i32 = ctypes.c_int
    L.shred_corpus_from_bytes.argtypes = [ctypes.c_char_p, i64, i32, i32]
    L.shred_corpus_from_bytes.restype = p
    L.shred_corpus_from_file.argtypes = [ctypes.c_char_p, i32, i32]
    L.shred_corpus_from_file.restype = p
    for fn in ("shred_corpus_num_words", "shred_corpus_unique_bytes",
               "shred_corpus_total_raw_bytes",
               "shred_corpus_total_occurrences"):
        getattr(L, fn).argtypes = [p]
        getattr(L, fn).restype = i64
    L.shred_corpus_export.argtypes = [p, p, p, p]
    L.shred_corpus_export.restype = None
    L.shred_corpus_coverage.argtypes = [p, ctypes.c_double, p,
                                        ctypes.POINTER(i32)]
    L.shred_corpus_coverage.restype = i32
    L.shred_corpus_free.argtypes = [p]
    L.shred_corpus_free.restype = None

    L.shred_trainer_create.argtypes = [ctypes.POINTER(ShredConfigC)]
    L.shred_trainer_create.restype = p
    L.shred_trainer_load.argtypes = [p, p]
    L.shred_trainer_load.restype = None
    L.shred_trainer_train.argtypes = [p, i32]
    L.shred_trainer_train.restype = i32
    L.shred_trainer_num_merges.argtypes = [p]
    L.shred_trainer_num_merges.restype = i64
    L.shred_trainer_get_merges.argtypes = [p, p]
    L.shred_trainer_get_merges.restype = None
    L.shred_trainer_get_merge_freqs.argtypes = [p, p]
    L.shred_trainer_get_merge_freqs.restype = None
    L.shred_trainer_token_count.argtypes = [p]
    L.shred_trainer_token_count.restype = i64
    L.shred_trainer_export_tokens.argtypes = [p, p, p]
    L.shred_trainer_export_tokens.restype = None
    L.shred_trainer_save.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p]
    L.shred_trainer_save.restype = i32
    L.shred_trainer_token_freqs.argtypes = [p, p, i64]
    L.shred_trainer_token_freqs.restype = None
    L.shred_trainer_kept_chars.argtypes = [p]
    L.shred_trainer_kept_chars.restype = i32
    L.shred_trainer_unique_chars.argtypes = [p]
    L.shred_trainer_unique_chars.restype = i32
    L.shred_trainer_free.argtypes = [p]
    L.shred_trainer_free.restype = None

    L.shred_encoder_create.argtypes = [p, i64]
    L.shred_encoder_create.restype = p
    L.shred_encoder_free.argtypes = [p]
    L.shred_encoder_free.restype = None
    L.shred_apply_merges.argtypes = [p, p, p, i64, p, i64, p]
    L.shred_apply_merges.restype = i64
    L.shred_encode_words.argtypes = [p, p, p, i64, i32, p, i64]
    L.shred_encode_words.restype = i64
    L.shred_encode_text.argtypes = [p, ctypes.c_char_p, i64, i32, p, i64,
                                    i32]
    L.shred_encode_text.restype = i64

    L.shred_normalize.argtypes = [ctypes.c_char_p, i64, p, i64]
    L.shred_normalize.restype = i64
    L.shred_gpt_starts.argtypes = [ctypes.c_char_p, i64, p, p, i64]
    L.shred_gpt_starts.restype = i64
    L.shred_dedup_spans.argtypes = [p, p, p, i64, p, p]
    L.shred_dedup_spans.restype = i64
    L.shred_ws_chunk_dedup.argtypes = [p, i64, p, p, p, ctypes.POINTER(i64)]
    L.shred_ws_chunk_dedup.restype = i64
    L.shred_expand_ids.argtypes = [p, p, p, i64, p]
    L.shred_expand_ids.restype = i64
    L.shred_expand_bytes.argtypes = [p, p, p, i64, p]
    L.shred_expand_bytes.restype = i64
    L.shred_marker_word_dedup.argtypes = [p, i64, p, p, p,
                                          ctypes.POINTER(i64)]
    L.shred_marker_word_dedup.restype = i64

    L.shred_seed_vocab_create.argtypes = []
    L.shred_seed_vocab_create.restype = p
    L.shred_seed_vocab_free.argtypes = [p]
    L.shred_seed_vocab_free.restype = None
    L.shred_seed_vocab_add_ex.argtypes = [p, ctypes.c_char_p, i64, i64,
                                          ctypes.c_uint64, i32]
    L.shred_seed_vocab_add_ex.restype = i32
    L.shred_seed_vocab_size.argtypes = [p]
    L.shred_seed_vocab_size.restype = i64
    L.shred_seed_vocab_export_bytes.argtypes = [p, i64]
    L.shred_seed_vocab_export_bytes.restype = i64
    L.shred_seed_vocab_export.argtypes = [p, i64, p, p, p]
    L.shred_seed_vocab_export.restype = i64
    L.shred_piece_table.argtypes = [ctypes.c_char_p, p, i64,
                                    ctypes.c_char_p, p, i64, i64, i64, p]
    L.shred_piece_table.restype = i64


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@dataclass
class CorpusArrays:
    """Unique words as flat arrays, the hand-off format for the device
    engines."""

    word_bytes: np.ndarray   # uint8 [unique_bytes], words concatenated
    offsets: np.ndarray      # int64 [n_words + 1]
    counts: np.ndarray       # uint64 [n_words]
    total_raw_bytes: int
    total_occurrences: int

    @property
    def n_words(self) -> int:
        return len(self.counts)

    def word(self, i: int) -> bytes:
        return self.word_bytes[self.offsets[i]:self.offsets[i + 1]].tobytes()


class NativeCorpus:
    """Owning wrapper over a native corpus handle."""

    def __init__(self, handle):
        if not handle:
            raise IOError("corpus load failed")
        self._h = handle

    @classmethod
    def from_bytes(cls, data: bytes,
                   faithful_order: bool = False) -> "NativeCorpus":
        # nthreads 0: the runtime picks the dedup thread count
        return cls(lib().shred_corpus_from_bytes(data, len(data),
                                                 int(faithful_order), 0))

    @classmethod
    def from_file(cls, path: str,
                  faithful_order: bool = False) -> "NativeCorpus":
        """Load and dedup a corpus file (files over 2 GiB stream in
        bounded-memory blocks inside the runtime)."""
        h = lib().shred_corpus_from_file(path.encode(), int(faithful_order),
                                         0)
        if not h:
            raise IOError(f"Failed to load corpus from {path}")
        return cls(h)

    def arrays(self) -> CorpusArrays:
        L = lib()
        n = L.shred_corpus_num_words(self._h)
        nbytes = L.shred_corpus_unique_bytes(self._h)
        word_bytes = np.empty(nbytes, dtype=np.uint8)
        offsets = np.empty(n + 1, dtype=np.int64)
        counts = np.empty(n, dtype=np.uint64)
        L.shred_corpus_export(self._h, _ptr(word_bytes), _ptr(offsets),
                              _ptr(counts))
        return CorpusArrays(
            word_bytes=word_bytes, offsets=offsets, counts=counts,
            total_raw_bytes=L.shred_corpus_total_raw_bytes(self._h),
            total_occurrences=L.shred_corpus_total_occurrences(self._h),
        )

    def coverage(self, coverage: float) -> tuple[np.ndarray, int, int]:
        """(keep_mask bool[256], n_kept, n_unique) under reference
        coverage semantics (docs/CONFORMANCE.md §1.2)."""
        keep = np.zeros(256, dtype=np.uint8)
        n_unique = ctypes.c_int(0)
        n_kept = lib().shred_corpus_coverage(self._h, coverage, _ptr(keep),
                                             ctypes.byref(n_unique))
        return keep.astype(bool), n_kept, n_unique.value

    def free(self) -> None:
        if self._h:
            lib().shred_corpus_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


class FaithfulTrainer:
    """Reference-faithful CPU trainer (conformance oracle)."""

    def __init__(self, target_vocab_size=8192, unk_id=-1,
                 character_coverage=0.995, min_pair_freq=2000):
        cfg = ShredConfigC(target_vocab_size=target_vocab_size, unk_id=unk_id,
                           character_coverage=character_coverage,
                           min_pair_freq=min_pair_freq)
        self._h = lib().shred_trainer_create(ctypes.byref(cfg))
        if not self._h:
            raise RuntimeError("Failed to create faithful trainer")

    def load(self, corpus: NativeCorpus) -> None:
        lib().shred_trainer_load(self._h, corpus._h)

    def train(self, max_merges: int = -1) -> int:
        return lib().shred_trainer_train(self._h, max_merges)

    @property
    def num_merges(self) -> int:
        return lib().shred_trainer_num_merges(self._h)

    def merges(self) -> np.ndarray:
        out = np.empty((self.num_merges, 2), dtype=np.int32)
        lib().shred_trainer_get_merges(self._h, _ptr(out))
        return out

    def merge_freqs(self) -> np.ndarray:
        out = np.empty(self.num_merges, dtype=np.uint64)
        lib().shred_trainer_get_merge_freqs(self._h, _ptr(out))
        return out

    def save(self, model_path: str, vocab_path: str) -> None:
        """The reference's ``.model`` and ``.vocab`` files."""
        rc = lib().shred_trainer_save(self._h, model_path.encode(),
                                      vocab_path.encode())
        if rc != 0:
            raise IOError("save failed")

    def tokens(self) -> tuple[np.ndarray, np.ndarray]:
        n = lib().shred_trainer_token_count(self._h)
        toks = np.empty(n, dtype=np.int32)
        wids = np.empty(n, dtype=np.int32)
        lib().shred_trainer_export_tokens(self._h, _ptr(toks), _ptr(wids))
        return toks, wids

    def token_freqs(self) -> np.ndarray:
        """The frequency of every token id (the 256 bytes, then the
        merges) in the trained corpus, uint64."""
        n = 256 + self.num_merges
        out = np.zeros(n, dtype=np.uint64)
        lib().shred_trainer_token_freqs(self._h, _ptr(out), n)
        return out

    @property
    def kept_chars(self) -> int:
        return lib().shred_trainer_kept_chars(self._h)

    @property
    def unique_chars(self) -> int:
        return lib().shred_trainer_unique_chars(self._h)

    def free(self) -> None:
        if self._h:
            lib().shred_trainer_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


class NativeEncoder:
    """CPU encoder over a merge table: the tokenizer's ``cpu`` backend,
    and merge replay (checkpoint resume and the sharded engine's final
    corpus)."""

    def __init__(self, merges: np.ndarray):
        merges = np.ascontiguousarray(merges, dtype=np.int32)
        if merges.ndim != 2 or merges.shape[1] != 2:
            raise ValueError(f"merges must be [M, 2], got {merges.shape}")
        self._h = lib().shred_encoder_create(_ptr(merges), len(merges))

    def encode_words(self, word_bytes: np.ndarray, offsets: np.ndarray,
                     cache: bool = True) -> np.ndarray:
        """int32 ids of the words word_bytes[offsets[i]:offsets[i + 1]],
        concatenated (memoized per distinct word when ``cache``)."""
        word_bytes = np.ascontiguousarray(word_bytes, dtype=np.uint8)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n_words = len(offsets) - 1
        cap = max(int(offsets[-1]), 16)
        out = np.empty(cap, dtype=np.int32)
        n = lib().shred_encode_words(self._h, _ptr(word_bytes),
                                     _ptr(offsets), n_words, int(cache),
                                     _ptr(out), cap)
        if n < 0:
            out = np.empty(-n, dtype=np.int32)
            n = lib().shred_encode_words(self._h, _ptr(word_bytes),
                                         _ptr(offsets), n_words, int(cache),
                                         _ptr(out), -n)
        return out[:n].copy()

    def encode_text(self, data: bytes, cache: bool = True,
                    nthreads: int = 0) -> np.ndarray:
        """Whole-text encode: native lossless whitespace chunking and
        memoized word encode in one pass.  Large inputs fan out over
        worker threads split at whitespace-run boundaries, bit-identical
        to one thread; nthreads <= 0 picks the count."""
        cap = max(len(data), 16)
        out = np.empty(cap, dtype=np.int32)
        n = lib().shred_encode_text(self._h, data, len(data), int(cache),
                                    _ptr(out), cap, nthreads)
        if n < 0:
            out = np.empty(-n, dtype=np.int32)
            n = lib().shred_encode_text(self._h, data, len(data),
                                        int(cache), _ptr(out), -n, nthreads)
        return out[:n].copy()

    def apply_merges(self, tokens: np.ndarray, offsets: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Apply the merge table to int32 token words.  Returns (merged
        flat tokens, output offsets)."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n_words = len(offsets) - 1
        out_off = np.empty(n_words + 1, dtype=np.int64)
        cap = max(len(tokens), 16)
        out = np.empty(cap, dtype=np.int32)
        n = lib().shred_apply_merges(self._h, _ptr(tokens), _ptr(offsets),
                                     n_words, _ptr(out), cap, _ptr(out_off))
        if n < 0:
            out = np.empty(-n, dtype=np.int32)
            n = lib().shred_apply_merges(self._h, _ptr(tokens),
                                         _ptr(offsets), n_words, _ptr(out),
                                         -n, _ptr(out_off))
        return out[:n].copy(), out_off

    def free(self) -> None:
        if self._h:
            lib().shred_encoder_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def normalize(data: bytes) -> bytes:
    """SentencePiece-style normalization with the reference's exact
    line semantics (normalize.cpp:24-59): ASCII lowercase, whitespace
    runs -> U+2581, leading run dropped, trailing marker stripped."""
    cap = len(data) * 3 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib().shred_normalize(data, len(data), _ptr(out), cap)
    if n < 0:
        out = np.empty(-n, dtype=np.uint8)
        n = lib().shred_normalize(data, len(data), _ptr(out), -n)
    return out[:n].tobytes()


def dedup_spans(flat: np.ndarray, off: np.ndarray,
                lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Deduplicate byte spans (csrc/dedup.cpp).  Returns (inverse
    int32[n], the dense unique id of each span in first-occurrence
    order; uniq int64[u], the span index of each unique's first
    occurrence)."""
    n = len(lens)
    flat = np.ascontiguousarray(flat, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    inverse = np.empty(n, np.int32)
    uniq = np.empty(n, np.int64)
    u = lib().shred_dedup_spans(_ptr(flat), _ptr(off), _ptr(lens), n,
                                _ptr(inverse), _ptr(uniq))
    return inverse, uniq[:u].copy()


def ws_chunk_dedup(data) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whitespace-keep chunking and dedup of a raw byte stream in one
    pass (csrc/dedup.cpp).  Returns (inverse int32[n_chunks], the dense
    unique id of each chunk in stream order; uniq_off int64[u] and
    uniq_len int32[u], each unique chunk's byte span in ``data``)."""
    arr = np.ascontiguousarray(np.frombuffer(data, np.uint8)
                               if isinstance(data, (bytes, bytearray))
                               else data, np.uint8)
    n = len(arr)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    inverse = np.empty(n, np.int32)
    uniq_off = np.empty(n, np.int64)
    uniq_len = np.empty(n, np.int32)
    n_chunks = ctypes.c_int64(0)
    u = lib().shred_ws_chunk_dedup(_ptr(arr), n, _ptr(inverse),
                                   _ptr(uniq_off), _ptr(uniq_len),
                                   ctypes.byref(n_chunks))
    if u < 0:
        raise ValueError("a single delimiter-free run exceeds 2 GiB "
                         "(int32 chunk-length limit)")
    return (inverse[:n_chunks.value].copy(), uniq_off[:u].copy(),
            uniq_len[:u].copy())


def expand_ids(ids_u: np.ndarray, uoff: np.ndarray,
               inverse: np.ndarray, total: int) -> np.ndarray:
    """Expand per-unique-chunk id runs to the full stream (a memcpy
    loop, csrc/dedup.cpp): the concatenation of ids_u[uoff[u]:uoff[u+1]]
    for u in inverse; ``total`` is the sum of those run lengths."""
    ids_u = np.ascontiguousarray(ids_u, np.int32)
    uoff = np.ascontiguousarray(uoff, np.int64)
    inverse = np.ascontiguousarray(inverse, np.int32)
    out = np.empty(total, np.int32)
    written = lib().shred_expand_ids(_ptr(ids_u), _ptr(uoff),
                                     _ptr(inverse), len(inverse), _ptr(out))
    if written != total:
        raise ValueError(f"expand_ids wrote {written} ids, expected {total}")
    return out


def expand_bytes(flat: np.ndarray, off: np.ndarray, ids: np.ndarray,
                 total: int) -> bytes:
    """Piece-table byte expansion (decode's memcpy loop): the
    concatenation of flat[off[i]:off[i+1]] for i in ids, which must be
    in range and known."""
    flat = np.ascontiguousarray(flat, np.uint8)
    off = np.ascontiguousarray(off, np.int64)
    ids = np.ascontiguousarray(ids, np.int32)
    out = np.empty(total, np.uint8)
    written = lib().shred_expand_bytes(_ptr(flat), _ptr(off), _ptr(ids),
                                       len(ids), _ptr(out))
    if written != total:
        raise ValueError(f"expand_bytes wrote {written} bytes, expected "
                         f"{total}")
    return out.tobytes()


def gpt_starts_bytes(data: bytes, cls_table: np.ndarray) -> np.ndarray:
    """Chunk-start byte offsets of the GPT pre-split pattern (the native
    single-pass scanner, csrc/pretok.cpp; classes from
    ``ops.pretok_ops.class_table``)."""
    if not data:
        return np.zeros(0, np.int64)
    cap = len(data) + 1
    out = np.empty(cap, np.int64)
    table = np.ascontiguousarray(cls_table, np.int8)
    n = lib().shred_gpt_starts(data, len(data), _ptr(table), _ptr(out), cap)
    return out[:n].copy()


def marker_word_dedup(data) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Marker-word splitting and dedup of NORMALIZED bytes in one pass
    (csrc/dedup.cpp): words are runs delimited by '\\n' or the 3-byte
    U+2581 marker.  Returns (inverse int32[n_words], the dense unique id
    of each word in stream order; uniq_off int64[u] and uniq_len
    int32[u], each unique word's raw span, marker prefix not
    included)."""
    arr = np.ascontiguousarray(np.frombuffer(data, np.uint8)
                               if isinstance(data, (bytes, bytearray))
                               else data, np.uint8)
    n = len(arr)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    cap = n // 2 + 1
    inverse = np.empty(cap, np.int32)
    uniq_off = np.empty(cap, np.int64)
    uniq_len = np.empty(cap, np.int32)
    n_words = ctypes.c_int64(0)
    u = lib().shred_marker_word_dedup(_ptr(arr), n, _ptr(inverse),
                                      _ptr(uniq_off), _ptr(uniq_len),
                                      ctypes.byref(n_words))
    if u < 0:
        raise ValueError("a single delimiter-free word exceeds 2 GiB "
                         "(int32 word-length limit)")
    return (inverse[:n_words.value].copy(), uniq_off[:u].copy(),
            uniq_len[:u].copy())


class SeedVocab:
    """Substring counter seeding the Unigram trainer (the reference's
    add_subwords/VocabTable semantics, normalize.cpp:171-237)."""

    def __init__(self):
        self._h = lib().shred_seed_vocab_create()

    def add(self, line: bytes, max_len: int = 15, weight: int = 1,
            skip_markers: bool = True) -> None:
        """skip_markers=True is the reference's add_subwords; False also
        counts marker-prefixed substrings (the trainer's word-boundary
        pieces)."""
        rc = lib().shred_seed_vocab_add_ex(self._h, line, len(line),
                                           max_len, weight,
                                           int(skip_markers))
        if rc != 0:
            raise RuntimeError("seed vocab add failed")

    def __len__(self) -> int:
        return int(lib().shred_seed_vocab_size(self._h))

    def export(self, top_k: int) -> tuple[list[bytes], np.ndarray]:
        """The top_k pieces by count (descending, lexicographic
        tie-break) and their counts."""
        nbytes = int(lib().shred_seed_vocab_export_bytes(self._h, top_k))
        blob = np.empty(max(nbytes, 1), dtype=np.uint8)
        lens = np.empty(max(top_k, 1), dtype=np.int32)
        counts = np.empty(max(top_k, 1), dtype=np.uint64)
        n = int(lib().shred_seed_vocab_export(self._h, top_k, _ptr(blob),
                                              _ptr(lens), _ptr(counts)))
        ends = np.cumsum(lens[:n], dtype=np.int64)
        raw = blob.tobytes()
        pieces = [raw[e - ln:e] for e, ln in zip(ends.tolist(),
                                                 lens[:n].tolist())]
        return pieces, counts[:n].astype(np.int64)

    def free(self) -> None:
        if self._h:
            lib().shred_seed_vocab_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def piece_table(words: list[bytes], pieces: list[bytes], lmax: int,
                max_piece_len: int) -> np.ndarray:
    """int32 [n_words, lmax, max_piece_len] piece ids: entry (w, j, l - 1)
    is the index in ``pieces`` of words[w][j:j + l], or -1 when no piece
    equals it or it runs past the word's end (csrc/unigram.cpp).  The
    host-side precompute of the Unigram lattice kernels."""
    blob = b"".join(words)
    offsets = np.zeros(len(words) + 1, dtype=np.int64)
    np.cumsum([len(w) for w in words], out=offsets[1:])
    pblob = b"".join(pieces)
    plens = np.asarray([len(p) for p in pieces], dtype=np.int32)
    out = np.empty((len(words), lmax, max_piece_len), dtype=np.int32)
    lib().shred_piece_table(blob, _ptr(offsets), len(words), pblob,
                            _ptr(plens), len(pieces), lmax, max_piece_len,
                            _ptr(out))
    return out
