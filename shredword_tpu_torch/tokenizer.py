"""Tokenizer — encode/decode/save/load over a trained BPE model (the
port of the JAX package's ``shredword_tpu.tokenizer``, same API and
same ids).

State = {merges, pattern, special_tokens, vocab} (base.py:98-104);
encode = lowest-rank-first merge substitution with left-to-right overlap
consumption (base.py:22-36); both reference model formats are read and
written (binary triples bpe.cpp:722-731; "shredword v1" text
base.py:111-149).

Backends:
  - "cuda" (the default): the device encoder (``ops/encode_ops.py``) on
    ``device``, whose merge loop is ``csrc/encode.cu`` on a CUDA device
    (a lane group per chunk) and its plain PyTorch version on the CPU
    (``device="cpu"``)
  - "cpu": the native C++ rank-loop encoder with a word memo cache

Unlike the JAX package, whose ``Tokenizer`` and ``Tokenizer.load``
default to its CPU backend, the port defaults to ``backend="cuda"``,
``device="cuda"``: its entry points run on the card unless the caller
asks for the CPU, and a "cuda" backend without a CUDA device raises
``ConfigError``.  Decoding runs on the host in either backend.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from . import pretokenize, serialization
from .config import resolve_device
from .errors import ConfigError, DecodeError, EncodeError

_REPLACEMENT = "�"
BACKENDS = ("cuda", "cpu")


def replace_control_characters(s: str) -> str:
    """Escape control characters for vocab dumps (base.py:83-90)."""
    out = []
    for ch in s:
        if unicodedata.category(ch)[0] != "C":
            out.append(ch)
        else:
            out.append(f"\\u{ord(ch):04x}")
    return "".join(out)


def render_token(t: bytes) -> str:
    """Human-readable token rendering (base.py:92-96)."""
    return replace_control_characters(t.decode("utf-8", errors="replace"))


def get_stats(ids, counts=None):
    """Adjacent-pair counts over an id sequence (reference helper,
    base.py:10-20): dict (a, b) -> count, optionally accumulating into
    `counts`."""
    counts = {} if counts is None else counts
    for pair in zip(ids, ids[1:]):
        counts[pair] = counts.get(pair, 0) + 1
    return counts


def merge(ids, pair, idx):
    """Substitute every occurrence of `pair` with `idx`, consuming
    overlapping runs left-to-right (reference helper, base.py:22-36 —
    the semantics the trainers and encoder replicate)."""
    out = []
    i = 0
    while i < len(ids):
        if (i + 1 < len(ids) and ids[i] == pair[0]
                and ids[i + 1] == pair[1]):
            out.append(idx)
            i += 2
        else:
            out.append(ids[i])
            i += 1
    return out


def build_vocab(merges, special_tokens=None):
    """id -> bytes over the 256-byte base + merges + specials
    (reference helper, base.py:60-79).  Components outside the known id
    range (e.g. the faithful engine's unk-involving merges,
    docs/CONFORMANCE.md §3) contribute no bytes — mirroring the
    reference C++ bpe_save tolerance."""
    vocab = {i: bytes([i]) for i in range(256)}
    for m, (a, b) in enumerate(merges):
        vocab[256 + m] = vocab.get(int(a), b"") + vocab.get(int(b), b"")
    for tok, idx in (special_tokens or {}).items():
        vocab[idx] = tok.encode("utf-8")
    return vocab


class Tokenizer:
    def __init__(self, merges: np.ndarray | None = None, pattern: str = "",
                 special_tokens: dict[str, int] | None = None,
                 backend: str = "cuda", device="cuda"):
        self._merges = (np.zeros((0, 2), np.int32) if merges is None
                        else np.asarray(merges, np.int32).reshape(-1, 2))
        self._pattern = pattern
        self._special_tokens: dict[str, int] = dict(special_tokens or {})
        self._device = device
        self.backend = backend
        self._native = None
        self._table = None
        self._flat_vocab = None
        self._rebuild()

    @property
    def backend(self) -> str:
        return self._backend

    @backend.setter
    def backend(self, value: str) -> None:
        if value not in BACKENDS:
            raise ConfigError(f"unknown backend {value!r}; one of "
                              f"{BACKENDS}")
        if value == "cuda":
            resolve_device(self._device)
        self._backend = value

    @property
    def device(self):
        """The torch device of the "cuda" backend."""
        return resolve_device(self._device)

    # ------------------------------------------------------------------
    # mutable model state (reference README.md:66-71,90-99: "View or set
    # the merge rules / pattern / special_tokens") — assigning any of
    # these rebuilds the vocab and invalidates the encode/decode caches,
    # so set-then-encode never uses a stale model.
    # ------------------------------------------------------------------

    @property
    def merges(self) -> np.ndarray:
        return self._merges

    @merges.setter
    def merges(self, value) -> None:
        self._merges = (np.zeros((0, 2), np.int32) if value is None
                        else np.asarray(value, np.int32).reshape(-1, 2))
        self._rebuild()

    @property
    def pattern(self) -> str:
        return self._pattern

    @pattern.setter
    def pattern(self, value: str) -> None:
        self._pattern = value or ""

    @property
    def special_tokens(self) -> dict[str, int]:
        return self._special_tokens

    @special_tokens.setter
    def special_tokens(self, value) -> None:
        self._special_tokens = dict(value or {})
        self._rebuild()

    # ------------------------------------------------------------------
    # vocab
    # ------------------------------------------------------------------

    def _rebuild(self) -> None:
        # the constructor/load path must enforce the same id-collision
        # rule as register_special_tokens: a special id inside the
        # byte+merge range would silently clobber a real token
        limit = 256 + len(self.merges)
        for name, idx in self.special_tokens.items():
            if idx < limit:
                raise EncodeError(
                    f"special token {name!r} id {idx} collides with "
                    f"merge ids (< {limit})")
        self.vocab = build_vocab(self.merges, self.special_tokens)
        self._inverse_special = {v: k for k, v in self.special_tokens.items()}
        self._native = None
        self._table = None
        self._flat_vocab = None

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    def register_special_tokens(self, special: dict[str, int]) -> None:
        for name, idx in special.items():
            if idx < 256 + len(self.merges):
                raise EncodeError(
                    f"special token id {idx} collides with merge ids "
                    f"(< {256 + len(self.merges)})")
        self.special_tokens.update(special)
        self._rebuild()

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------

    def _chunks(self, text: str) -> list[bytes]:
        if self.pattern:
            return [c.encode("utf-8")
                    for c in pretokenize.regex_split(text, self.pattern)]
        return pretokenize.whitespace_keep_split(text.encode("utf-8"))

    def _native_encoder(self):
        from .runtime.native import NativeEncoder
        if self._native is None:
            self._native = NativeEncoder(self.merges)
        return self._native

    def _tables(self) -> dict:
        """The device encoder's rank tables, per vocab and device."""
        if self._table is None:
            self._table = {}
        return self._table

    def _encode_chunks_cpu(self, chunks: list[bytes]) -> np.ndarray:
        offsets = np.zeros(len(chunks) + 1, np.int64)
        np.cumsum([len(c) for c in chunks], out=offsets[1:])
        word_bytes = np.frombuffer(b"".join(chunks), np.uint8)
        return self._native_encoder().encode_words(word_bytes, offsets)

    def _encode_groups_cuda(self, chunks: list[bytes],
                            bounds) -> list[np.ndarray]:
        """Device encode of chunk groups (one output array per group —
        e.g. one group per document), all groups in one encode_stream
        call (a device call per window)."""
        from .ops import encode_ops
        lens = np.fromiter((len(c) for c in chunks), np.int64, len(chunks))
        return encode_ops.encode_stream(
            np.frombuffer(b"".join(chunks), np.uint8), lens, self.merges,
            256 + len(self.merges), bounds, self._tables(), self.device)

    def _encode_text_cuda(self, data: bytes) -> np.ndarray:
        """Whole-text device encode: whitespace-keep chunk lengths in
        one numpy pass, then one device call over every chunk of each
        window (encode_ops.encode_ws_text)."""
        from .ops import encode_ops
        return encode_ops.encode_ws_text(
            np.frombuffer(data, np.uint8), self.merges,
            256 + len(self.merges), self._tables(), self.device)

    def encode_ordinary(self, text: str) -> list[int]:
        """Encode ignoring special tokens."""
        return self.encode_array(text).tolist()

    def encode_array(self, text: str) -> np.ndarray:
        """Encode ignoring special tokens; returns int32 numpy ids.

        The array form skips the list materialization (2.3M Python ints
        per 4 MB of text) — use it for bulk pipelines, and pass the
        array straight to decode/decode_bytes.
        """
        if not text:
            return np.zeros(0, np.int32)
        if not self.pattern and self.backend == "cpu":
            # whole-text native encode (the whitespace-keep chunking
            # runs inside the C++ pass — no per-chunk Python)
            return self._native_encoder().encode_text(text.encode("utf-8"))
        if not self.pattern:
            return self._encode_text_cuda(text.encode("utf-8"))
        if self.pattern in ("gpt", pretokenize.PATTERN_GPT):
            # byte-level path: the native GPT scanner gives chunk
            # offsets directly — no per-chunk Python strings
            data = text.encode("utf-8")
            try:
                starts = pretokenize.gpt_starts_bytes(data)
            except Exception:       # the exact regex path below
                starts = None
            if starts is not None:
                offsets = np.concatenate([starts, [len(data)]]).astype(
                    np.int64)
                if self.backend == "cpu":
                    return self._native_encoder().encode_words(
                        np.frombuffer(data, np.uint8), offsets)
                from .ops import encode_ops
                return encode_ops.encode_stream(
                    np.frombuffer(data, np.uint8), np.diff(offsets),
                    self.merges, 256 + len(self.merges), None,
                    self._tables(), self.device)[0]
        chunks = self._chunks(text)
        if not chunks:
            return np.zeros(0, np.int32)
        if self.backend == "cuda":
            return self._encode_groups_cuda(chunks, [0, len(chunks)])[0]
        return self._encode_chunks_cpu(chunks)

    def encode(self, text: str, allowed_special="none_raise") -> list[int]:
        """Encode with special-token handling.

        allowed_special: "all" | "none" | "none_raise" | set[str].
        "none_raise" (default) raises if a registered special token occurs
        in the text — the safe default for untrusted input.
        """
        if allowed_special == "all":
            allowed = set(self.special_tokens)
        elif allowed_special == "none":
            allowed = set()
        elif allowed_special == "none_raise":
            allowed = set()
            for s in self.special_tokens:
                if s in text:
                    raise EncodeError(
                        f"text contains special token {s!r}; pass "
                        f"allowed_special='all' or an explicit set")
        elif isinstance(allowed_special, (set, frozenset, list, tuple)):
            allowed = set(allowed_special)
        else:
            raise EncodeError(
                f"allowed_special must be 'all'|'none'|'none_raise'|set, "
                f"got {allowed_special!r}")
        if not allowed:
            return self.encode_ordinary(text)
        ids: list[int] = []
        for is_special, part in pretokenize.split_special(
                text, self.special_tokens, allowed):
            if is_special:
                ids.append(self.special_tokens[part])
            else:
                ids.extend(self.encode_ordinary(part))
        return ids

    def encode_batch(self, texts: list[str],
                     allowed_special="none_raise") -> list[list[int]]:
        """Encode many texts.  On the cuda backend all texts' chunks go
        to the device in one call and are split back by text
        afterwards."""
        if self.backend != "cuda" or self.special_tokens or not texts:
            return [self.encode(t, allowed_special) for t in texts]
        return [g.tolist()
                for g in self.encode_batch_arrays(texts, allowed_special)]

    def encode_batch_arrays(self, texts: list[str],
                            allowed_special="none_raise"
                            ) -> list[np.ndarray]:
        """encode_batch returning int32 numpy arrays — skips the
        per-id Python list materialization (2.3M PyLong boxes per 4 MB
        of text); use for bulk pipelines, ids feed decode directly."""
        if self.backend != "cuda" or self.special_tokens or not texts:
            return [np.asarray(self.encode(t, allowed_special), np.int32)
                    for t in texts]
        if not self.pattern:
            # vectorized whitespace chunking across the whole batch:
            # one numpy pass + one encode_stream call
            from .ops import encode_ops
            arrs = [np.frombuffer(t.encode("utf-8"), np.uint8)
                    for t in texts]
            lens_per = [encode_ops.ws_chunk_lens(a) for a in arrs]
            bounds = np.zeros(len(texts) + 1, np.int64)
            np.cumsum([len(x) for x in lens_per], out=bounds[1:])
            return encode_ops.encode_stream(
                np.concatenate(arrs), np.concatenate(lens_per), self.merges,
                256 + len(self.merges), bounds, self._tables(), self.device)
        chunks: list[bytes] = []
        n_chunks_per_text = []
        for t in texts:
            c = self._chunks(t) if t else []
            chunks.extend(c)
            n_chunks_per_text.append(len(c))
        if not chunks:
            return [np.zeros(0, np.int32) for _ in texts]
        bounds = np.zeros(len(texts) + 1, np.int64)
        np.cumsum(n_chunks_per_text, out=bounds[1:])
        return list(self._encode_groups_cuda(chunks, bounds))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode_table(self):
        """Flat vocab byte buffer + offsets for vectorized decode.  Slot
        vocab_size is the replacement token; ids outside the table map
        there."""
        if self._flat_vocab is None:
            n = max(self.vocab, default=-1) + 1
            pieces = [self.vocab.get(i, b"") for i in range(n)]
            pieces.append(_REPLACEMENT.encode("utf-8"))
            known = np.zeros(n + 1, bool)
            known[:n] = [i in self.vocab for i in range(n)]
            lens = np.fromiter((len(p) for p in pieces), np.int64, n + 1)
            off = np.zeros(n + 2, np.int64)
            np.cumsum(lens, out=off[1:])
            flat = np.frombuffer(b"".join(pieces), np.uint8)
            self._flat_vocab = (flat, off, lens, known, n)
        return self._flat_vocab

    def decode_bytes(self, ids, errors: str = "strict") -> bytes:
        """ids -> bytes, vectorized (one table gather, no per-id Python).

        errors: "strict" raises on unknown ids, "replace" substitutes
        U+FFFD, "ignore" drops them.
        """
        if isinstance(ids, list):
            ids = np.fromiter(ids, np.int64, len(ids))
        else:
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if len(ids) == 0:
            return b""
        flat, off, lens, known, n = self._decode_table()
        bad = (ids < 0) | (ids >= n)
        ok = ~bad
        ok[ok] = known[ids[ok]]
        bad = ~ok
        if bad.any():
            if errors == "strict":
                raise DecodeError(
                    f"invalid token id {int(ids[bad][0])}")
            if errors == "replace":
                ids = np.where(bad, n, ids)
            elif errors == "ignore":
                ids = ids[~bad]
            else:
                raise DecodeError(f"unknown errors mode {errors!r}")
        total = int(lens[ids].sum())
        if total == 0:
            return b""
        # the native memcpy expansion (csrc/dedup.cpp shred_expand_bytes):
        # piece i is flat[off[i]:off[i+1]]
        from .runtime import native
        return native.expand_bytes(flat, off, ids.astype(np.int32), total)

    def decode(self, ids, errors: str = "replace") -> str:
        """ids -> text.  Byte-level errors use utf-8 'replace' so any id
        sequence decodes; id-level errors follow `errors`."""
        return self.decode_bytes(ids, errors=errors).decode(
            "utf-8", errors="replace")

    # ------------------------------------------------------------------
    # train
    # ------------------------------------------------------------------

    @classmethod
    def train(cls, corpus_path: str, vocab_size: int = 8192,
              min_pair_freq: int = 2, character_coverage: float = 1.0,
              pattern: str = "", backend: str = "cuda", device="cuda",
              **trainer_kwargs) -> "Tokenizer":
        """Train from a corpus file and return a ready tokenizer on the
        same backend and device.

        Defaults differ from BPETrainer's reference-parity defaults:
        full coverage and min_pair_freq=2 (general-purpose tokenization
        rather than the reference's aggressive pruning, trainer.py:6).
        """
        from .models.bpe import BPETrainer
        t = BPETrainer(target_vocab_size=vocab_size, unk_id=-1,
                       character_coverage=character_coverage,
                       min_pair_freq=min_pair_freq, backend=backend,
                       device=device, **trainer_kwargs)
        try:
            t.load_corpus(corpus_path)
            t.train()
            return cls(merges=t.merges, pattern=pattern, backend=backend,
                       device=device)
        finally:
            t.destroy()

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    def save(self, model_path: str, vocab_path: str | None = None) -> None:
        """Write the model (format by extension: '.model' binary triples
        unless it ends in '.v1.model'/'.txt') + optional debug vocab."""
        if model_path.endswith((".v1.model", ".txt")) or self.pattern \
                or self.special_tokens:
            serialization.write_model_v1(model_path, self.merges,
                                         pattern=self.pattern,
                                         special_tokens=self.special_tokens)
        else:
            serialization.write_model_binary(model_path, self.merges)
        if vocab_path is not None:
            self._save_vocab_debug(vocab_path)

    def _save_vocab_debug(self, path: str) -> None:
        """Debug vocab dump (base.py:124-133 rendering; not loadable)."""
        inverted = {256 + m: (int(a), int(b))
                    for m, (a, b) in enumerate(self.merges)}
        with open(path, "w", encoding="utf-8") as f:
            for idx in sorted(self.vocab):
                s = render_token(self.vocab[idx])
                if idx in inverted:
                    a, b = inverted[idx]
                    f.write(f"[{render_token(self.vocab[a])}]"
                            f"[{render_token(self.vocab[b])}] -> "
                            f"[{s}] {idx}\n")
                else:
                    f.write(f"[{s}] {idx}\n")

    class _HybridLoad:
        """``Tokenizer.load(path)`` constructs a new tokenizer (this
        package's classmethod shape); ``tok.load(path)`` mutates ``tok``
        in place — the reference's instance-method shape
        (base.py:135-149), where loading replaces merges/pattern/
        special_tokens on an existing object."""

        def __get__(self, obj, objtype=None):
            if obj is None:
                def load(model_path: str, backend: str = "cuda",
                         device="cuda") -> "Tokenizer":
                    merges, pattern, special = \
                        serialization.read_model_any(model_path)
                    return objtype(merges=merges, pattern=pattern,
                                   special_tokens=special, backend=backend,
                                   device=device)
                return load

            def load(model_path: str) -> "Tokenizer":
                merges, pattern, special = \
                    serialization.read_model_any(model_path)
                obj._merges = np.asarray(merges, np.int32).reshape(-1, 2)
                obj._pattern = pattern
                obj._special_tokens = dict(special)
                obj._rebuild()
                return obj
            return load

    load = _HybridLoad()
