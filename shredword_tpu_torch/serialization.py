"""The reference's model and vocab formats (the JAX package's
``shredword_tpu.serialization``, binary ``.model`` and ``.vocab`` part).

1. Binary ``.model``: little-endian int32 triples (first, second, 256+m)
   per merge (reference bpe_save, bpe.cpp:722-731).
2. Text ``.vocab``: "<token-bytes> <frequency>\\n" per id 0..255+M with raw
   unescaped bytes (bpe.cpp:704-719); byte 0's token string is empty
   (C-string semantics, see docs/CONFORMANCE.md §3).
"""

from __future__ import annotations

import numpy as np

from .errors import SerializationError


def write_model_binary(path: str, merges: np.ndarray) -> None:
    merges = np.asarray(merges, dtype=np.int32)
    if merges.ndim != 2 or merges.shape[1] != 2:
        raise SerializationError(f"merges must be [M, 2], got {merges.shape}")
    triples = np.column_stack(
        [merges, np.arange(256, 256 + len(merges), dtype=np.int32)])
    with open(path, "wb") as f:
        f.write(triples.astype("<i4").tobytes())


def read_model_binary(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) % 12 != 0:
        raise SerializationError(
            f"{path}: size {len(data)} is not a multiple of 12")
    triples = np.frombuffer(data, dtype="<i4").reshape(-1, 3)
    expected = np.arange(256, 256 + len(triples), dtype=np.int32)
    if len(triples) and not np.array_equal(triples[:, 2], expected):
        raise SerializationError(f"{path}: non-dense merge ids")
    return triples[:, :2].astype(np.int32)


def token_strings(merges: np.ndarray) -> list[bytes]:
    """id -> byte string.  Byte 0 maps to b"" (reference C-string
    semantics); out-of-range / negative merge components contribute
    nothing (the reference segfaults here; this degrades gracefully)."""
    toks: list[bytes] = [b""] + [bytes([i]) for i in range(1, 256)]
    for a, b in np.asarray(merges, dtype=np.int64):
        sa = toks[a] if 0 <= a < len(toks) else b""
        sb = toks[b] if 0 <= b < len(toks) else b""
        toks.append(sa + sb)
    return toks


def write_vocab(path: str, merges: np.ndarray, freqs: np.ndarray) -> None:
    toks = token_strings(merges)
    freqs = np.asarray(freqs, dtype=np.uint64)
    if len(freqs) != len(toks):
        raise SerializationError(
            f"freqs length {len(freqs)} != vocab size {len(toks)}")
    with open(path, "wb") as f:
        for tok, fr in zip(toks, freqs):
            f.write(tok + b" " + str(int(fr)).encode() + b"\n")
