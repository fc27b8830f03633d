"""The reference's model and vocab formats (the port's copy of the JAX
package's ``shredword_tpu.serialization``).

1. Binary ``.model``: little-endian int32 triples (first, second, 256+m)
   per merge (reference bpe_save, bpe.cpp:722-731).
2. Text ``.vocab``: "<token-bytes> <frequency>\\n" per id 0..255+M with raw
   unescaped bytes (bpe.cpp:704-719); byte 0's token string is empty
   (C-string semantics, see docs/CONFORMANCE.md §3).
3. Text ``shredword v1`` model: header + pattern + special tokens +
   "a b" merge lines (base.py:111-149), what ``Tokenizer.save`` writes
   when the model carries a pattern or special tokens.
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


def write_model_v1(path: str, merges: np.ndarray, pattern: str = "",
                   special_tokens: dict[str, int] | None = None) -> None:
    special_tokens = special_tokens or {}
    merges = np.asarray(merges, dtype=np.int64)
    if "\n" in pattern or "\r" in pattern:
        raise SerializationError(
            "v1 model format is line-oriented; pattern may not contain "
            "newlines")
    for name in special_tokens:
        if any(c in name for c in "\n\r"):
            raise SerializationError(
                f"special token {name!r} contains a newline; "
                "not representable in the v1 format")
    with open(path, "w", encoding="utf-8") as f:
        f.write("shredword v1\n")
        f.write(f"{pattern}\n")
        f.write(f"{len(special_tokens)}\n")
        for special, idx in special_tokens.items():
            f.write(f"{special} {idx}\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def read_model_v1(path: str):
    """Returns (merges int32[M,2], pattern, special_tokens)."""
    with open(path, "r", encoding="utf-8") as f:
        version = f.readline().strip()
        if version != "shredword v1":
            raise SerializationError(f"{path}: bad header {version!r}")
        pattern = f.readline().rstrip("\n")
        num_special = int(f.readline().strip())
        special = {}
        for _ in range(num_special):
            # rsplit: special-token names may contain spaces
            name, idx = f.readline().rstrip("\n").rsplit(" ", 1)
            special[name] = int(idx)
        merges = []
        for line in f:
            if not line.strip():
                continue
            a, b = map(int, line.split())
            merges.append((a, b))
    return (np.array(merges, dtype=np.int32).reshape(-1, 2), pattern, special)


def convert(src: str, dst: str, **v1_kwargs) -> None:
    """Convert between binary .model and shredword v1 text: reads either,
    writes binary unless dst ends with ".v1.model" / ".txt"."""
    try:
        merges = read_model_binary(src)
    except (SerializationError, ValueError):
        merges, pattern, special = read_model_v1(src)
        v1_kwargs.setdefault("pattern", pattern)
        v1_kwargs.setdefault("special_tokens", special)
    if dst.endswith((".v1.model", ".txt")):
        write_model_v1(dst, merges, **v1_kwargs)
    else:
        if v1_kwargs.get("pattern") or v1_kwargs.get("special_tokens"):
            raise SerializationError(
                "binary .model cannot carry a pattern or special "
                "tokens; convert to a .v1.model destination instead")
        write_model_binary(dst, merges)


def read_model_any(path: str):
    """Read a model in either format.  Returns (merges, pattern, special)."""
    try:
        return read_model_binary(path), "", {}
    except (SerializationError, ValueError, UnicodeDecodeError):
        return read_model_v1(path)
