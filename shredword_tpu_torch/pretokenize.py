"""Pre-tokenization: text -> chunks that BPE merges never cross (the
port's copy of the JAX package's ``shredword_tpu.pretokenize``).

Two families, matching the reference's two (disconnected) tracks:

1. **Whitespace** — the C++ trainer's strtok(" \\t\\r\\n") semantics
   (bpe_load_corpus, bpe.cpp:247-251): words are maximal runs of
   non-whitespace bytes; whitespace is dropped.  ``whitespace_keep``
   additionally emits the whitespace runs themselves as chunks so that
   encode/decode round-trips the exact input.
2. **Regex** — the GPT-style patterns documented in the reference's
   pure-Python track (base.py:38-58).  The pattern *strings* are the
   behavioral contract; they are reproduced here as data with the
   reference's own naming.

Special tokens are split out first (exact string match, never crossed by
either family).
"""

from __future__ import annotations

import functools

import regex as _re

# Reference patterns, verbatim from base.py:41-54 (data, not code).
PATTERN_GPT = (
    r"""'(?i:[sdmt]|ll|ve|re)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}"""
    r"""| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]|\s+(?!\S)|\s+"""
)
PATTERN_PREFIX = (
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"""
    r"""|\s+(?!\S)|\s+"""
)
PATTERN_WORD = r"""'s|'t|'re|'ve|'m|'ll|'d|[\w']+|[^\s\w\d]+|\s+(?!\S)|\s+"""
PATTERN_LOSSY = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+ | ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

PATTERNS = {
    "gpt": PATTERN_GPT,        # reference default (base.py:56)
    "prefix": PATTERN_PREFIX,  # "regex_pattern2"
    "word": PATTERN_WORD,      # "regex_pattern3" — lossless, space separate
    "lossy": PATTERN_LOSSY,    # "regex_pattern4"
}

_WHITESPACE = b" \t\r\n"


@functools.lru_cache(maxsize=64)
def _compiled(pattern: str):
    return _re.compile(pattern)


def regex_split(text: str, pattern: str = PATTERN_GPT) -> list[str]:
    """Chunking per the reference apply_regex (base.py:57-58).

    The GPT pattern routes through the native single-pass scanner
    (runtime/csrc/pretok.cpp, differential-tested identical to the regex
    module); other patterns use regex.findall.
    """
    if pattern in PATTERNS:
        pattern = PATTERNS[pattern]
    if pattern == PATTERN_GPT and text:
        try:
            return gpt_split(text)
        except Exception:       # native runtime unavailable: exact slow path
            pass
    return _compiled(pattern).findall(text)


def gpt_split(text: str) -> list[str]:
    """GPT-pattern chunks via the native scanner."""
    data = text.encode("utf-8")
    starts = gpt_starts_bytes(data)
    bounds = list(starts) + [len(data)]
    return [data[bounds[i]:bounds[i + 1]].decode("utf-8")
            for i in range(len(starts))]


def gpt_starts_bytes(data: bytes):
    """Chunk-start byte offsets of the GPT pattern (native scanner with
    regex-module-exact character classes)."""
    from .ops.pretok_ops import class_table
    from .runtime import native
    return native.gpt_starts_bytes(data, class_table())


def whitespace_split(data: bytes) -> list[bytes]:
    """strtok(" \\t\\r\\n") parity: whitespace dropped (bpe.cpp:247-251)."""
    return data.split()


def whitespace_keep_split(data: bytes) -> list[bytes]:
    """Lossless whitespace chunking: alternating word / whitespace runs.

    b"".join(whitespace_keep_split(x)) == x for all x; word chunks are
    identical to whitespace_split's, so a trainer-format model (trained on
    strtok words) encodes words exactly while whitespace survives as its
    own chunks.
    """
    out: list[bytes] = []
    i, n = 0, len(data)
    while i < n:
        j = i
        is_ws = data[i] in _WHITESPACE
        while j < n and (data[j] in _WHITESPACE) == is_ws:
            j += 1
        out.append(data[i:j])
        i = j
    return out


def split_special(text: str, special_tokens: dict[str, int],
                  allowed: set[str] | None = None) -> list[tuple[bool, str]]:
    """Split text around special tokens (exact match, longest-first).

    Returns [(is_special, chunk)] covering the text.  Only tokens in
    `allowed` (default: all registered) are recognized; others pass
    through as ordinary text.
    """
    use = {s for s in special_tokens if allowed is None or s in allowed}
    if not use:
        return [(False, text)] if text else []
    pat = "(" + "|".join(
        _re.escape(s) for s in sorted(use, key=len, reverse=True)) + ")"
    out: list[tuple[bool, str]] = []
    for part in _re.split(pat, text):
        if not part:
            continue
        out.append((part in use, part))
    return out
