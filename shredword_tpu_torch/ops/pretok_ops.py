"""The GPT pattern's character classes (the class table of the JAX
package's ``shredword_tpu/ops/pretok_ops.py``, kept as the port's own
copy).

The native GPT scanner (``runtime/csrc/pretok.cpp``) splits text with
the pattern's closed-form run logic over one class per code point.  The
classes are ground truth from the ``regex`` module itself: every Unicode
code point is classified by its ``\\s``, ``\\p{N}``, ``\\p{L}`` and the
case-insensitive contraction letters (e.g. U+017F LONG S matches
``(?i:s)``).  The table is built once (a few seconds) and cached on
disk under ``$XDG_CACHE_HOME/shredword_tpu_torch/`` (1.1 MB int8).
"""

from __future__ import annotations

import os

import numpy as np

# class ids
C_OTHER = 0       # matches [^\s\p{L}\p{N}], not apostrophe
C_SPACE = 1       # ' '
C_WS = 2          # \s except space/\r/\n
C_CR = 3
C_LF = 4
C_DIGIT = 5
C_LETTER = 6      # letters with no contraction role
C_APO = 7         # '
C_S, C_D, C_M, C_T, C_L, C_V, C_R, C_E = 8, 9, 10, 11, 12, 13, 14, 15

_MAX_CP = 0x110000
_TABLE: np.ndarray | None = None


def _cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "shredword_tpu_torch", "gpt_classes_v1.npy")


def _build_table() -> np.ndarray:
    """Classify every codepoint with the regex module itself."""
    import regex as _re
    table = np.zeros(_MAX_CP, np.int8)
    all_cps = "".join(
        chr(c) for c in range(_MAX_CP)
        if not (0xD800 <= c <= 0xDFFF))          # surrogates unencodable
    cps = np.frombuffer(all_cps.encode("utf-32-le"), np.uint32)

    def hits(pattern):
        h = np.zeros(len(cps), bool)
        for m in _re.finditer(pattern, all_cps):
            h[m.start():m.end()] = True
        return h

    table[cps[hits(r"\s")]] = C_WS
    table[cps[hits(r"\p{N}")]] = C_DIGIT
    letter = hits(r"\p{L}")
    table[cps[letter]] = C_LETTER
    for pat, cls in ((r"s", C_S), (r"d", C_D), (r"m", C_M), (r"t", C_T),
                     (r"l", C_L), (r"v", C_V), (r"r", C_R), (r"e", C_E)):
        sel = hits(f"(?i:{pat})") & letter
        table[cps[sel]] = cls
    table[ord(" ")] = C_SPACE
    table[ord("\r")] = C_CR
    table[ord("\n")] = C_LF
    table[ord("'")] = C_APO
    return table


def class_table() -> np.ndarray:
    """int8 [0x110000]: the class of every code point, built at first use
    and cached on disk (temp file, then rename)."""
    global _TABLE
    if _TABLE is None:
        path = _cache_path()
        if os.path.exists(path):
            _TABLE = np.load(path)
        else:
            _TABLE = _build_table()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path[:-4] + f".tmp{os.getpid()}.npy"
            np.save(tmp, _TABLE)
            os.replace(tmp, path)
    return _TABLE
