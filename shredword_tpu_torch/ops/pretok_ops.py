"""The GPT pattern's pre-tokenizer: character classes, the vectorised
host splitter and the device splitter (the port's own copy of the JAX
package's ``shredword_tpu/ops/pretok_ops.py``).

Every alternative of the GPT pattern is decidable from runs of character
classes with at most two characters of lookahead, so the split is a
fixed pipeline of per-position boolean algebra over one class per code
point (see :func:`gpt_starts`).  The classes are ground truth from the
``regex`` module itself: every Unicode code point is classified by its
``\\s``, ``\\p{N}``, ``\\p{L}`` and the case-insensitive contraction
letters (e.g. U+017F LONG S matches ``(?i:s)``).  The table is built
once (a few seconds) and cached on disk under
``$XDG_CACHE_HOME/shredword_tpu_torch/`` (1.1 MB int8).

Three splitters give the same match starts:

- the native scanner (``runtime/csrc/pretok.cpp``, through
  ``pretokenize.gpt_starts_bytes``), the host default;
- :func:`gpt_starts`, vectorised numpy, the oracle of the others;
- :func:`gpt_starts_device`: the class lookup on the host, then the
  match-start mask on a torch device, :func:`gpt_starts_mask` (the
  kernel ``csrc/pretok.cu`` on a card, :func:`gpt_starts_mask_plain` on
  the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import resolve_device
from . import _kernels

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


_LETTERISH = np.zeros(17, bool)
_LETTERISH[[C_LETTER, C_S, C_D, C_M, C_T, C_L, C_V, C_R, C_E]] = True
_WSANY = np.zeros(17, bool)
_WSANY[[C_SPACE, C_WS, C_CR, C_LF]] = True
_SDMT = np.zeros(17, bool)
_SDMT[[C_S, C_D, C_M, C_T]] = True
# class index 16 = out-of-text sentinel (False in every mask)


def _PUNCT(c):
    return (c == C_OTHER) | (c == C_APO)


def gpt_starts(cp: np.ndarray) -> np.ndarray:
    """Match-start indices (char space) for PATTERN_GPT; starts[0] == 0.
    Chunk i spans [starts[i], starts[i+1]) with starts[len] == n."""
    n = len(cp)
    if n == 0:
        return np.zeros(0, np.int64)
    cls = class_table()[cp].astype(np.int8)
    nxt = np.full(n, 16, np.int8)
    nxt[:n - 1] = cls[1:]
    nxt2 = np.full(n, 16, np.int8)
    nxt2[:max(n - 2, 0)] = cls[2:]
    prv = np.full(n, 16, np.int8)
    prv[1:] = cls[:-1]

    letter = _LETTERISH[cls]
    wsany = _WSANY[cls]
    nl = (cls == C_CR) | (cls == C_LF)
    punct = (cls == C_OTHER) | (cls == C_APO)
    space = cls == C_SPACE
    tabish = cls == C_WS
    digit = cls == C_DIGIT
    letter_n = _LETTERISH[nxt]
    punct_p = _PUNCT(prv)
    idx = np.arange(n, dtype=np.int64)
    # start is over-allocated so every "mark position p+s for mask at p"
    # is a shifted boolean-mask assignment (one pass, no fancy-index
    # compaction — measured 5x faster at corpus scale)
    start = np.zeros(n + 3, bool)

    def mark(mask, shift=0):
        start[shift:shift + n][mask] = True

    # ---- alt 1: contractions (previous char must not consume the ')
    apo = cls == C_APO
    blocked = punct_p | (prv == C_SPACE)
    con1 = apo & ~blocked & _SDMT[nxt]
    con2 = (apo & ~blocked & ~con1
            & (((nxt == C_L) & (nxt2 == C_L))
               | ((nxt == C_V) & (nxt2 == C_E))
               | ((nxt == C_R) & (nxt2 == C_E))))
    mark(con1)
    mark(con1, 2)                      # next chunk resumes after suffix
    mark(con2)
    mark(con2, 3)
    consumed = np.zeros(n + 2, bool)   # letters eaten by a contraction
    consumed[1:1 + n][con1] = True
    consumed[1:1 + n][con2] = True
    consumed[2:2 + n][con2] = True
    consumed = consumed[:n]
    con = con1 | con2

    # ---- alt 2: letter-run chunks with optional absorbed prefix
    consumed_p = np.zeros(n, bool)
    consumed_p[1:] = consumed[:-1]
    letter_p = _LETTERISH[prv]
    head = letter & ~consumed & (~letter_p | consumed_p)
    # prefix candidates at head-1:
    #   lone punct (length-1 punct run), itself not space-prefixed and
    #   not a contraction apostrophe; or any space/tab-class ws char
    punct_pp = np.full(n, 16, np.int8)             # class at p-2
    punct_pp[1:] = prv[:-1]
    con_p = np.zeros(n, bool)
    con_p[1:] = con[:-1]
    lone_punct_p = (punct_p & ~_PUNCT(punct_pp)
                    & (punct_pp != C_SPACE) & ~con_p)
    ws_prefix_p = (prv == C_SPACE) | (prv == C_WS)
    absorb = head & (lone_punct_p | ws_prefix_p)
    absorb[0] = False
    mark(head & ~absorb)
    if n > 1:
        start[: n - 1][absorb[1:]] = True          # mark position p-1

    # ---- alt 3: digit blocks of 3 anchored at run starts
    if digit.any():
        drs = digit.copy()
        drs[1:] &= ~digit[:-1]
        d_id = np.cumsum(drs) - 1
        d_start = idx[drs]
        off = idx[digit] - d_start[d_id[digit]]
        blk = np.zeros(n, bool)
        blk[idx[digit][off % 3 == 0]] = True
        mark(blk)
        dre = digit.copy()
        dre[:-1] &= ~digit[1:]
        mark(dre, 1)                   # position after each digit run

    # ---- alt 4: punct-run chunks (+space prefix; newline suffix below)
    prs = punct & ~punct_p & ~con
    sp_absorb = prs & (prv == C_SPACE)
    sp_absorb[0] = False
    # a lone punct followed by a letter was absorbed as alt-2 prefix
    lone = punct & ~punct_p & ~_PUNCT(nxt)
    eaten = lone & letter_n & ~con & ~(prv == C_SPACE)
    mark(prs & ~sp_absorb & ~eaten)
    if n > 1:
        start[: n - 1][sp_absorb[1:]] = True

    # ---- alts 5/6/7: whitespace runs
    if wsany.any():
        wrs = wsany & ~np.concatenate([[False], wsany[:-1]])
        wre = wsany & ~np.concatenate([wsany[1:], [False]])
        a = idx[wrs]
        b = idx[wre] + 1
        # per-run last-newline / first-non-newline via searchsorted over
        # the sorted nl / non-nl-ws index lists (ufunc.at is too slow)
        nl_idx = idx[nl]
        if len(nl_idx):
            pos = np.searchsorted(nl_idx, b) - 1
            got = nl_idx[np.maximum(pos, 0)]
            lastnl = np.where((pos >= 0) & (got >= a), got, -1)
        else:
            lastnl = np.full(len(a), -1, np.int64)
        nonnl_idx = idx[wsany & ~nl]
        if len(nonnl_idx):
            pos2 = np.minimum(np.searchsorted(nonnl_idx, a),
                              len(nonnl_idx) - 1)
            got2 = nonnl_idx[pos2]
            first_nonnl = np.where((got2 >= a) & (got2 < b), got2,
                                   np.iinfo(np.int64).max)
        else:
            first_nonnl = np.full(len(a), np.iinfo(np.int64).max)
        lead = np.minimum(first_nonnl, b) - a      # nl-prefix length
        absorb_nl = (a > 0) & punct[np.maximum(a - 1, 0)] & nl[a]
        p0 = np.where(absorb_nl, a + lead, a)
        start[p0[p0 < b]] = True
        rem = np.maximum(p0, np.where(lastnl >= p0, lastnl + 1, p0))
        mark_nl = (lastnl >= p0) & (lastnl + 1 < b)
        start[(lastnl + 1)[mark_nl]] = True
        leftover = (b < n) & (b - rem >= 2)
        start[(b - 1)[leftover]] = True

    start[0] = True
    return np.nonzero(start[:n])[0].astype(np.int64)


def gpt_split_str(text: str) -> list[str]:
    """PATTERN_GPT chunks via the vectorized splitter (host path)."""
    if not text:
        return []
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    starts = gpt_starts(cp)
    bounds = np.concatenate([starts, [len(cp)]])
    return [text[bounds[i]:bounds[i + 1]] for i in range(len(starts))]


def gpt_chunk_lens_bytes(data: bytes) -> np.ndarray:
    """Chunk byte-lengths of PATTERN_GPT over utf-8 bytes (for the
    device encoder: pairs with the raw byte stream, no str slicing)."""
    if not data:
        return np.zeros(0, np.int64)
    text = data.decode("utf-8")
    cp = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    starts = gpt_starts(cp)
    blen = np.where(cp < 0x80, 1,
                    np.where(cp < 0x800, 2, np.where(cp < 0x10000, 3, 4)))
    byte_off = np.zeros(len(cp) + 1, np.int64)
    np.cumsum(blen, out=byte_off[1:])
    bounds = byte_off[np.concatenate([starts, [len(cp)]])]
    return np.diff(bounds)




# ---------------------------------------------------------------------
# device splitter: the same run logic as gpt_starts, on a torch device
# ---------------------------------------------------------------------
#
# Fixed-shape formulation: the run compactions of gpt_starts (np.nonzero
# and searchsorted over run lists) become max-scans (forward run start
# and last newline so far, reverse run end and next non-newline), with
# run stats broadcast by gathering through the run-start and run-end
# positions, after which every alternative is per-position boolean
# algebra.  Input is the int8 class array (class 16 = out of text) and
# the true length n; output is the boolean match-start mask.

GPT_TILE = 1024          # csrc/pretok.cu: positions per block
GPT_MAX_N = 2**30        # csrc/pretok.cu keys a run start as 2 p + bit


def _scan_max(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive running maximum, from the end when ``reverse``."""
    if reverse:
        return x.flip(0).cummax(0).values.flip(0)
    return x.cummax(0).values


def gpt_starts_mask_plain(cls: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gpt_starts_mask`: the JAX
    package's ``gpt_starts_mask_jnp`` op for op (its associative max-scans
    as ``cummax``, the reverse ones flipped), on cls's device."""
    N = cls.shape[0]
    dev = cls.device
    if N == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    intext = idx < n
    cls = torch.where(intext, cls.to(torch.int32), 16)

    def shift_next(x, k, fill):
        return torch.cat([x[k:], x.new_full((min(k, N),), fill)])

    def shift_prev(x, k, fill):
        return torch.cat([x.new_full((min(k, N),), fill), x[:max(N - k, 0)]])

    nxt = shift_next(cls, 1, 16)
    nxt2 = shift_next(cls, 2, 16)
    prv = shift_prev(cls, 1, 16)

    letterish = torch.from_numpy(_LETTERISH).to(dev)
    wsany_t = torch.from_numpy(_WSANY).to(dev)
    sdmt_t = torch.from_numpy(_SDMT).to(dev)

    def lookup(table, c):
        return table[c.long()]

    letter = lookup(letterish, cls)
    wsany = lookup(wsany_t, cls)
    nl = (cls == C_CR) | (cls == C_LF)
    punct = (cls == C_OTHER) | (cls == C_APO)
    digit = cls == C_DIGIT
    letter_n = lookup(letterish, nxt)
    punct_p = (prv == C_OTHER) | (prv == C_APO)

    start = torch.zeros(N + 3, dtype=torch.bool, device=dev)
    pad3 = torch.zeros(3, dtype=torch.bool, device=dev)

    def mark(start, mask, shift=0):
        m = torch.cat([mask, pad3])
        if shift:
            m = torch.cat([m.new_zeros(shift), m[:-shift]])
        return start | m

    def mark_prev(start, mask):          # start[p] |= mask[p + 1]
        return start | torch.cat([shift_next(mask, 1, False), pad3])

    # ---- alt 1: contractions
    apo = cls == C_APO
    blocked = punct_p | (prv == C_SPACE)
    con1 = apo & ~blocked & lookup(sdmt_t, nxt)
    con2 = (apo & ~blocked & ~con1
            & (((nxt == C_L) & (nxt2 == C_L))
               | ((nxt == C_V) & (nxt2 == C_E))
               | ((nxt == C_R) & (nxt2 == C_E))))
    start = mark(start, con1)
    start = mark(start, con1, 2)
    start = mark(start, con2)
    start = mark(start, con2, 3)
    con = con1 | con2
    consumed = (shift_prev(con1, 1, False) | shift_prev(con2, 1, False)
                | shift_prev(con2, 2, False))

    # ---- alt 2: letter runs with optional absorbed prefix
    consumed_p = shift_prev(consumed, 1, False)
    letter_p = lookup(letterish, prv)
    head = letter & ~consumed & (~letter_p | consumed_p)
    prv2 = shift_prev(cls, 2, 16)
    con_p = shift_prev(con, 1, False)
    lone_punct_p = (punct_p & ~((prv2 == C_OTHER) | (prv2 == C_APO))
                    & (prv2 != C_SPACE) & ~con_p)
    ws_prefix_p = (prv == C_SPACE) | (prv == C_WS)
    absorb = head & (lone_punct_p | ws_prefix_p) & (idx > 0)
    start = mark(start, head & ~absorb)
    start = mark_prev(start, absorb)

    # ---- alt 3: digit blocks of 3 anchored at run starts
    drs = digit & ~shift_prev(digit, 1, False)
    run_start = _scan_max(torch.where(drs, idx, -1))
    off = idx - run_start
    blk = digit & (off % 3 == 0)
    start = mark(start, blk)
    dre = digit & ~shift_next(digit, 1, False)
    start = mark(start, dre, 1)

    # ---- alt 4: punct runs (+space prefix)
    prs = punct & ~punct_p & ~con
    sp_absorb = prs & (prv == C_SPACE) & (idx > 0)
    lone = punct & ~punct_p & ~((nxt == C_OTHER) | (nxt == C_APO))
    eaten = lone & letter_n & ~con & ~(prv == C_SPACE)
    start = mark(start, prs & ~sp_absorb & ~eaten)
    start = mark_prev(start, sp_absorb)

    # ---- alts 5/6/7: whitespace runs.  Run stats (start a, end b,
    # first non-newline, absorb flag, last newline) broadcast to every
    # position by gathering through the run-start/run-end position
    # scans; a value max-scan would leak across runs.
    wrs = wsany & ~shift_prev(wsany, 1, False)
    wre = wsany & ~shift_next(wsany, 1, False)
    big = N + 8
    a_of = _scan_max(torch.where(wrs, idx, -1))                  # run start
    b_of = -_scan_max(torch.where(wre, -(idx + 1), -big),
                      reverse=True)                              # run end+1
    a_clip = a_of.clamp(0, N - 1).long()
    bm1 = (b_of - 1).clamp(0, N - 1).long()
    valid = wsany & (a_of >= 0)

    nonnl = wsany & ~nl
    first_nonnl_from = -_scan_max(torch.where(nonnl, -idx, -big),
                                  reverse=True)
    fnn = first_nonnl_from[a_clip]
    lead = torch.minimum(fnn, b_of) - a_of
    prev_punct_a = shift_prev(punct, 1, False)
    absorb_nl_at_a = prev_punct_a & nl & wrs & (idx > 0)
    absorb_nl = absorb_nl_at_a[a_clip]
    p0 = torch.where(absorb_nl, a_of + lead, a_of)
    # last newline at or before the run's final position (values from
    # before the run fall below p0 and are rejected by the guards)
    lastnl_upto = _scan_max(torch.where(nl, idx, -1))
    lastnl_bc = lastnl_upto[bm1]

    start = mark(start, valid & (idx == p0) & (p0 < b_of))
    mark_nl = (valid & (lastnl_bc >= p0) & (idx == lastnl_bc + 1)
               & (idx < b_of))
    start = mark(start, mark_nl)
    rem = torch.maximum(p0, torch.where(lastnl_bc >= p0, lastnl_bc + 1, p0))
    leftover = valid & wre & (b_of < n) & (b_of - rem >= 2)
    start = mark(start, leftover)

    out = start[:N].clone()
    out[0] = True
    return out & intext


def gpt_starts_mask(cls: torch.Tensor, n: int) -> torch.Tensor:
    """The GPT pattern's match-start mask: bool [N] for int8 classes
    ``cls`` [N] (:func:`class_table` values) of which the first ``n`` are
    the text; positions from n on count as class 16 and are False.

    Replaces the JAX package's ``gpt_starts_mask_jnp``
    (``shredword_tpu/ops/pretok_ops.py:313``, XLA).  CPU tensors run
    :func:`gpt_starts_mask_plain`; CUDA tensors run ``csrc/pretok.cu``
    (P1): three launches per call with n >= 1 (the tiles' scan totals,
    their carries, then the scans and the mask), each counted in
    ``.launches``."""
    if cls.dtype != torch.int8 or cls.dim() != 1:
        raise TypeError("cls must be int8 [N]")
    N = cls.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f"n must be in [0, {N}], got {n}")
    dev = cls.device
    if dev.type == "cpu":
        return gpt_starts_mask_plain(cls, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n >= GPT_MAX_N:
        raise ValueError(f"the kernel takes n < {GPT_MAX_N}, got {n}")
    out = torch.zeros(N, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    text = cls[:n].contiguous()
    nt = -(-n // GPT_TILE)
    agg = torch.empty(6 * nt, dtype=torch.int32, device=dev)
    carry = torch.empty_like(agg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels._check(_kernels.lib().shred_gpt_starts_mask(
            text.data_ptr(), n, agg.data_ptr(), carry.data_ptr(),
            out.data_ptr(), stream))
    gpt_starts_mask.launches += 3
    return out


gpt_starts_mask.launches = 0


def gpt_starts_device(cp: np.ndarray, device="cuda") -> np.ndarray:
    """Match-start indices (int64, char space) of the GPT pattern through
    the device splitter: the class lookup on the host, the classes up,
    :func:`gpt_starts_mask` on ``device`` (default the card; "cpu" runs
    its plain version), ``torch.nonzero`` there and the indices down.
    Equal to :func:`gpt_starts`."""
    dev = resolve_device(device)
    n = len(cp)
    if n == 0:
        return np.zeros(0, np.int64)
    cls = class_table()[np.asarray(cp, np.uint32)].astype(np.int8)
    mask = gpt_starts_mask(torch.from_numpy(cls).to(dev), n)
    return torch.nonzero(mask).flatten().cpu().numpy()
