"""Plain reference of one BPE training job: from the corpus bytes to the
``.model`` and ``.vocab`` bytes, in Python and NumPy.

It imports nothing of the program under test and takes nothing that the
program made: it reads the same corpus bytes and the configuration's
trainer settings, and works out everything again.

The semantics it holds the program to:

* words: the corpus split at the four delimiters ``' '``, ``'\\t'``,
  ``'\\r'``, ``'\\n'``; empty words dropped; each distinct word counted.
* settings: a coverage outside (0, 1) becomes 0.995 and a
  ``min_pair_freq`` of 0 becomes 2000, before anything else.
* coverage: each byte's count is its number of positions over the
  distinct words (a word counted once, whatever its count); the bytes in
  the order ``(165 + byte) & 255``, stably sorted by count, highest
  first; the first ``floor(float32(n) * float32(coverage))`` of the n
  present bytes are kept, every other byte becomes ``unk_id``.
* merges: a pair is two adjacent tokens of one word, neither ``unk_id``;
  its count is the sum of the counts of the words it occurs in, once a
  position.  Each merge takes the highest count, ties to the smallest
  ``(a, b)``, while that count reaches ``min_pair_freq``; merge ``k``
  makes id ``256 + k`` and replaces the occurrences of ``(a, b)`` in
  each word greedily from the left (``a a a`` becomes ``(aa) a``).
* ``.model``: little-endian int32 ``(a, b, 256 + k)`` a merge.
* ``.vocab``: one line a token id, ``<bytes> <frequency>\\n``, the bytes
  of id 0 empty, a merged id the bytes of its two parts; the frequency
  is the sum of word counts over the final tokens.

The merge loop keeps the stream of tokens as linked lists, one per word,
a count for each pair and the positions where each pair may occur, so a
merge costs its occurrences and not a recount.
"""

from __future__ import annotations

import collections
import heapq
from dataclasses import dataclass, field

import numpy as np

_DELIMS = bytes.maketrans(b"\t\r\n", b"   ")
_DEAD = -(1 << 40)         # a token merged into its left neighbour


@dataclass
class Result:
    """What one job of the reference gives."""

    merges: np.ndarray            # int32 [M, 2]
    merge_freqs: np.ndarray       # int64 [M]
    model: bytes                  # the .model file
    vocab: bytes                  # the .vocab file
    n_words: int                  # distinct words
    n_tokens: int                 # tokens of the distinct words
    # work of the merge loop, for the roofline: distinct pairs of the
    # first count, and per merge the pairs whose count changed and the
    # occurrences merged
    initial_pairs: int = 0
    changed_pairs: list = field(default_factory=list)
    occurrences: list = field(default_factory=list)


def settings(target_vocab_size: int, unk_id: int, character_coverage: float,
             min_pair_freq: int) -> tuple[int, int, float, int]:
    """The trainer settings after the defaulting rules."""
    cov = character_coverage
    if cov <= 0.0 or cov >= 1.0:
        cov = 0.995
    if min_pair_freq == 0:
        min_pair_freq = 2000
    return target_vocab_size, unk_id, cov, min_pair_freq


def word_counts(data: bytes) -> collections.Counter:
    """Each distinct word of the corpus and its count."""
    counts = collections.Counter(data.translate(_DELIMS).split(b" "))
    counts.pop(b"", None)
    return counts


def kept_bytes(words, coverage: float) -> np.ndarray:
    """bool [256]: the bytes that the coverage rule keeps."""
    hist = np.bincount(np.frombuffer(b"".join(words), np.uint8),
                       minlength=256)
    order = [(slot - 165) & 255 for slot in range(256)]
    present = [c for c in order if hist[c] > 0]
    present.sort(key=lambda c: -int(hist[c]))     # stable
    n = len(present)
    keep = min(int(np.float32(n) * np.float32(coverage)), n)
    out = np.zeros(256, bool)
    out[present[:keep]] = True
    return out


def train(data: bytes, target_vocab_size: int, unk_id: int,
          character_coverage: float, min_pair_freq: int,
          ties_to_largest: bool = False) -> Result:
    """The reference's job on ``data``.  ``ties_to_largest`` breaks the
    configuration's tie rule (ties to the largest ``(a, b)``): the
    control, which the comparison has to find not correct."""
    vocab, unk, cov, min_freq = settings(
        target_vocab_size, unk_id, character_coverage, min_pair_freq)
    counts = word_counts(data)
    words = list(counts)
    keep = kept_bytes(words, cov)
    lens = np.fromiter((len(w) for w in words), np.int64, len(words))
    raw = np.frombuffer(b"".join(words), np.uint8)
    n = len(raw)
    tok = np.where(keep[raw], raw.astype(np.int64), unk)
    weight = np.repeat(np.fromiter((counts[w] for w in words), np.int64,
                                   len(words)), lens)
    ends = np.cumsum(lens)
    nxt = np.arange(1, n + 1, dtype=np.int64)
    prv = np.arange(-1, n - 1, dtype=np.int64)
    nxt[ends - 1] = -1
    prv[ends - lens] = -1
    merges, freqs, changed, occ, n_initial = _merge_loop(
        tok, nxt, prv, weight, unk, vocab - 256, min_freq,
        -1 if ties_to_largest else 1)
    merges_arr = np.array(merges, np.int32).reshape(-1, 2)
    freqs_arr = np.array(freqs, np.int64)
    final = np.asarray(tok)
    size = 256 + len(merges)
    ok = (final >= 0) & (final < size)
    tok_freq = np.bincount(final[ok], weights=weight[ok], minlength=size)
    return Result(merges=merges_arr, merge_freqs=freqs_arr,
                  model=model_bytes(merges_arr),
                  vocab=vocab_bytes(merges_arr,
                                    np.rint(tok_freq).astype(np.int64)),
                  n_words=len(words), n_tokens=n,
                  initial_pairs=n_initial, changed_pairs=changed,
                  occurrences=occ)


def _merge_loop(tok, nxt, prv, weight, unk, n_merges, min_freq, tie):
    """The merges, in place on ``tok`` (a merged-away position becomes
    _DEAD): (merges, counts, changed pairs a merge, occurrences a merge,
    distinct pairs at the start).  The heap holds ``(-count, tie * key)``:
    ties go to the smallest key for ``tie`` 1, the largest for -1."""
    left = np.nonzero((nxt >= 0))[0]
    right = nxt[left]
    ok = (tok[left] != unk) & (tok[right] != unk)
    left, right = left[ok], right[ok]
    keys = (tok[left] << 32) | tok[right]
    order = np.argsort(keys, kind="stable")
    keys, left = keys[order], left[order]
    cuts = np.flatnonzero(np.diff(keys)) + 1
    starts = np.concatenate([[0], cuts]) if len(keys) else cuts
    uniq = keys[starts]
    sums = np.add.reduceat(weight[left], starts) if len(keys) else uniq
    count = dict(zip(uniq.tolist(), sums.tolist()))
    where = dict(zip(uniq.tolist(),
                     (p.tolist() for p in np.split(left, cuts))))
    heap = [(-c, tie * k) for k, c in count.items()]
    heapq.heapify(heap)
    t, nx, pv, w = tok.tolist(), nxt.tolist(), prv.tolist(), weight.tolist()
    merges, freqs, changed, occ = [], [], [], []
    while len(merges) < n_merges:
        # every pair with a count has an entry no lower than its count
        while heap:
            c, hk = heap[0]
            cur = count.get(tie * hk, 0)
            if cur == -c:
                break
            heapq.heappop(heap)
            if cur > 0:
                heapq.heappush(heap, (-cur, hk))
        if not heap or -heap[0][0] < min_freq:
            break
        c, hk = heap[0]
        k = tie * hk
        a, b = k >> 32, k & 0xFFFFFFFF
        z = 256 + len(merges)
        merges.append((a, b))
        freqs.append(-c)
        delta = collections.defaultdict(int)
        born = collections.defaultdict(list)
        done = 0
        for i in sorted(set(where.pop(k))):
            if t[i] != a:
                continue
            j = nx[i]
            if j < 0 or t[j] != b:
                continue
            wi = w[i]
            done += 1
            delta[k] -= wi
            h = pv[i]
            if h >= 0 and t[h] != unk:
                th = t[h] << 32
                delta[th | a] -= wi
                delta[th | z] += wi
                born[th | z].append(h)
            m = nx[j]
            if m >= 0:
                tm = t[m]
                if tm != unk:
                    delta[(b << 32) | tm] -= wi
                    delta[(z << 32) | tm] += wi
                    born[(z << 32) | tm].append(i)
                pv[m] = i
            nx[i] = m
            t[i] = z
            t[j] = _DEAD
        moved = 0
        for kk, d in delta.items():
            if d:
                moved += 1
                nc = count.get(kk, 0) + d
                if nc:
                    count[kk] = nc
                else:
                    del count[kk]
                if d > 0:
                    heapq.heappush(heap, (-nc, tie * kk))
        for kk, ps in born.items():
            where.setdefault(kk, []).extend(ps)
        changed.append(moved)
        occ.append(done)
    tok[:] = t
    return merges, freqs, changed, occ, len(uniq)


def token_strings(merges: np.ndarray) -> list[bytes]:
    """id -> bytes: id 0 empty, ids 1-255 their byte, a merge its parts."""
    toks = [b""] + [bytes([i]) for i in range(1, 256)]
    for a, b in merges.tolist():
        toks.append(toks[a] + toks[b])
    return toks


def model_bytes(merges: np.ndarray) -> bytes:
    ids = np.arange(256, 256 + len(merges), dtype=np.int64)
    triples = np.column_stack([merges.astype(np.int64), ids])
    return triples.astype("<i4").tobytes()


def vocab_bytes(merges: np.ndarray, freqs: np.ndarray) -> bytes:
    return b"".join(tok + b" " + str(int(f)).encode() + b"\n"
                    for tok, f in zip(token_strings(merges), freqs.tolist()))
