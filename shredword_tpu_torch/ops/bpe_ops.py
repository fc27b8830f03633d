"""Flat-stream BPE engine in plain PyTorch (port of
``shredword_tpu/ops/bpe_ops.py`` up to ``train_loop``).

  tokens  : int32 [N]  token ids of all unique words, concatenated
  word_id : int32 [N]  owning word index per position
  wcount  : int32 [N]  occurrence count of the owning word

A pair lives at position i: (tokens[i], tokens[i+1]) when both are in
one word and neither is unk.  Counting is exact (sorted unique pair keys
plus an integer segment sum), the best pair breaks ties to the
lexicographically smallest (a, b), and merging applies the reference's
greedy left-to-right overlap rule (bpe.cpp:472-482).  PyTorch runs
eagerly, so every merge compacts the stream to its exact length: the
JAX engine's capacity buckets and re-compaction have nothing to do.

It is the auto route for corpora whose words exceed the hist layout, and
the independent cross-check of the hist engine; ``parallel/train.py``
runs it on the ranks' shards of the stream.  :func:`train_loop` is the
plain version of F1 (``csrc/flat.cu``, ``_kernels.flat_train``), which
runs the same merges on the card from a :class:`FlatState`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import resolve_device


class CorpusState(NamedTuple):
    tokens: torch.Tensor    # int32 [N]
    word_id: torch.Tensor   # int32 [N]
    wcount: torch.Tensor    # int32 [N]


class TrainState(NamedTuple):
    corpus: CorpusState
    merges: np.ndarray       # int32 [M_max, 2]
    merge_freqs: np.ndarray  # int32 [M_max]
    n_merges: int            # including the n_prev resumed merges
    done: bool


def make_state(tokens, word_id, wcount, device="cuda") -> CorpusState:
    dev = resolve_device(device)

    def as_t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    return CorpusState(as_t(tokens), as_t(word_id), as_t(wcount))


def sum_by_key(keys: torch.Tensor,
               weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The distinct keys, ascending, and the int64 sum of each one's
    weights."""
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    total = torch.zeros(len(uniq), dtype=torch.int64, device=keys.device)
    total.index_add_(0, inv, weights.long())
    return uniq, total


def pair_counts(state: CorpusState,
                unk_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every distinct pair as the int64 key (a << 32) | b, ascending (so
    in (a, b) order at any vocab), and its int64 count."""
    t, wid = state.tokens, state.word_id
    valid = ((wid[:-1] == wid[1:]) & (t[:-1] != unk_id)
             & (t[1:] != unk_id))
    key = (t[:-1][valid].long() << 32) | t[1:][valid].long()
    return sum_by_key(key, state.wcount[:-1][valid])


def best_of(keys: torch.Tensor, counts: torch.Tensor,
            min_pair_freq: int) -> tuple[int, int, int]:
    """(a, b, count) of the highest count of distinct ascending pair keys
    (:func:`pair_counts`) that reaches min_pair_freq, ties to the
    smallest (a, b); count == 0 if none does."""
    if keys.numel() == 0:
        return 0, 0, 0
    cnt = torch.where(counts >= min_pair_freq, counts, 0)
    best = int(cnt.argmax())            # first maximum: smallest key
    k = int(keys[best])
    return k >> 32, k & 0xFFFFFFFF, int(cnt[best])


def best_pair(state: CorpusState, unk_id: int,
              min_pair_freq: int) -> tuple[int, int, int]:
    """(a, b, count) of the highest-count eligible pair, ties to the
    smallest (a, b); count == 0 if no pair reaches min_pair_freq."""
    return best_of(*pair_counts(state, unk_id), min_pair_freq)


def select_matches(state: CorpusState, a: int, b: int) -> torch.Tensor:
    """Greedy left-to-right non-overlapping occurrences of (a, b) within
    words (no unk exclusion: the reference merge scan matches raw ids,
    bpe.cpp:441-443).  In a run of consecutive matches (a == b) every
    other one from the run head is taken (bpe.cpp:480-482)."""
    t, wid = state.tokens, state.word_id
    match = torch.zeros_like(t, dtype=torch.bool)
    match[:-1] = (wid[:-1] == wid[1:]) & (t[:-1] == a) & (t[1:] == b)
    if a == b:
        idx = torch.arange(len(t), device=t.device)
        last_nm = torch.where(match, -1, idx).cummax(0).values
        match &= (idx - last_nm - 1) % 2 == 0
    return match


def apply_merge(state: CorpusState, a: int, b: int,
                new_id: int) -> CorpusState:
    """Merge every selected (a, b) into new_id and compact the stream."""
    sel = select_matches(state, a, b)
    t = torch.where(sel, new_id, state.tokens)
    keep = torch.ones_like(sel)
    keep[1:] = ~sel[:-1]                # drop the right half of each match
    return CorpusState(t[keep], state.word_id[keep], state.wcount[keep])


CHUNK_WORDS = 32     # words per presence bit of F1's index (csrc/flat.cu)
SEG_SLOTS = 256    # slots per kept segment maximum (csrc/flat.cu SEG)


def _as_uint32_bits(bits: torch.Tensor) -> torch.Tensor:
    """int64 values below 2**32 as int32 holding the same 32 bits."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def _or_bits(rows: torch.Tensor, bit: torch.Tensor, n_rows: int,
             words: int) -> torch.Tensor:
    """int32 [n_rows, words]: bit `bit` of row `rows` set for each pair,
    as 32-bit words."""
    cell = torch.unique(rows * (32 * words) + bit)
    r, b = cell // (32 * words), cell % (32 * words)
    out = torch.zeros(n_rows * words, dtype=torch.int64, device=rows.device)
    out.index_add_(0, r * words + b // 32, torch.ones_like(b) << (b % 32))
    return _as_uint32_bits(out).view(n_rows, words)


def presence_index(tokens: torch.Tensor, word: torch.Tensor, n_words: int,
                   rows: int) -> torch.Tensor:
    """F1's presence index of a stream: int32 [rows, ncw], bit c % 32 of
    word c // 32 of row x set when chunk c (words 32c .. 32c + 31) holds
    id x; ``word`` gives each position's word, ids below 0 (unk -1) have
    no row, ncw = ceil(nc / 32) for nc = ceil(n_words / 32) chunks."""
    nc = -(-n_words // CHUNK_WORDS)
    ok = tokens >= 0
    return _or_bits(tokens[ok].long(), word[ok].long() // CHUNK_WORDS, rows,
                    -(-nc // 32))


def sig_bit(ids: torch.Tensor) -> torch.Tensor:
    """The bit of each id in a word's 128-bit signature (csrc/flat.cu's
    sig_bit): the top 7 bits of the id times 0x9E3779B1, mod 2**32."""
    return ((ids.long() & 0xFFFFFFFF) * 0x9E3779B1 & 0xFFFFFFFF) >> 25


def word_signatures(tokens: torch.Tensor, word: torch.Tensor,
                    n_words: int) -> torch.Tensor:
    """F1's word signatures: int32 [n_words, 4], the 128 bits of word w
    holding bit sig_bit(x) of every id x in it (unk too)."""
    return _or_bits(word.long(), sig_bit(tokens), n_words, 4)


class FlatState:
    """F1's state (on the card), built once per ``train()`` from a
    :class:`CorpusState` and advanced in place by every call of
    ``_kernels.flat_train`` (layout in ``csrc/flat.cu``'s header).

    The words are the runs of equal ``word_id`` (the pairs of
    :func:`pair_counts`), each with one count.  ``corpus.tokens`` is
    taken, not copied: F1 merges every word in place, left-aligned, and
    keeps its live length; :meth:`compact` gives the plain version's
    arrays.  ``pres`` is the presence index of the stream's ids
    (:func:`presence_index`), a row per id up to the largest one in the
    stream (at least 256); :meth:`reserve` adds the rows of the ids a run
    will make.  ``sig`` holds each word's signature of its ids
    (:func:`word_signatures`), which F1 recomputes for every word it
    merges.  The pair counts are a hash table of ``cap`` int64 keys (a
    power of two of at least 6N, so at most half full: the run inserts
    at most 3N keys) with an int32 count per slot, and the kept maximum
    of every ``SEG_SLOTS`` slots; the table is empty until the first
    call counts the stream."""

    def __init__(self, corpus: CorpusState):
        t, wid, wc = corpus
        if any(x.dtype != torch.int32 or x.dim() != 1 or len(x) != len(t)
               or x.device != t.device for x in corpus):
            raise ValueError("tokens, word_id and wcount must be int32 [N] "
                             "on one device")
        n = len(t)
        dev = t.device
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = wid[1:] != wid[:-1]
        starts = first.nonzero()[:, 0]
        if not torch.equal(wc, torch.repeat_interleave(
                wc[starts], torch.diff(starts, append=starts.new_tensor(
                    [n])))):
            raise ValueError("wcount must be one count per word")
        i32 = dict(dtype=torch.int32, device=dev)
        self.tokens = t.contiguous()
        self.word_id, self.wcount = wid, wc
        self.off = torch.cat([starts, starts.new_tensor([n])]).to(
            torch.int32)
        self.len = torch.diff(self.off)
        self.wcnt = wc[starts].contiguous()
        top = int(t.max()) + 1 if n else 0
        word = torch.cumsum(first, 0) - 1
        self.pres = presence_index(t, word, len(starts), max(256, top))
        self.sig = word_signatures(t, word, len(starts))
        self.cap = 1 << max(10, (6 * max(n, 1) - 1).bit_length())
        self.tkey = torch.full((self.cap,), -1, dtype=torch.int64,
                               device=dev)
        self.cnt = torch.zeros(self.cap, **i32)
        nseg = self.cap // SEG_SLOTS
        self.skey = torch.full((nseg,), -1, dtype=torch.int64, device=dev)
        self.sce = torch.zeros(nseg, dtype=torch.int64, device=dev)
        self.dirty = torch.zeros(nseg, **i32)
        self.st = torch.zeros(8, **i32)
        self.counted = False      # the first call counts the stream
        self.n, self.merged = n, 0
        # what the passes and picks did (F1's st): chunks visited, words
        # whose signature holds the pair, segment maxima recomputed
        self.visited = self.candidates = self.refreshed = 0

    def reserve(self, rows: int) -> None:
        """Grow the presence index to ``rows`` ids (new rows empty)."""
        have = self.pres.shape[0]
        if rows > have:
            self.pres = torch.cat([self.pres, self.pres.new_zeros(
                (rows - have, self.pres.shape[1]))])

    @property
    def stream_len(self) -> int:
        """The live tokens, as of the last call."""
        return self.n - self.merged

    @property
    def n_words(self) -> int:
        return len(self.wcnt)

    def compact(self) -> CorpusState:
        """The live (tokens, word_id, wcount) in stream order: the
        arrays :func:`train_loop` leaves after the same merges."""
        lengths = torch.diff(self.off).long()
        word = torch.repeat_interleave(
            torch.arange(len(lengths), device=self.tokens.device), lengths)
        pos = torch.arange(self.n, device=self.tokens.device) \
            - self.off[word]
        keep = pos < self.len[word]
        return CorpusState(self.tokens[keep], self.word_id[keep],
                           self.wcount[keep])


def stream_length(corpus: CorpusState | FlatState) -> int:
    if isinstance(corpus, FlatState):
        return corpus.stream_len
    return len(corpus.tokens)


def final_corpus(corpus: CorpusState | FlatState) -> CorpusState:
    """The merged stream as the plain version keeps it."""
    return corpus.compact() if isinstance(corpus, FlatState) else corpus


def train_init(corpus: CorpusState, max_merges: int,
               n_prev_merges: int = 0) -> TrainState:
    return TrainState(corpus=corpus,
                      merges=np.zeros((max(max_merges, 1), 2), np.int32),
                      merge_freqs=np.zeros(max(max_merges, 1), np.int32),
                      n_merges=n_prev_merges, done=False)


def train_loop(ts: TrainState, unk_id: int, min_pair_freq: int, *,
               target_merges: int, max_steps: int,
               pick: Callable = best_pair) -> TrainState:
    """Up to max_steps greedy merges; merge k creates id 256 + k.
    ``pick(corpus, unk_id, min_pair_freq) -> (a, b, count)`` chooses each
    merge (``parallel/train.py`` passes the pick over every rank's
    span)."""
    corpus, n, done = ts.corpus, ts.n_merges, ts.done
    for _ in range(max_steps):
        if done or n >= target_merges:
            break
        a, b, cnt = pick(corpus, unk_id, min_pair_freq)
        if cnt == 0:
            done = True
            break
        corpus = apply_merge(corpus, a, b, 256 + n)
        ts.merges[n] = (a, b)
        ts.merge_freqs[n] = cnt
        n += 1
    return ts._replace(corpus=corpus, n_merges=n, done=done)
