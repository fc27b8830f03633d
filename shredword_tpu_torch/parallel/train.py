"""Sharded flat-stream training over a torch.distributed group (port of
``shredword_tpu/parallel/train.py``): the engine with no vocab bound, and
the sharded route for words longer than the table engines' layout.

The flat stream (``ops/bpe_ops.py``) is cut at word boundaries into one
span per rank (:func:`shard_corpus`); words never span ranks, so a merge
needs no halo.  :func:`sharded_train` drives
``_kernels.flat_sharded_train`` in calls of ``max_steps_per_call``
merges, as the JAX package dispatches its loop:

  - on a CUDA device S1: a rank alone (world 1) is F1's persistent launch
    on its span (``csrc/flat.cu``), one launch a call; over more ranks
    every rank keeps a hash table of the whole corpus's pair counts, so
    every rank picks the same pair with no broadcast (the JAX loop's
    replicated reduce, kept as exact deltas rather than recounted): the
    ranks' pair counts start it (:func:`initial_deltas`), and after each
    merge every rank's compact list of net deltas, summed by key on the
    card, is gathered at a fixed size (:func:`exchange_rows`) and added
    by every rank (``csrc/flat_sharded.cu``); the gathered headers say,
    alike on every rank, when a list did not fit and every rank
    exchanges again with more rows, or when a rank overflowed and every
    rank raises (:func:`next_rows`; :func:`exchange_deltas` is the plain
    version of that exchange);
  - its plain version, on the CPU: per merge the distinct pairs of the
    own span (``bpe_ops.pair_counts``: int64 keys (a << 32) | b, so one
    key orders (a, b) at any vocab -- the JAX package packs int32 keys
    below PACK_LIMIT and sorts two keys above it), one ``all_reduce(MAX)``
    of their number and one ``all_gather`` of the lists padded to it
    (:func:`gather_pairs`), the same sum by key and argmax on every rank
    (:func:`global_best_pair`: the first maximum in (a, b) order), then
    ``bpe_ops.apply_merge`` on the own span.

Counts are integers, so the result is the single-device flat engine's
whatever the ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..ops import _kernels, bpe_ops
from . import mesh as _mesh


class ShardedCorpus(NamedTuple):
    """Per-rank flat streams, stacked on a leading rank axis, as the JAX
    package lays them out."""

    tokens: np.ndarray    # int32 [D, C]
    word_id: np.ndarray   # int32 [D, C]  (global word ids, -1 pad)
    wcount: np.ndarray    # int32 [D, C]
    lengths: np.ndarray   # int32 [D]     live prefix per rank


def shard_corpus(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, n_shards: int) -> ShardedCorpus:
    """Split the flat stream at word boundaries into ``n_shards`` roughly
    equal spans (each cut moved forward to the next word start), padded
    to a common power-of-two capacity (at least 1024); equal, array for
    array, to the JAX package's."""
    n = len(tokens)
    cuts = [0]
    for s in range(1, n_shards):
        c = min(round(n * s / n_shards), n)
        while 0 < c < n and word_id[c] == word_id[c - 1]:
            c += 1
        cuts.append(max(c, cuts[-1]))
    cuts.append(n)
    spans = list(zip(cuts[:-1], cuts[1:]))
    max_len = max(b - a for a, b in spans)
    cap = max(1024, 1 << int(np.ceil(np.log2(max(max_len, 2)))))
    T = np.zeros((n_shards, cap), np.int32)
    W = np.full((n_shards, cap), -1, np.int32)
    C = np.zeros((n_shards, cap), np.int32)
    lengths = np.zeros(n_shards, np.int32)
    for i, (a, b) in enumerate(spans):
        T[i, :b - a] = tokens[a:b]
        W[i, :b - a] = word_id[a:b]
        C[i, :b - a] = wcount[a:b]
        lengths[i] = b - a
    return ShardedCorpus(T, W, C, lengths)


def local_state(sc: ShardedCorpus, rank: int,
                device) -> bpe_ops.CorpusState:
    """Rank ``rank``'s live span as a flat-engine state on ``device``."""
    m = int(sc.lengths[rank])
    return bpe_ops.make_state(sc.tokens[rank, :m], sc.word_id[rank, :m],
                              sc.wcount[rank, :m], device)


def gather_padded(rows: torch.Tensor, n: int, group) -> torch.Tensor:
    """Every rank's first ``n`` rows of ``rows`` (int64 [>= n, 2], (key >=
    0, value)) over ``group``, in rank order, each rank's padded with
    (-1, 0) to the longest: one ``all_reduce(MAX)`` of n, one
    ``all_gather``.  Returns int64 [world * longest, 2]."""
    m = torch.tensor([n], dtype=torch.int64, device=rows.device)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    send = rows.new_zeros((max(int(m), 1), 2))
    send[:, 0] = -1
    send[:n] = rows[:n]
    out = send.new_empty((group.size() * len(send), 2))
    dist.all_gather(list(out.chunk(group.size())), send, group=group)
    return out


def pack_rows(rows: torch.Tensor, flags: int = 0) -> torch.Tensor:
    """A rank's compact list as S1 lays it out: int64 [1 + n, 2], the
    header (n, flags) and then the n (key, value) rows of ``rows``."""
    head = rows.new_tensor([[len(rows), flags]], dtype=torch.int64)
    return torch.cat([head, rows.long()])


def exchange_rows(send: torch.Tensor, rows: int, group,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's header and first ``rows`` rows of its compact list
    ``send`` (int64 [>= 1, 2], :func:`pack_rows`'s layout; a shorter list
    is padded with zeros) over ``group``, in rank order: one
    ``all_gather`` of a fixed size and no read on the host.  Returns int64
    [world, 1 + rows, 2], into ``out`` when it has that shape."""
    buf = send[:1 + rows]
    if len(buf) < 1 + rows:
        buf = torch.cat([buf, buf.new_zeros((1 + rows - len(buf), 2))])
    shape = (group.size(), 1 + rows, 2)
    if out is None or out.shape != shape:
        out = buf.new_empty(shape)
    dist.all_gather(list(out.unbind(0)), buf.contiguous(), group=group)
    return out


def next_rows(heads, rows: int) -> int:
    """What every rank does after an exchange of ``rows`` rows a list,
    from the gathered headers (int64 [world, 2]: each rank's count and
    flags), the same on every rank: raise when a rank flagged an
    overflow of its table or list; else the rows the exchange needs,
    ``rows`` when every list fit, or the next power of two at or above
    the longest (the fallback: every rank exchanges again with it)."""
    heads = torch.as_tensor(heads)
    if bool((heads[:, 1] != 0).any()):
        raise RuntimeError("S1: a rank's pair table, delta table or list "
                           "overflowed, so the counts are no longer exact")
    longest = int(heads[:, 0].max())
    return rows if longest <= rows else 1 << (longest - 1).bit_length()


def live_rows(recv: torch.Tensor) -> torch.Tensor:
    """The live rows of gathered lists (:func:`exchange_rows`), in rank
    order, headers and pads dropped: what launch A of S1 adds."""
    return torch.cat([lst[1:1 + int(lst[0, 0])] for lst in recv])


def exchange_deltas(send: torch.Tensor, rows: int,
                    group) -> tuple[torch.Tensor, int]:
    """The plain version of one merge's exchange in S1's chain above
    world 1 (PyTorch ops, any device): the compact lists gathered at
    ``rows`` rows (:func:`exchange_rows`), the headers read
    (:func:`next_rows`: an overflow flag raises on every rank), and when
    a list was longer, the same exchange again with the rows grown.
    Returns (every rank's live rows, the rows from now on)."""
    recv = exchange_rows(send, rows, group)
    grown = next_rows(recv[:, 0], rows)
    if grown != rows:
        recv = exchange_rows(send, grown, group)
    return live_rows(recv), grown


def gather_pairs(keys: torch.Tensor, counts: torch.Tensor,
                 group) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (int64 pair key >= 0, count) list over ``group``, in
    rank order (:func:`gather_padded`), pads dropped.  The counts come
    back int64."""
    both = gather_padded(torch.stack([keys, counts.long()], 1), len(keys),
                         group)
    live = both[:, 0] >= 0
    return both[live, 0], both[live, 1]


def initial_deltas(state: bpe_ops.CorpusState, unk_id: int,
                   group) -> tuple[int, torch.Tensor]:
    """S1's start over several ranks: (the whole stream's length, the
    whole corpus's pair counts as (key, count) int64 rows, ascending by
    key), from each rank's own span: its pair counts, gathered
    (:func:`gather_pairs`) and summed by key."""
    n = torch.tensor([len(state.tokens)], dtype=torch.int64,
                     device=state.tokens.device)
    dist.all_reduce(n, group=group)
    keys, counts = bpe_ops.sum_by_key(*gather_pairs(
        *bpe_ops.pair_counts(state, unk_id), group))
    return int(n), torch.stack([keys, counts], 1)


def global_best_pair(state: bpe_ops.CorpusState, unk_id: int,
                     min_pair_freq: int, group) -> tuple[int, int, int]:
    """(a, b, count) of the whole corpus's best pair from every rank's
    span, the same on every rank: ``bpe_ops.best_pair`` of the union."""
    keys, counts = bpe_ops.pair_counts(state, unk_id)
    if group.size() > 1:
        keys, counts = bpe_ops.sum_by_key(*gather_pairs(keys, counts,
                                                        group))
    return bpe_ops.best_of(keys, counts, min_pair_freq)


def sharded_train(tokens: np.ndarray, word_id: np.ndarray,
                  wcount: np.ndarray, *, mesh, target_merges: int,
                  unk_id: int = -1, min_pair_freq: int = 2,
                  max_steps_per_call: int = 256, n_prev_merges: int = 0,
                  device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Sharded flat training, called by every rank of ``mesh`` (a 1-D
    DeviceMesh or a ProcessGroup) with the same corpus; wcount is per
    position, as the flat engine takes it.  Returns (merges [M, 2], freqs
    [M]), the same on every rank.

    Each call of ``_kernels.flat_sharded_train`` makes up to
    ``max_steps_per_call`` merges (S1 on a CUDA device, its plain version
    on the CPU).  Checkpoint resume: the caller replays the first
    ``n_prev_merges`` merges into ``tokens``; new ids continue at 256 +
    n_prev.  Only new merges are returned.  Runs on ``device``, the card
    by default."""
    device = resolve_device(device)
    group = _mesh.process_group(mesh)
    sc = shard_corpus(tokens, word_id, wcount, group.size())
    ts = bpe_ops.train_init(local_state(sc, group.rank(), device),
                            target_merges, n_prev_merges)
    while True:
        n_before = ts.n_merges
        ts = _kernels.flat_sharded_train(
            ts, unk_id, min_pair_freq, target_merges=target_merges,
            max_steps=max_steps_per_call, group=group)
        if ts.done or ts.n_merges >= target_merges \
                or ts.n_merges == n_before:
            break
    return (ts.merges[n_prev_merges:ts.n_merges],
            ts.merge_freqs[n_prev_merges:ts.n_merges])
