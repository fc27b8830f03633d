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
    merge every rank's net deltas are gathered (:func:`gather_padded`)
    and added by every rank (``csrc/flat_sharded.cu``);
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
