"""Sharded flat-stream training over a torch.distributed group (port of
``shredword_tpu/parallel/train.py``): the engine with no vocab bound, and
the sharded route for words longer than the table engines' layout.

The flat stream (``ops/bpe_ops.py``) is cut at word boundaries into one
span per rank (:func:`shard_corpus`).  Every merge, on every rank:

  1. LOCAL   the distinct pairs of this rank's span and their counts
             (``bpe_ops.pair_counts``: int64 keys (a << 32) | b, so one
             key orders (a, b) at any vocab -- the JAX package packs
             int32 keys below PACK_LIMIT and sorts two keys above it)
  2. GATHER  one ``all_reduce(MAX)`` of their number, then one
             ``all_gather`` of the lists padded to it
  3. REDUCE  the same sum by key and argmax on every rank (the first
             maximum in (a, b) order), so the pick needs no broadcast
  4. APPLY   ``bpe_ops.apply_merge`` on the own span (no halo: words never
             span ranks)

Counts are integers, so the result is the single-device flat engine's
whatever the ranks.  It is PyTorch ops over collectives, with no kernel
of its own, as the JAX package's is XLA.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..ops import bpe_ops
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


def gather_pairs(keys: torch.Tensor, counts: torch.Tensor,
                 group) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's (int64 pair key >= 0, count) list over ``group``, in
    rank order: one ``all_reduce(MAX)`` of their lengths, one
    ``all_gather`` of the lists padded to it with key -1, pads dropped.
    The counts come back int64."""
    n = torch.tensor([len(keys)], dtype=torch.int64, device=keys.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group)
    pad = int(n) - len(keys)
    both = torch.stack([torch.cat([keys, keys.new_full((pad,), -1)]),
                        torch.cat([counts.long(), keys.new_zeros(pad)])])
    out = [torch.empty_like(both) for _ in range(group.size())]
    dist.all_gather(out, both, group=group)
    both = torch.cat(out, 1)
    live = both[0] >= 0
    return both[0][live], both[1][live]


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
                  n_prev_merges: int = 0,
                  device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Sharded flat training, called by every rank of ``mesh`` (a 1-D
    DeviceMesh or a ProcessGroup) with the same corpus; wcount is per
    position, as the flat engine takes it.  Returns (merges [M, 2], freqs
    [M]), the same on every rank.

    Checkpoint resume: the caller replays the first ``n_prev_merges``
    merges into ``tokens``; new ids continue at 256 + n_prev.  Only new
    merges are returned.  Runs on ``device``, the card by default."""
    device = resolve_device(device)
    group = _mesh.process_group(mesh)
    sc = shard_corpus(tokens, word_id, wcount, group.size())
    ts = bpe_ops.train_init(local_state(sc, group.rank(), device),
                            target_merges, n_prev_merges)
    ts = bpe_ops.train_loop(ts, unk_id, min_pair_freq,
                            target_merges=target_merges,
                            max_steps=target_merges,
                            pick=partial(global_best_pair, group=group))
    return (ts.merges[n_prev_merges:ts.n_merges],
            ts.merge_freqs[n_prev_merges:ts.n_merges])
