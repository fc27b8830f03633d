"""Sharded histogram-engine training over a torch.distributed group
(port of ``shredword_tpu/parallel/hist.py``).

Layout: the by-word matrix [L, W] is cut along the word axis into one
column block per rank (words never span ranks: no halo exchange); each
rank holds its block on its own device and a replica of the pair table.
Every merge, on every rank (SPMD), in ``_kernels.hist_sharded_train``
(K4's chain, one kernel launch per merge on the card):

  1. PICK   : argmax over the replicated table, identical on every rank,
              so the chosen pair needs no broadcast
  2. LOCAL  : the corpus pass on this rank's block -> dl ‖ dr int32 [2v]
  3. REDUCE : one ``all_reduce(SUM)`` of that buffer (the JAX package's
              two ``psum``s); integer sums are bit-identical whatever
              the rank order
  4. APPLY  : the table update on the replicated table

Nothing waits for the device inside a call: only 2v int32 cross the
interconnect per merge, and the records are read once per call.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch.distributed as dist

from ..config import resolve_device
from ..ops import _kernels, bpe_hist
from . import mesh as _mesh


def shard_layout(tokens: np.ndarray, word_id: np.ndarray,
                 wcount: np.ndarray, n_shards: int,
                 max_word_len: int = 64,
                 dtype=np.int16) -> bpe_hist.HistCorpus | None:
    """The [L, W] host layout with W a multiple of n_shards * CHUNK (pad
    columns carry weight 0), equal to the JAX package's; rank r owns
    column block r (:func:`local_shard`).  None if a word exceeds
    max_word_len.  ``dtype`` int32 holds ids past 32767 (the sharded
    giant engine's)."""
    c = bpe_hist.build_layout(tokens, word_id, wcount, max_word_len,
                              min_len=16, dtype=dtype)
    if c is None:
        return None
    L, W = c.tw.shape
    unit = n_shards * bpe_hist.CHUNK
    W2 = -(-W // unit) * unit
    if W2 != W:
        tw = np.full((L, W2), bpe_hist.PAD, dtype)
        tw[:, :W] = c.tw
        wc = np.zeros((1, W2), np.int32)
        wc[:, :W] = c.wcount
        c = bpe_hist.HistCorpus(tw, wc)
    return c


def local_shard(c: bpe_hist.HistCorpus, rank: int,
                n_shards: int) -> bpe_hist.HistCorpus:
    """Column block ``rank`` of a :func:`shard_layout` layout, as the
    JAX package's ``P(None, "data")`` sharding places it."""
    ws = c.tw.shape[1] // n_shards
    cols = slice(rank * ws, (rank + 1) * ws)
    return bpe_hist.HistCorpus(np.ascontiguousarray(c.tw[:, cols]),
                               np.ascontiguousarray(c.wcount[:, cols]))


def shard_state_from_jax(tw, wcount, hist, rank: int, n_shards: int,
                         device="cuda"):
    """Rank ``rank``'s per-shard state (tw int16 [L, W / n], wcount
    int32 [W / n], hist int32 [v, v]) from the JAX sharded engine's
    global arrays."""
    c = local_shard(bpe_hist.HistCorpus(np.asarray(tw), np.asarray(wcount)
                                        .reshape(1, -1)), rank, n_shards)
    return bpe_hist.state_from_jax(c.tw, c.wcount, hist, device=device)


def shard_state_to_jax(shards, hist):
    """Inverse of :func:`shard_state_from_jax`: the ranks' (tw, wcount)
    blocks, in rank order, and the table as the JAX engine's global
    numpy arrays (tw [L, W], wcount [1, W], hist [v, v])."""
    tw = np.concatenate([t.cpu().numpy() for t, _ in shards], axis=1)
    wc = np.concatenate([w.cpu().numpy() for _, w in shards]).reshape(1, -1)
    return tw, wc, hist.cpu().numpy()


def build_sharded_hist_loop(group, ts: bpe_hist.HistTrainState, *,
                            unk_id: int, min_pair_freq: int) -> Callable:
    """This rank's per-merge loop in :func:`bpe_hist.drive_calls`'
    interface, ``call(n_done, init_done, allowed, steps) -> records``,
    training ts.corpus (this rank's block [L, W / n]) and ts.hist (the
    replicated table) in place."""
    (tw, wc), hist = ts.corpus, ts.hist

    def reduce(d):
        dist.all_reduce(d, group=group)

    def call(n_done, init_done, allowed, steps):
        return _kernels.hist_sharded_train(
            tw, wc, hist, reduce=reduce, unk=unk_id, min_freq=min_pair_freq,
            n_done=n_done, init_done=init_done, allowed=allowed, steps=steps)

    return call


def sharded_hist_train(tokens: np.ndarray, word_id: np.ndarray,
                       wcount: np.ndarray, *, mesh, target_merges: int,
                       unk_id: int = -1, min_pair_freq: int = 2,
                       max_steps_per_call: int = 512,
                       n_prev_merges: int = 0, device="cuda"):
    """Sharded driver, called by every rank of ``mesh`` (a 1-D
    DeviceMesh or a ProcessGroup) with the same corpus.  wcount is per
    word.  Returns (merges, freqs), the same on every rank, or None if
    v > 4096 or a word exceeds the layout (the sharded giant and flat
    engines take those in the JAX package).

    Checkpoint resume: the caller replays the first ``n_prev_merges``
    merges into ``tokens``; new ids continue at 256 + n_prev.  Only new
    merges are returned.  Runs on ``device``, the card by default."""
    device = resolve_device(device)
    v = -(-(256 + target_merges) // 128) * 128
    if v > bpe_hist.MAX_V:
        return None
    group = _mesh.process_group(mesh)
    n_shards = group.size()
    c = shard_layout(tokens, word_id, wcount, n_shards)
    if c is None:
        return None
    ts = bpe_hist.hist_train_init(local_shard(c, group.rank(), n_shards),
                                  unk_id, target_merges, v, device=device)
    dist.all_reduce(ts.hist, group=group)      # the whole corpus's table
    loop = build_sharded_hist_loop(group, ts, unk_id=unk_id,
                                   min_pair_freq=min_pair_freq)
    merges, freqs, _ = bpe_hist.drive_calls(
        loop, target_merges=target_merges, n_prev=n_prev_merges,
        steps_per_call=max_steps_per_call)
    return merges, freqs
