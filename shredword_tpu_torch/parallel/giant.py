"""Row-sharded giant-vocab training over a torch.distributed group (port
of ``shredword_tpu/parallel/giant.py``): vocab up to 65536.

Both axes of the problem are cut over the ranks:

  corpus  [L, W] int32 by-word layout (``parallel/hist.shard_layout``),
          one column block per rank (words never span ranks); int32
          because merged ids pass 32767
  table   [v, v] int32 cut by ROWS: rank r owns global rows
          [r v/n, (r + 1) v/n) as one tensor [v/n, v] (17.2 GB at v 65536
          on one rank, 2.1 GB a rank over eight), with int32 [v/n] upper
          bounds of those rows' maxima

Every merge, on every rank (SPMD), in ``_kernels.giant_sharded_train``
(G1, ``csrc/giant_sharded.cu`` on the card):

  1. APPLY + PICK  one launch: the previous merge's reduced deltas on the
                   own rows (``apply_hist_updates`` order), then the
                   lex-first local pick through the row bounds as one int64
                   key (freq, 65535 - a, 65535 - b)
  2. PICK REDUCE   one ``all_reduce(MAX)`` of the key: the JAX package's
                   pmax/pmin/pmin in one collective, with the same
                   (freq desc, row asc, col asc) tie-break
  3. LOCAL         one launch: the merge over this rank's columns -> dl ‖ dr
  4. REDUCE        one ``all_reduce(SUM)`` of dl ‖ dr, int32 [2v]

Nothing waits for the device inside a call; the records are read once
per call.

The initial table is built sharded (the JAX package builds a replicated
[vi, vi] table on one device on resume, up to ~17 GB near vocab 64k):
each rank counts the distinct pairs of its own columns, the ranks
``all_gather`` those (pair, count) lists, padded to one length, and each
rank adds only the pairs whose left id falls in its rows.  No rank holds
more than its own rows and O(corpus) scratch, on a fresh run or on a
resume.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..ops import _kernels, bpe_hist
from . import hist as par_hist
from . import mesh as _mesh
from . import train as par_train

MAX_V = 65536      # pick keys hold 16-bit ids


def _distinct_pairs(tw: torch.Tensor, wc: torch.Tensor, unk_id: int,
                    v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's distinct pairs a * v + b (int64, ascending) and their
    int32 counts (``bpe_hist.pair_keys``, summed by key)."""
    keys, w = bpe_hist.pair_keys(tw, wc, unk_id, v)
    keys, inv = torch.unique(keys, return_inverse=True)
    counts = torch.zeros(len(keys), dtype=torch.int32, device=tw.device)
    counts.index_add_(0, inv, w)
    return keys, counts


def init_row_shard(tw: torch.Tensor, wc: torch.Tensor, unk_id: int, v: int,
                   base: int, rows: int, group=None):
    """Rows [base, base + rows) of the exact initial pair table of the
    whole corpus, int32 [rows, v], and their maxima int32 [rows], from
    this rank's columns (tw [L, W], wc [W]) and, over ``group``, every
    other rank's."""
    keys, counts = _distinct_pairs(tw, wc, unk_id, v)
    if group is not None and group.size() > 1:
        keys, counts = par_train.gather_pairs(keys, counts, group)
        counts = counts.int()
    own = (keys >= base * v) & (keys < (base + rows) * v)
    hist = torch.zeros((rows, v), dtype=torch.int32, device=tw.device)
    hist.view(-1).index_add_(0, keys[own] - base * v, counts[own])
    return hist, hist.amax(1)


def sharded_giant_train(tokens: np.ndarray, word_id: np.ndarray,
                        wcount: np.ndarray, *, mesh, target_merges: int,
                        unk_id: int = -1, min_pair_freq: int = 2,
                        max_steps_per_call: int = 256,
                        n_prev_merges: int = 0, device="cuda"):
    """Sharded training for vocab beyond one table of the hist engine
    (v <= 65536), called by every rank of ``mesh`` (a 1-D DeviceMesh or a
    ProcessGroup) with the same corpus.  wcount is per word.  Returns
    (merges, freqs), the same on every rank, or None if v (256 +
    target_merges rounded up to a multiple of 128 * ranks) exceeds MAX_V,
    unk_id >= 256 or a word exceeds the layout (64 tokens).

    Checkpoint resume: the caller replays the first ``n_prev_merges``
    merges into ``tokens``; new ids continue at 256 + n_prev, and the
    initial table holds the replayed ids' pairs.  Only new merges are
    returned.  Runs on ``device``, the card by default."""
    device = resolve_device(device)
    group = _mesh.process_group(mesh)
    n_shards, rank = group.size(), group.rank()
    unit = 128 * n_shards
    v = -(-(256 + target_merges) // unit) * unit      # whole row shards
    if v > MAX_V or unk_id >= 256:
        return None
    c = par_hist.shard_layout(tokens, word_id, wcount, n_shards,
                              dtype=np.int32)
    if c is None:
        return None
    own = par_hist.local_shard(c, rank, n_shards)
    tw = torch.from_numpy(own.tw).to(device)           # trained in place
    wc = torch.from_numpy(own.wcount.reshape(-1)).to(device)
    rows = v // n_shards
    base = rank * rows
    hist, bounds = init_row_shard(tw, wc, unk_id, v, base, rows, group)

    def reduce_key(key):
        dist.all_reduce(key, op=dist.ReduceOp.MAX, group=group)

    def reduce_deltas(d):
        dist.all_reduce(d, group=group)

    def call(n_done, init_done, allowed, steps):
        return _kernels.giant_sharded_train(
            tw, wc, hist, bounds, base=base, reduce_key=reduce_key,
            reduce_deltas=reduce_deltas, unk=unk_id, min_freq=min_pair_freq,
            n_done=n_done, init_done=init_done, allowed=allowed, steps=steps)

    merges, freqs, _ = bpe_hist.drive_calls(
        call, target_merges=target_merges, n_prev=n_prev_merges,
        steps_per_call=max_steps_per_call)
    return merges, freqs
