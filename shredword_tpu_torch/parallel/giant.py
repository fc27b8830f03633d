"""Row-sharded giant-vocab training over a torch.distributed group (port
of ``shredword_tpu/parallel/giant.py``): vocab up to 65536.

Both axes of the problem are cut over the ranks:

  corpus  [L, W] int32 by-word layout (``parallel/hist.shard_layout``),
          one column block per rank (words never span ranks); each rank
          lays its block out as the giant engine lays out a corpus
          (:func:`rank_layout`: words sorted by length into chunks, an
          exact presence index int8 [v, NC]); int32 because merged ids
          pass 32767
  table   [v, v] int32 cut by ROWS: rank r owns global rows
          [r v/n, (r + 1) v/n) as one tensor [v/n, v] (17.2 GB at v 65536
          on one rank, 2.1 GB a rank over eight), with int32 [v/n] upper
          bounds of those rows' maxima

Every merge, on every rank (SPMD), in ``_kernels.giant_sharded_train``
(G1, ``csrc/giant_sharded.cu`` on the card):

  1. PICK          the lex-first local pick through the row bounds as one
                   int64 key (freq, 65535 - a, 65535 - b)
  2. PICK REDUCE   one ``all_reduce(MAX)`` of the key: the JAX package's
                   pmax/pmin/pmin in one collective, with the same
                   (freq desc, row asc, col asc) tie-break
  3. LOCAL         the merge over this rank's chunks that hold both ids
                   -> dl ‖ dr
  4. REDUCE        one ``all_reduce(SUM)`` of dl ‖ dr, int32 [2v]
  5. APPLY         the reduced deltas on the own rows
                   (``apply_hist_updates`` order) and their bounds

A rank alone (world 1) passes no reduce, and a call of G1 is then one
persistent launch; over more ranks it is two launches and the two
collectives per merge.  Nothing waits for the device inside a call; the
records are read once per call.

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
from ..ops import _kernels, bpe_giant, bpe_hist
from ..ops._kernels import PAD
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


def rank_layout(own: bpe_hist.HistCorpus, v: int,
                cw: int = bpe_giant.C) -> bpe_giant.GiantLayout:
    """A rank's column block (``parallel.hist.local_shard``, int32 [L, Ws])
    as the giant engine lays out a corpus: its columns sorted by word
    length (stable, the empty pad columns last) into NC = ceil(Ws / cw)
    chunks of cw columns, each chunk's longest word, and the exact
    presence int8 [v, NC] of each id in each chunk.  ``perm[j]`` is the
    block column of layout column j < Ws, so ``tw[:, :Ws] ==
    block[:, perm]``; ``n_words`` counts the block's words (columns that
    hold a token).  Words never leave the rank."""
    L, ws = own.tw.shape
    lens = (own.tw >= 0).sum(0)
    perm = np.argsort(np.where(lens > 0, lens, L + 1), kind="stable")
    nc = max(1, -(-ws // cw))
    tw = np.full((L, nc * cw), PAD, np.int32)
    tw[:, :ws] = own.tw[:, perm]
    wc = np.zeros((1, nc * cw), np.int32)
    wc[0, :ws] = own.wcount.reshape(-1)[perm]
    col_lens = np.zeros(nc * cw, np.int32)
    col_lens[:ws] = lens[perm]
    presT = np.zeros((v, nc), np.int8)
    rows, cols = np.nonzero(tw >= 0)
    presT[tw[rows, cols], cols // cw] = 1
    return bpe_giant.GiantLayout(tw, wc, col_lens.reshape(nc, cw).max(1),
                                 presT, perm, int((lens > 0).sum()))


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
    lay = rank_layout(par_hist.local_shard(c, rank, n_shards), v)
    tw = torch.from_numpy(lay.tw).to(device)           # trained in place
    wc = torch.from_numpy(lay.wc.reshape(-1)).to(device)
    presT = torch.from_numpy(lay.presT).to(device)
    nc_used = max(1, -(-lay.n_words // bpe_giant.C))
    rows = v // n_shards
    base = rank * rows
    hist, bounds = init_row_shard(tw, wc, unk_id, v, base, rows, group)
    reduces = {}
    if n_shards > 1:
        reduces = dict(
            reduce_key=lambda key: dist.all_reduce(
                key, op=dist.ReduceOp.MAX, group=group),
            reduce_deltas=lambda d: dist.all_reduce(d, group=group))

    def call(n_done, init_done, allowed, steps):
        return _kernels.giant_sharded_train(
            tw, wc, hist, bounds, presT, base=base, **reduces, unk=unk_id,
            min_freq=min_pair_freq, n_done=n_done, init_done=init_done,
            allowed=allowed, nc_used=nc_used, steps=steps)

    merges, freqs, _ = bpe_hist.drive_calls(
        call, target_merges=target_merges, n_prev=n_prev_merges,
        steps_per_call=max_steps_per_call)
    return merges, freqs
