"""Sharded Unigram EM over a torch.distributed group (port of
``shredword_tpu/parallel/unigram.py``).

Layout: every slab's words are cut into one contiguous block per rank;
words never span ranks, so each rank's forward-backward is exactly the
single-device computation on its words.  Each rank builds and holds only
its block's [L, K, W] piece table, on its own device.  Per slab per EM
round:

  1. LOCAL  : ``unigram_ops.fb_core`` on this rank's block (the kernel
              U1 on a card) -> float64 expected counts and log-likelihood
  2. REDUCE : one ``all_reduce(SUM)`` of counts ‖ ll, float64
              [n_pieces + 1] (the JAX package's two ``psum``s)
  3. M-step : on the host, identical on every rank

Prune remaps stay local (the same gather as on one device, no
collective).  Float64 sums in another order than on one device may
differ in the last bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import unigram_ops
from ..runtime import native
from . import multihost


def make_sharded_table(group, words: list[bytes], idx: np.ndarray,
                       pieces: list[bytes], L: int, K: int,
                       wlen: np.ndarray, wcount: np.ndarray,
                       device) -> unigram_ops.DeviceTable:
    """This rank's block of the slab ``words[idx]``: its piece table
    (built on the host for its own words only) on ``device``."""
    part = idx[multihost.host_shard(len(idx), group)]
    table = native.piece_table([words[i] for i in part], pieces, L, K)
    return unigram_ops.make_device_table(table, wlen[part], wcount[part],
                                         device)


def sharded_forward_backward(dt: unigram_ops.DeviceTable,
                             logp: np.ndarray, n_pieces: int, *,
                             group) -> tuple[np.ndarray, float]:
    """Expected counts (float64 [n_pieces]) and log-likelihood of a slab
    whose words are sharded over ``group``: the local forward-backward,
    then one all_reduce on the table's device."""
    lp = torch.from_numpy(np.asarray(logp[:n_pieces], np.float32)).to(
        dt.ids.device)
    counts, ll = unigram_ops.fb_core(dt.ids, lp, dt.wlen, dt.wcount)
    buf = torch.cat([counts, ll[None]])
    dist.all_reduce(buf, group=group)
    out = buf.cpu().numpy()
    return out[:n_pieces], float(out[n_pieces])
